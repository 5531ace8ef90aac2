"""Device clustering must reproduce the union-find oracle labels exactly, and
recover simulated molecules (SURVEY.md §5 items 1/2, §8.3 determinism)."""

import io as _io

import numpy as np
import pytest

from hash10x_jax.hashspec import HashSpec
from hash10x_jax.cluster import cooccur
from hash10x_jax.engine import Engine, EngineConfig
from hash10x_jax.io import fqb as FB
from hash10x_jax.io.sim import SimConfig, simulate
from hash10x_jax.oracle import cluster_ref as CO
from hash10x_jax.table.incidence import build_incidence


def random_incidence(rng, n_kmers=60, n_codes=30, density=0.15):
    pairs = rng.random((n_kmers, n_codes)) < density
    k, c = np.nonzero(pairs)
    return build_incidence(k.astype(np.int32), c.astype(np.int32), n_kmers, n_codes)


def oracle_labels(inc, min_share):
    hash_codes = {k: inc.codes_of(k).tolist() for k in range(inc.n_kmers)}
    return [CO.cluster_barcode(inc.kmers_of(c).tolist(), hash_codes, min_share)
            for c in range(inc.n_codes)]


def oracle_labels_friend(inc, thr, max_friends=256):
    hash_codes = {k: inc.codes_of(k).tolist() for k in range(inc.n_kmers)}
    return [CO.cluster_barcode_friend(inc.kmers_of(c).tolist(), hash_codes, c,
                                      thr, max_friends)
            for c in range(inc.n_codes)]


@pytest.mark.parametrize("min_share,density", [(1, 0.1), (2, 0.2), (3, 0.3)])
def test_cluster_matches_oracle_random(rng, min_share, density):
    inc = random_incidence(rng, n_kmers=50, n_codes=24, density=density)
    got = cooccur.cluster_codes(inc, min_share=min_share, mode="pair")
    expect = oracle_labels(inc, min_share)
    for c in range(inc.n_codes):
        assert got[c].tolist() == expect[c], f"code {c}"


@pytest.mark.parametrize("thr,density,max_friends", [(1, 0.1, 256), (2, 0.2, 256), (3, 0.25, 4)])
def test_friend_cluster_matches_oracle_random(rng, thr, density, max_friends):
    inc = random_incidence(rng, n_kmers=50, n_codes=24, density=density)
    got = cooccur.cluster_codes(inc, mode="friend", min_friend_share=thr,
                                max_friends=max_friends)
    expect = oracle_labels_friend(inc, thr, max_friends)
    for c in range(inc.n_codes):
        assert got[c].tolist() == expect[c], f"code {c}"


def test_cluster_size_classes(rng):
    """Codes with wildly different k-mer set sizes exercise several size classes."""
    ks, cs = [], []
    n_codes = 12
    for c in range(n_codes):
        n = [1, 2, 3, 9, 17, 33, 65, 5, 8, 130, 12, 40][c]
        kset = rng.choice(300, size=n, replace=False)
        ks.extend(kset.tolist())
        cs.extend([c] * n)
    # add a few shared backbone kmers for cross-support
    for k in range(300, 320):
        for c in range(n_codes):
            if rng.random() < 0.5:
                ks.append(k)
                cs.append(c)
    inc = build_incidence(np.array(ks, np.int32), np.array(cs, np.int32), 320, n_codes)
    got = cooccur.cluster_codes(inc, min_share=2, mode="pair")
    expect = oracle_labels(inc, 2)
    for c in range(n_codes):
        assert got[c].tolist() == expect[c], f"code {c}"
    gotf = cooccur.cluster_codes(inc, mode="friend", min_friend_share=3)
    expectf = oracle_labels_friend(inc, 3)
    for c in range(n_codes):
        assert gotf[c].tolist() == expectf[c], f"friend code {c}"


def _sim_engine(seed=0, min_share=2, n_barcodes=160):
    # The co-occurrence method needs bridge-rarity: the chance another barcode
    # covers BOTH of this barcode's molecules is ~cov^2 / n_barcodes (SURVEY.md §1)
    # — here ~4^2/160 = 0.1, the realistic sparse-bridging regime.
    sim = simulate(SimConfig(genome_len=400_000, n_barcodes=n_barcodes,
                             molecules_per_barcode=2, molecule_len=5000,
                             reads_per_molecule=35, read_len=120, seed=seed))
    fqb = FB.from_read_batch(sim.reads)
    cfg = EngineConfig(spec=HashSpec(k=21, w=7, seed=17), table_bits=20,
                       batch_reads=2048, min_count=2, max_count=24,
                       min_share=min_share, min_friend_share=25)
    eng = Engine(cfg, log=None)
    eng.count(fqb)
    eng.filter()
    eng.incidence(fqb)
    eng.cluster()
    return sim, fqb, eng


@pytest.fixture(scope="module")
def sim_eng():
    """One shared sim+engine run for the three end-to-end assertions below
    (each run costs minutes of jit compiles on the CPU test mesh)."""
    return _sim_engine(seed=0)


def test_engine_end_to_end_recovers_molecules(sim_eng):
    """Two well-separated molecules per barcode must split into (mostly) two
    clusters whose k-mers map back to distinct genome regions."""
    sim, fqb, eng = sim_eng
    n_good = 0
    for c in range(eng.inc.n_codes):
        cl = eng.clusters[c]
        if len(cl) == 0:
            continue
        sizes = np.bincount(cl)
        big = (sizes >= 10).sum()
        if big == 2:
            n_good += 1
    # molecules may overlap by chance; most barcodes should split cleanly
    # single-link friend union merges a barcode's molecules when one bridging
    # barcode covers both loci (expected here); most still split cleanly
    n_codes = eng.inc.n_codes
    assert n_good >= int(0.6 * n_codes), \
        f"only {n_good}/{n_codes} barcodes split into 2 molecules"


def test_engine_cluster_labels_match_oracle(sim_eng):
    sim, fqb, eng = sim_eng
    expect = oracle_labels_friend(eng.inc, eng.cfg.min_friend_share,
                                  eng.cfg.max_friends)
    for c in range(eng.inc.n_codes):
        assert eng.clusters[c].tolist() == expect[c], f"code {c}"


def test_split_and_report(sim_eng):
    sim, fqb, eng = sim_eng
    eng.split()
    # every split code's kmers are exactly one cluster of its origin code
    for nc in range(min(20, eng.split_inc.n_codes)):
        c, lab = eng.split_origin[nc]
        ks = eng.split_inc.kmers_of(nc)
        orig = eng.inc.kmers_of(c)[eng.clusters[c] == lab]
        assert sorted(ks.tolist()) == sorted(orig.tolist())
    buf = _io.StringIO()
    eng.report(buf)
    lines = buf.getvalue().splitlines()
    assert len(lines) == eng.inc.n_codes
    assert lines[0].startswith("code 0 nKmers")


def test_engine_determinism_across_batch_sizes():
    """Same lane, different batch sizes -> identical retained set and labels."""
    sim = simulate(SimConfig(genome_len=30_000, n_barcodes=8, molecules_per_barcode=2,
                             molecule_len=4000, reads_per_molecule=30, read_len=100,
                             seed=5))
    fqb = FB.from_read_batch(sim.reads)
    outs = []
    for bsz in (128, 480):
        cfg = EngineConfig(spec=HashSpec(k=17, w=5, seed=17), table_bits=18,
                           batch_reads=bsz, min_count=2, max_count=24)
        eng = Engine(cfg, log=None)
        eng.count(fqb)
        eng.filter()
        eng.incidence(fqb)
        eng.cluster()
        outs.append(eng)
    a, b = outs
    assert (a.retained_hashes == b.retained_hashes).all()
    assert (a.retained_counts == b.retained_counts).all()
    for c in range(a.inc.n_codes):
        assert a.clusters[c].tolist() == b.clusters[c].tolist()


@pytest.mark.parametrize("thr,density", [(1, 0.12), (2, 0.2)])
def test_friend_uncapped_matches_oracle(rng, thr, density):
    inc = random_incidence(rng, n_kmers=50, n_codes=24, density=density)
    got = cooccur.cluster_codes(inc, mode="friend", min_friend_share=thr,
                                max_friends=0)
    expect = oracle_labels_friend(inc, thr, max_friends=0)
    for c in range(inc.n_codes):
        assert got[c].tolist() == expect[c], f"code {c}"


def test_oversized_barcode_sharded_counts_exact():
    """A barcode spanning batches must count EXACTLY on the sharded path
    (the round-2 fail-fast was replaced by a side sharded dedup table —
    see also tests/test_oversized.py::test_oversized_barcode_sharded_*)."""
    sim = simulate(SimConfig(genome_len=30000, n_barcodes=2,
                             molecules_per_barcode=1, molecule_len=5000,
                             reads_per_molecule=300, read_len=100, seed=3))
    fqb = FB.from_read_batch(sim.reads)
    single = Engine(EngineConfig(spec=HashSpec(k=17, w=5, seed=17),
                                 table_bits=18, batch_reads=256,
                                 count_mode="barcodes"), log=None)
    single.count(fqb)
    sharded = Engine(EngineConfig(spec=HashSpec(k=17, w=5, seed=17),
                                  table_bits=18, batch_reads=256,
                                  count_mode="barcodes", n_shards=2),
                     log=None)
    sharded.count(fqb)
    import hash10x_jax.table.sorted_table as _st
    hs, cs = _st.compact(single._flushed())
    hh, ch = _st.compact(sharded._flushed())
    assert hs.tolist() == hh.tolist() and cs.tolist() == ch.tolist()
