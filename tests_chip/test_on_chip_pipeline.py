"""On-card pipeline regression tests: CLI drives and cluster-scale probes
promoted to asserted cases, with exact correctness asserts.  Sizes keep the
whole file to a few minutes including compilation."""

import io

import numpy as np
import pytest

from hash10x_jax import HashSpec
from hash10x_jax.cli.main import main as cli_main
from hash10x_jax.core.encode import pack_2bit
from hash10x_jax.engine import Engine, EngineConfig
from hash10x_jax.io import fqb as FB
from hash10x_jax.io.fqb import Fqb
from hash10x_jax.io.sim import SimConfig, simulate
from hash10x_jax.oracle import cluster_ref as CO

pytestmark = pytest.mark.chip

SPEC = HashSpec(k=21, w=11, seed=17)


def _cli(args):
    out, err = io.StringIO(), io.StringIO()
    rc = cli_main(args, out=out, err=err)
    assert rc == 0, err.getvalue()[-500:]
    return out.getvalue()


def test_cli_plain_vs_sharded1_byte_equal(rng, tmp_path):
    """The r4 manual drive, asserted: the full CLI pipeline (count dist +
    clusters + split + report) through ``--shards 1`` is byte-identical to
    the plain path on the card."""
    sim = simulate(SimConfig(genome_len=50_000, n_barcodes=24,
                             molecules_per_barcode=2, molecule_len=5000,
                             reads_per_molecule=30, read_len=120, seed=9))
    fqb_path = str(tmp_path / "lane.fqb")
    FB.save_fqb(fqb_path, FB.from_read_batch(sim.reads))
    base = ["-k", "21", "-w", "7", "-B", "18", "--minCount", "2",
            "--maxCount", "40", "--friendShare", "10",
            "--readFQB", fqb_path + ".npz", "--hashDist",
            "--codeClusters", "--clusterSplit", "--clusterReport"]
    plain = _cli(base)
    sharded = _cli(["--shards", "1"] + base)
    assert len(plain) > 200
    assert plain == sharded


def test_engine_barcodes_split_report_on_chip(rng):
    """Barcodes-mode mini lane through count -> incidence -> cluster ->
    split -> report on the card; the report must agree with the per-code oracle
    clusters and the split origin table with the (code, label) key set."""
    genome = rng.integers(0, 4, size=150_000).astype(np.uint8)
    N, n_codes = 4096, 64
    mol = rng.integers(0, len(genome) - 12_000, size=n_codes)
    bc = np.repeat(np.arange(n_codes, dtype=np.int32), N // n_codes)
    starts = mol[bc] + rng.integers(0, 12_000 - 150, size=N)
    reads = np.stack([genome[s:s + 150] for s in starts])
    fqb = Fqb(packed=pack_2bit(reads), lengths=np.full(N, 150, np.int32),
              barcode_ids=bc, barcode_keys=np.arange(n_codes, dtype=np.uint32),
              read_len=150)
    eng = Engine(EngineConfig(spec=SPEC, table_bits=16, batch_reads=1024,
                              min_friend_share=4), log=None)
    eng.count(fqb)
    eng.filter()
    eng.incidence(fqb)
    eng.cluster()
    eng.split()
    rep = io.StringIO()
    eng.report(rep)
    lines = [l for l in rep.getvalue().splitlines() if l.startswith("code ")]
    assert len(lines) == n_codes
    # report sizes per code == oracle friend clustering of that code
    inc = eng.inc
    hash_codes = {k: inc.codes_of(k).tolist() for k in range(inc.n_kmers)}
    for c in range(0, n_codes, 9):
        want = CO.cluster_barcode_friend(inc.kmers_of(c).tolist(), hash_codes,
                                         c, 4, max_friends=0)
        sizes = np.bincount(want).tolist() if want else []
        got = lines[c].split("sizes ")[1]
        assert got == ",".join(map(str, sizes)), f"code {c}"
    # split origin == the distinct (code, label) pairs, (code, label) order
    flat = np.concatenate([eng.clusters[c] for c in range(n_codes)])
    code_of = np.repeat(np.arange(n_codes), np.diff(inc.code_offsets))
    want_origin = sorted(set(zip(code_of.tolist(), flat.tolist())))
    assert eng.split_origin.tolist() == [list(t) for t in want_origin]
    assert eng.split_inc.n_codes == len(want_origin)


def test_edge_stress_dense_pileup_bounded(rng):
    """A dense molecule pileup
    (every molecule overlaps many others) through the sparse cluster phase —
    deterministic labels, every code keeps all its k-mers."""
    from hash10x_jax.table.incidence import build_incidence
    from hash10x_jax.cluster import sparse as SP
    n_codes, n_kmers, per_code = 16_384, 131_072, 30
    spans = rng.integers(0, n_kmers - 64, size=(n_codes, 2))
    ks, cs = [], []
    for j in range(2):
        offs = rng.integers(0, 64, size=(n_codes, per_code // 2))
        ks.append((spans[:, j:j + 1] + offs).reshape(-1))
        cs.append(np.repeat(np.arange(n_codes), per_code // 2))
    inc = build_incidence(np.concatenate(ks).astype(np.int32),
                          np.concatenate(cs).astype(np.int32),
                          n_kmers=n_kmers, n_codes=n_codes)
    labels = SP.cluster_codes_sparse(inc, min_friend_share=4, flat=True)
    labels2 = SP.cluster_codes_sparse(inc, min_friend_share=4, flat=True)
    assert (labels == labels2).all()
    assert len(labels) == inc.n_pairs
    # labels are canonical per-code ranks: 0..n_cl-1 within each code
    offs = inc.code_offsets
    for c in range(0, n_codes, 4097):
        lab = labels[offs[c]:offs[c + 1]]
        assert lab.min(initial=0) == 0
        assert set(np.unique(lab)) == set(range(lab.max(initial=-1) + 1))


def test_cluster_scale_50k_bounded(rng):
    """Cluster phase at 50k codes: deterministic, the molecule count within
    its bounds and equal to the CPU's for this seed, and each sampled code's
    labels equal the per-code friend-clustering oracle.

    Each k-mer here is shared by ~2.7 codes on average, below
    ``min_friend_share=4``, so most k-mers stay apart: a code splits into
    ~16 molecules, not the 1-2 of its two spans.  The bound is therefore
    one molecule per code up to one per (code, k-mer) pair; 803,747 is the
    count the CPU backend gives for this lane."""
    from hash10x_jax.table.incidence import build_incidence
    from hash10x_jax.cluster import sparse as SP
    n_codes, n_kmers, per_code = 50_000, 500_000, 30
    spans = rng.integers(0, n_kmers - 64, size=(n_codes, 2))
    ks, cs = [], []
    for j in range(2):
        offs = rng.integers(0, 64, size=(n_codes, per_code // 2))
        ks.append((spans[:, j:j + 1] + offs).reshape(-1))
        cs.append(np.repeat(np.arange(n_codes), per_code // 2))
    inc = build_incidence(np.concatenate(ks).astype(np.int32),
                          np.concatenate(cs).astype(np.int32),
                          n_kmers=n_kmers, n_codes=n_codes)
    labels = SP.cluster_codes_sparse(inc, min_friend_share=4, flat=True)
    labels2 = SP.cluster_codes_sparse(inc, min_friend_share=4, flat=True)
    assert (labels == labels2).all()
    assert len(labels) == inc.n_pairs
    code_of = np.repeat(np.arange(n_codes, dtype=np.int64),
                        np.diff(inc.code_offsets))
    n_cl = len(np.unique(code_of * (int(labels.max()) + 1) + labels))
    assert n_codes <= n_cl <= inc.n_pairs
    assert n_cl == 803_747
    offs = inc.code_offsets
    for c in range(0, n_codes, 4999):
        kmers = inc.kmers_of(c).tolist()
        hash_codes = {k: inc.codes_of(k).tolist() for k in kmers}
        want = CO.cluster_barcode_friend(kmers, hash_codes, c, 4,
                                         max_friends=0)
        assert labels[offs[c]:offs[c + 1]].tolist() == want, f"code {c}"
