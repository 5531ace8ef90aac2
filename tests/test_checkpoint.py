"""The .hash checkpoint must carry the FULL analysis state (count table,
retained band, incidence, clusters, split) so --readHash -> --clusterReport
works with no reads on disk (SURVEY.md §3.1 #11, §4.2 resume workflow), and
load() must REPLACE state, not sum onto it."""

import io as _io

import numpy as np

from hash10x_jax.cli.main import main as cli_main
from hash10x_jax.engine import Engine, EngineConfig
from hash10x_jax.hashspec import HashSpec
from hash10x_jax.io import fqb as FB
from hash10x_jax.io.sim import SimConfig, simulate


def _sim_fqb(**kw):
    sim = simulate(SimConfig(**kw))
    return FB.from_read_batch(sim.reads)


def _run_full(eng, fqb):
    eng.count(fqb)
    eng.filter()
    eng.incidence(fqb)
    eng.cluster()
    eng.split()


def test_checkpoint_full_roundtrip(tmp_path):
    fqb = _sim_fqb(genome_len=40_000, n_barcodes=4, molecules_per_barcode=2, reads_per_molecule=60, seed=3)
    cfg = EngineConfig(spec=HashSpec(k=13, w=7), batch_reads=1024,
                       min_count=2, max_count=200)
    eng = Engine(cfg, log=None)
    _run_full(eng, fqb)
    p = tmp_path / "full.hash.npz"
    eng.save(p)

    eng2 = Engine(cfg, log=None)
    eng2.load(p)
    assert eng2.n_reads_counted == eng.n_reads_counted
    assert (eng2.retained_hashes == eng.retained_hashes).all()
    assert (eng2.retained_counts == eng.retained_counts).all()
    assert eng2.inc.n_pairs == eng.inc.n_pairs
    assert (eng2.inc.code_kmers == eng.inc.code_kmers).all()
    assert (eng2.inc.kmer_codes == eng.inc.kmer_codes).all()
    for a, b in zip(eng2.clusters, eng.clusters):
        assert a.tolist() == b.tolist()
    assert (eng2.split_origin == eng.split_origin).all()
    assert (eng2.split_inc.code_kmers == eng.split_inc.code_kmers).all()

    # report from the restored engine, with NO reads, equals the original
    r1, r2 = _io.StringIO(), _io.StringIO()
    eng.report(r1)
    eng2.report(r2)
    assert r1.getvalue() == r2.getvalue()


def test_load_replaces_not_merges(tmp_path):
    fqb = _sim_fqb(genome_len=30_000, n_barcodes=3, molecules_per_barcode=2, reads_per_molecule=40, seed=5)
    cfg = EngineConfig(spec=HashSpec(k=13, w=7), batch_reads=1024)
    eng = Engine(cfg, log=None)
    eng.count(fqb)
    p = tmp_path / "c.hash.npz"
    eng.save(p)

    # count the same reads again, then load: counts must equal the checkpoint
    # (a merging load would double them)
    eng.count(fqb)
    eng.load(p)
    import hash10x_jax.table.sorted_table as st
    h, c = st.compact(eng._flushed())
    eng3 = Engine(cfg, log=None)
    eng3.load(p)
    h3, c3 = st.compact(eng3._flushed())
    assert (h == h3).all() and (c == c3).all()


def test_cli_readhash_clusterreport_without_reads(tmp_path):
    fqb = _sim_fqb(genome_len=40_000, n_barcodes=4, molecules_per_barcode=2, reads_per_molecule=60, seed=7)
    fqb_path = tmp_path / "lane.fqb.npz"
    FB.save_fqb(fqb_path, fqb)
    hashp = str(tmp_path / "lane.hash")
    out1, err = _io.StringIO(), _io.StringIO()
    cli_main(["-k", "13", "-w", "7", "--readFQB", str(fqb_path),
              "--codeClusters", "--clusterSplit", "--writeHash", hashp,
              "--clusterReport"], out=out1, err=err)
    # resume in a fresh process-equivalent with no fqb anywhere
    out2 = _io.StringIO()
    cli_main(["-k", "13", "-w", "7", "--readHash", hashp,
              "--codeClusters", "--clusterReport"], out=out2, err=err)
    assert out1.getvalue().splitlines()[-fqb.n_barcodes:] == \
        out2.getvalue().splitlines()[-fqb.n_barcodes:]
