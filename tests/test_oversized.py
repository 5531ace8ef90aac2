"""Oversized barcodes (more reads than --batchReads) must count exactly in the
single-device path (round-1 raised; real lanes contain pathological barcodes,
e.g. homopolymer artifacts), and the vectorized split/report must equal the
per-code oracle formulation."""

import io as _io

import numpy as np

import hash10x_jax.table.sorted_table as st
from hash10x_jax.engine import Engine, EngineConfig
from hash10x_jax.hashspec import HashSpec
from hash10x_jax.io import fqb as FB
from hash10x_jax.io.fastq import ReadBatch


def _lane(rng, n_big=600, n_small=40, read_len=60):
    """One pathological barcode with n_big reads + a few normal barcodes."""
    n = n_big + 3 * n_small
    codes = rng.integers(0, 4, size=(n, read_len)).astype(np.uint8)
    # duplicate reads inside the big barcode so (hash, barcode) dedup matters
    codes[1:n_big // 2] = codes[0]
    lengths = np.full(n, read_len, np.int32)
    barcodes = np.concatenate([
        np.zeros(n_big, np.uint32),
        1 + (np.arange(3 * n_small, dtype=np.uint32) % 3)])
    return FB.from_read_batch(
        ReadBatch(codes=codes, lengths=lengths, barcodes=barcodes))


def _counts(engine):
    h, c = st.compact(engine._flushed())
    return dict(zip(h.tolist(), c.tolist()))


def test_oversized_barcode_counts_exact(rng):
    fqb = _lane(rng)
    spec = HashSpec(k=13, w=5)
    small = Engine(EngineConfig(spec=spec, batch_reads=128,
                                count_mode="barcodes"), log=None)
    small.count(fqb)
    big = Engine(EngineConfig(spec=spec, batch_reads=1024,
                              count_mode="barcodes"), log=None)
    big.count(fqb)
    assert _counts(small) == _counts(big)
    assert small.n_reads_counted == big.n_reads_counted == len(fqb)


def test_oversized_barcode_occurrences_mode(rng):
    fqb = _lane(rng, n_big=300, n_small=20)
    spec = HashSpec(k=13, w=5)
    small = Engine(EngineConfig(spec=spec, batch_reads=64,
                                count_mode="occurrences"), log=None)
    small.count(fqb)
    big = Engine(EngineConfig(spec=spec, batch_reads=2048,
                              count_mode="occurrences"), log=None)
    big.count(fqb)
    assert _counts(small) == _counts(big)


def test_oversized_full_pipeline_matches_large_batch(rng):
    """count + filter + incidence + cluster + split + report: identical output
    whether the big barcode spans batches or fits in one."""
    fqb = _lane(rng, n_big=200, n_small=30)
    spec = HashSpec(k=13, w=5)
    outs = []
    for bsz in (64, 2048):
        eng = Engine(EngineConfig(spec=spec, batch_reads=bsz,
                                  count_mode="barcodes", min_count=1,
                                  max_count=10 ** 6), log=None)
        eng.count(fqb)
        eng.filter()
        eng.incidence(fqb)
        eng.cluster()
        eng.split()
        buf = _io.StringIO()
        eng.report(buf)
        eng.write_clusters(buf)
        outs.append((buf.getvalue(), eng.split_origin.tolist(),
                     eng.split_inc.code_kmers.tolist()))
    assert outs[0] == outs[1]


def test_oversized_barcode_sharded_matches_single(rng):
    """A barcode with more reads than a batch must count exactly on the
    SHARDED path too: the group dedups through a side
    sharded table and merges shard-locally — bit-equal to single-device."""
    fqb = _lane(rng, n_big=300, n_small=20)
    spec = HashSpec(k=13, w=5)
    single = Engine(EngineConfig(spec=spec, batch_reads=64,
                                 count_mode="barcodes"), log=None)
    single.count(fqb)
    import jax
    n_dev = min(4, jax.device_count())
    sharded = Engine(EngineConfig(spec=spec, batch_reads=64,
                                  count_mode="barcodes", n_shards=n_dev),
                     log=None)
    sharded.count(fqb)
    assert _counts(single) == _counts(sharded)
    assert sharded.n_reads_counted == len(fqb)


def test_split_report_match_oracle_formulation(rng):
    """Vectorized split/report vs the straightforward per-code construction."""
    from hash10x_jax.oracle import cluster_ref as CO
    fqb = _lane(rng, n_big=100, n_small=25)
    spec = HashSpec(k=13, w=5)
    eng = Engine(EngineConfig(spec=spec, batch_reads=2048,
                              count_mode="barcodes", min_count=1,
                              max_count=10 ** 6), log=None)
    eng.count(fqb)
    eng.filter()
    eng.incidence(fqb)
    eng.cluster()
    eng.split()
    code_hashes = [eng.inc.kmers_of(c).tolist() for c in range(eng.inc.n_codes)]
    clusters = [c.tolist() for c in eng.clusters]
    expect_hashes, expect_origin = CO.split_codes(code_hashes, clusters)
    assert eng.split_origin.tolist() == [list(o) for o in expect_origin]
    got_hashes = [eng.split_inc.kmers_of(c).tolist()
                  for c in range(eng.split_inc.n_codes)]
    assert got_hashes == expect_hashes
