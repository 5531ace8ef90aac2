"""Engine count pass through the count passes' sketch with its emissions
packed into per-batch slots: counts must be bit-identical to the uncapped
pass (``emission_cap_factor=0`` keeps every sketch position and every batch
slot) in both count modes and every sketch mode, also for batches that hold
N bases and homopolymer reads (SURVEY.md §5 items 2-3 at the engine
surface)."""

import io

import numpy as np
import pytest

from hash10x_jax.hashspec import HashSpec
from hash10x_jax.engine import Engine, EngineConfig
from hash10x_jax.io.fqb import Fqb
from hash10x_jax.core.encode import nmask_from_codes, pack_2bit


def make_fqb(rng, n=1024, L=150, n_codes=16, poly_g=False):
    """Genome reads; ``poly_g`` salts N bases into the lane and makes three
    reads (of three barcodes) 150 bp of G, the no-signal read of two-colour
    sequencers."""
    genome = rng.integers(0, 4, size=60_000).astype(np.uint8)
    starts = rng.integers(0, len(genome) - L, size=n)
    reads = np.stack([genome[s:s + L] for s in starts])
    bcs = rng.integers(0, n_codes, size=n).astype(np.int32)
    nmask = None
    if poly_g:
        reads = np.where(rng.random(reads.shape) < 0.002, 4, reads
                         ).astype(np.uint8)
        for i, b in zip((5, n // 2, n - 7), (1, 2, 3)):
            reads[i], bcs[i] = 2, b
        nmask = nmask_from_codes(reads)
    return Fqb(packed=pack_2bit(reads), lengths=np.full(n, L, np.int32),
               barcode_ids=bcs,
               barcode_keys=np.arange(n_codes, dtype=np.uint32), read_len=L,
               nmask=nmask)


def counts_text(eng, fqb, count_mode):
    eng.count(fqb)
    buf = io.StringIO()
    eng.write_counts(buf)
    return buf.getvalue()


@pytest.mark.parametrize("count_mode", ["occurrences", "barcodes"])
def test_engine_kernel_compaction_matches_jnp(rng, count_mode):
    fqb = make_fqb(rng)
    spec = HashSpec(k=21, w=11, seed=17)
    outs = []
    for cap in (0, 4):
        cfg = EngineConfig(spec=spec, count_mode=count_mode, table_bits=16,
                           batch_reads=1024, emission_cap_factor=cap)
        eng = Engine(cfg, log=None)
        assert bool(eng._compact_rows(130)) == bool(cap)
        outs.append(counts_text(eng, fqb, count_mode))
    assert outs[0] == outs[1]
    assert outs[0].count("\n") > 100


def test_engine_compaction_overflow_raises(rng, monkeypatch):
    """A too-small compaction width must surface as an exact overflow error
    at lane end — never silent truncation."""
    fqb = make_fqb(rng)
    cfg = EngineConfig(spec=HashSpec(k=21, w=11, seed=17),
                       count_mode="occurrences", table_bits=16,
                       batch_reads=1024)
    eng = Engine(cfg, log=None)
    monkeypatch.setattr(Engine, "_compact_rows", lambda self, P: 8)
    with pytest.raises(RuntimeError, match="overflow"):
        eng.count(fqb)


def test_fresh_engine_flush_path(rng):
    """A fresh Engine (no reset()) must survive a lane large enough to fill
    the append buffer and flush — regression: _filled_bound was only set in
    reset(), so the first flush of a fresh engine raised AttributeError
    (small test lanes never flushed, which hid it; bench's 800k-read
    barcodes lane crashed)."""
    fqb = make_fqb(rng, n=2048)
    cfg = EngineConfig(spec=HashSpec(k=21, w=11, seed=17),
                       count_mode="occurrences", table_bits=10,
                       batch_reads=256, flush_batches=1)
    eng = Engine(cfg, log=None)
    a = counts_text(eng, fqb, "occurrences")
    eng2 = Engine(EngineConfig(spec=HashSpec(k=21, w=11, seed=17),
                               count_mode="occurrences", table_bits=16,
                               batch_reads=2048), log=None)
    b = counts_text(eng2, fqb, "occurrences")
    assert a == b


@pytest.mark.parametrize("n_mesh", [2, 8])
def test_engine_sharded_syncmer_matches_single(rng, n_mesh):
    """--syncmer with --shards (compacted syncmer emissions on the sharded
    step) == single-device counts."""
    import jax
    if len(jax.devices()) < n_mesh:
        pytest.skip("needs virtual devices")
    fqb = make_fqb(rng, n=512)
    outs = []
    for n in (1, n_mesh):
        cfg = EngineConfig(spec=HashSpec(k=21, w=11, seed=17), mode="syncmer",
                           syncmer_s=11, count_mode="occurrences",
                           table_bits=16, batch_reads=512, n_shards=n)
        eng = Engine(cfg, log=None)
        outs.append(counts_text(eng, fqb, "occurrences"))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("mode,kw", [("kmer", {}),
                                     ("modimizer", {"modulus": 7}),
                                     ("syncmer", {"syncmer_s": 11})])
def test_engine_kernel_modes_match_jnp(rng, mode, kw):
    """Every sketch mode (compacted where it applies) == the uncapped pass
    at the engine count surface."""
    fqb = make_fqb(rng, n=1024)
    spec = HashSpec(k=21, w=11, seed=17)
    outs = []
    for cap in (0, 4):
        cfg = EngineConfig(spec=spec, mode=mode, count_mode="occurrences",
                           table_bits=16, batch_reads=1024,
                           emission_cap_factor=cap, **kw)
        eng = Engine(cfg, log=None)
        outs.append(counts_text(eng, fqb, "occurrences"))
    assert outs[0] == outs[1]
    assert outs[0].count("\n") > 50


@pytest.mark.parametrize("mode,kw", [("minimizer", {}),
                                     ("modimizer", {"modulus": 7}),
                                     ("syncmer", {"syncmer_s": 11})])
@pytest.mark.parametrize("count_mode", ["occurrences", "barcodes"])
def test_engine_poly_g_batch_matches_uncapped(rng, count_mode, mode, kw):
    """Batches with N bases and a 150 bp poly-G read (one hash throughout:
    it emits at nearly every position, past the per-read mean slots) count
    exactly as the uncapped pass, and nothing raises."""
    fqb = make_fqb(rng, poly_g=True)
    assert fqb.nmask is not None
    spec = HashSpec(k=21, w=11, seed=17)
    outs = []
    for cap in (0, 4):
        cfg = EngineConfig(spec=spec, mode=mode, count_mode=count_mode,
                           table_bits=16, batch_reads=1024,
                           emission_cap_factor=cap, **kw)
        outs.append(counts_text(Engine(cfg, log=None), fqb, count_mode))
    assert outs[0] == outs[1]
    assert outs[0].count("\n") > 50


def _incidence(fqb, **kw):
    cfg = EngineConfig(spec=HashSpec(k=21, w=11, seed=17), table_bits=16,
                       batch_reads=1024, min_count=2, max_count=64, **kw)
    eng = Engine(cfg, log=None)
    eng.count(fqb)
    eng.filter()
    eng.incidence(fqb)
    inc = eng.inc
    return (eng.retained_hashes.tolist(),
            np.asarray(inc.code_offsets).tolist(),
            np.asarray(inc.code_kmers).tolist())


def test_engine_poly_g_incidence_matches_uncapped(rng):
    """The incidence pass (pair scan) over the same lane: the poly-G hash
    is retained (three barcodes) and the pair set equals the uncapped
    pass's."""
    fqb = make_fqb(rng, poly_g=True)
    capped, full = (_incidence(fqb, emission_cap_factor=c) for c in (4, 0))
    assert capped == full
    assert len(full[2]) > 100


@pytest.mark.parametrize("n_mesh", [2, 4])
def test_engine_sharded_poly_g_matches_single(rng, n_mesh):
    """The sharded count step packs each device's emissions the same way:
    poly-G reads and N bases count as on one device."""
    import jax
    if len(jax.devices()) < n_mesh:
        pytest.skip("needs virtual devices")
    fqb = make_fqb(rng, n=512, poly_g=True)
    outs = []
    for n in (1, n_mesh):
        cfg = EngineConfig(spec=HashSpec(k=21, w=11, seed=17),
                           count_mode="barcodes", table_bits=16,
                           batch_reads=512, n_shards=n)
        outs.append(counts_text(Engine(cfg, log=None), fqb, "barcodes"))
    assert outs[0] == outs[1]
