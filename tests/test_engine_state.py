"""Engine state-isolation regressions (round-4 advisor findings).

Three hazards, all of the form "one table's private state leaks into
another's":

1. The async exact-fill scalar (``_pending_nreal``) was engine-global but the
   engine runs several LSM tables (count table, incidence pair table,
   occurrence side pass); a count after an incidence on the same engine
   consumed the PAIR table's fill as the COUNT table's bound, and a
   smaller-than-true bound makes flush_sliced's b1 slice drop real keys.
2. A dispatch appending more entries than the whole buffer (the jnp-fallback
   step variant has ~2x the kernel variant's slots) relied on
   dynamic_update_slice, which CLAMPS out-of-range offsets — silently
   overwriting earlier appends.  The buffer must grow.
3. ``load()`` claimed to REPLACE state but left the sharded-lane members
   (``_dt``/``_ret_sh``) alive, so a later incidence resurrected the
   pre-load lane's retained set.
"""

import io

import jax.numpy as jnp
import numpy as np

from hash10x_jax.hashspec import HashSpec, U64MAX
from hash10x_jax.engine import Engine, EngineConfig
from hash10x_jax.io.fqb import Fqb
from hash10x_jax.core.encode import pack_2bit
from hash10x_jax.table import sorted_table as st

L = 150
SPEC = HashSpec(k=21, w=11, seed=17)


def make_fqb(rng, n=1024, n_codes=16, seed_len=60_000):
    genome = rng.integers(0, 4, size=seed_len).astype(np.uint8)
    starts = rng.integers(0, len(genome) - L, size=n)
    reads = np.stack([genome[s:s + L] for s in starts])
    bcs = rng.integers(0, n_codes, size=n).astype(np.int32)
    return Fqb(packed=pack_2bit(reads), lengths=np.full(n, L, np.int32),
               barcode_ids=bcs,
               barcode_keys=np.arange(n_codes, dtype=np.uint32), read_len=L)


def counts_text(eng):
    buf = io.StringIO()
    eng.write_counts(buf)
    return buf.getvalue()


def test_count_after_incidence_keeps_count_table_exact(rng):
    """--readFQB a --codeClusters --readFQB b: the second count pass must not
    consume the incidence pair table's async fill as its own bound."""
    a = make_fqb(rng, n=768)
    b = make_fqb(rng, n=768, seed_len=50_000)
    # small table/buffer so BOTH passes actually flush (the leak needs a
    # pending scalar on each side)
    cfg = EngineConfig(spec=SPEC, count_mode="barcodes", table_bits=10,
                       batch_reads=128, flush_batches=2)
    eng = Engine(cfg, log=None)
    eng.count(a)
    eng.filter()
    eng.incidence(a)
    eng.count(b)

    ref = Engine(cfg, log=None)
    ref.count(a)
    ref.count(b)
    assert counts_text(eng) == counts_text(ref)


def test_pre_append_grows_buffer_beyond_capacity():
    """A single append wider than the whole buffer must grow it, preserving
    already-buffered entries (dynamic_update_slice would clamp + overwrite)."""
    cfg = EngineConfig(spec=SPEC, count_mode="occurrences", table_bits=4)
    eng = Engine(cfg, log=None)
    eng.table = st.make_sorted_table(16, 16)
    eng.table = st.append(eng.table, jnp.asarray(
        np.arange(10, dtype=np.uint64)))
    eng._pre_append(64)  # wider than the 16-slot buffer
    assert eng.table.buf.shape[0] >= 64
    eng.table = st.append(eng.table, jnp.asarray(
        np.arange(100, 164, dtype=np.uint64)))
    t = st.flush_grow(eng.table)
    h, c = st.compact(t)
    # the 10 early keys survived the growth (they flushed or were preserved)
    assert set(np.arange(10, dtype=np.uint64).tolist()) <= set(h.tolist())
    assert set(np.arange(100, 164, dtype=np.uint64).tolist()) <= set(h.tolist())


def test_grow_buf_preserves_buffered_entries():
    t = st.make_sorted_table(32, 8)
    t = st.append(t, jnp.asarray(np.array([5, 7, 9], np.uint64)))
    t = st.grow_buf(t, 64)
    assert t.buf.shape[0] == 64 and t.buf_n == 3
    t = st.flush_grow(t)
    h, c = st.compact(t)
    assert h.tolist() == [5, 7, 9]
    assert c.tolist() == [1, 1, 1]


def test_load_clears_sharded_state(rng, tmp_path):
    """--readHash after a sharded count+filter must not resurrect the
    pre-load lane's sharded retained set."""
    lane = make_fqb(rng, n=256)
    other = make_fqb(rng, n=256, seed_len=30_000)

    plain = Engine(EngineConfig(spec=SPEC, count_mode="barcodes",
                                table_bits=10, batch_reads=128), log=None)
    plain.count(other)
    plain.filter()
    path = str(tmp_path / "other.npz")
    plain.save(path)

    cfg = EngineConfig(spec=SPEC, count_mode="barcodes", table_bits=10,
                       batch_reads=128, n_shards=2)
    eng = Engine(cfg, log=None)
    eng.count(lane)
    eng.filter()
    assert eng._ret_sh is not None
    eng.load(path)
    assert eng._dt is None and eng._ret_sh is None
    assert eng._pending_nreal is None
    # the loaded retained set is the checkpoint's, not the sharded lane's
    assert np.array_equal(eng.retained_hashes, plain.retained_hashes)


def test_errorfix_rescue_unhonorable_raises(rng):
    """--errorFixReads with no reads loaded (or non-barcode counts) must
    raise loudly, not silently degrade to drop-only."""
    import pytest
    fqb = make_fqb(rng, n=128)
    cfg = EngineConfig(spec=SPEC, count_mode="barcodes", table_bits=10,
                       batch_reads=128)
    eng = Engine(cfg, log=None)
    eng.count(fqb)
    with pytest.raises(RuntimeError, match="cannot be honored"):
        eng.error_fix(max_count=1, fqb=None, min_reads=2)

    occ = Engine(EngineConfig(spec=SPEC, count_mode="occurrences",
                              table_bits=10, batch_reads=128), log=None)
    occ.count(fqb)
    with pytest.raises(RuntimeError, match="cannot be honored"):
        occ.error_fix(max_count=1, fqb=fqb, min_reads=2)
