"""Sorted-run table: exact counts, order invariance, spill detection, growth,
merge (checkpoint) semantics."""

import numpy as np
import pytest

from hash10x_jax.hashspec import U64MAX
from hash10x_jax.table import sorted_table as ST


def table_dict(t):
    """flush + compact; returns (dict, flushed table). SortedTable has move
    semantics (flush/append donate buffers) — never reuse a pre-flush handle."""
    t = ST.flush(t)
    h, c = ST.compact(t)
    return dict(zip(h.tolist(), c.tolist())), t


def rand_batches(rng, n_batches, n, space, pad_frac=0.3):
    out = []
    for _ in range(n_batches):
        h = rng.integers(0, space, n).astype(np.uint64)
        pad = rng.random(n) < pad_frac
        h[pad] = U64MAX
        out.append(h)
    return out


def test_exact_counts_and_order_invariance(rng):
    batches = rand_batches(rng, 6, 4096, 1000)
    expect = {}
    for b in batches:
        for x in b[b != U64MAX].tolist():
            expect[x] = expect.get(x, 0) + 1

    t1 = ST.make_sorted_table(4096, 8192)
    for b in batches:
        t1 = ST.append(t1, b)
    d1, t1 = table_dict(t1)
    assert d1 == expect

    t2 = ST.make_sorted_table(4096, 16384)  # different flush cadence
    for b in reversed(batches):             # different order
        t2 = ST.append(t2, b)
    d2, t2 = table_dict(t2)
    assert d2 == expect
    assert int(np.asarray(t1.spilled)) == 0


def test_spill_detected(rng):
    t = ST.make_sorted_table(64, 4096)
    h = rng.integers(0, 1 << 30, 1024).astype(np.uint64)
    t = ST.append(t, h)
    t = ST.flush(t)
    n_unique = len(set(h.tolist()))
    assert int(np.asarray(t.spilled)) == n_unique - 64
    # survivors are the smallest 64 hashes with exact counts
    hh, cc = ST.compact(t)
    assert (hh == np.sort(np.unique(h))[:64]).all()


def test_grow_preserves_counts(rng):
    t = ST.make_sorted_table(256, 4096)
    h = rng.integers(0, 200, 2048).astype(np.uint64)
    t = ST.append(t, h)
    before, t = table_dict(t)
    t = ST.grow(t, 4096)
    assert t.capacity == 4096
    after, t = table_dict(t)
    assert after == before


def test_merge_counts(rng):
    t = ST.make_sorted_table(1024, 4096)
    h = rng.integers(0, 500, 2048).astype(np.uint64)
    t = ST.append(t, h)
    t = ST.flush(t)
    other_h = np.arange(400, 600, dtype=np.uint64)
    other_w = np.full(200, 7, np.uint32)
    t = ST.merge_counts(t, other_h, other_w)
    d, t = table_dict(t)
    base = {}
    for x in h.tolist():
        base[x] = base.get(x, 0) + 1
    for x in range(400, 600):
        base[x] = base.get(x, 0) + 7
    assert d == base


def test_lookup_ids(rng):
    t = ST.make_sorted_table(1024, 4096)
    h = rng.integers(0, 1 << 40, 800).astype(np.uint64)
    t = ST.flush(ST.append(t, h))
    uniq = np.sort(np.unique(h))
    ids, found = ST.lookup_ids(t.hashes, h)
    ids, found = np.asarray(ids), np.asarray(found)
    assert found.all()
    assert (np.asarray(t.hashes)[ids] == h).all()
    absent = (uniq[-1] + 1 + np.arange(16)).astype(np.uint64)
    _, f2 = ST.lookup_ids(t.hashes, absent)
    assert not np.asarray(f2).any()


def test_compact_requires_flush(rng):
    t = ST.make_sorted_table(64, 512)
    t = ST.append(t, np.arange(10, dtype=np.uint64))
    with pytest.raises(ValueError):
        ST.compact(t)


def test_flush_sliced_matches_flush_grow(rng):
    """The fill-proportional sliced flush (pow2 fill/buf_n slices, pad-concat
    growth, async n_real) must produce the same table contents as the
    full-width flush_grow path, including across capacity growth and with a
    stale-but-valid fill bound."""
    keys = rng.integers(0, 5000, size=6000).astype(np.uint64) * np.uint64(7)
    batches = np.array_split(keys, 13)

    ref = ST.make_sorted_table(1 << 6, 1 << 13)
    for b in batches:
        ref = ST.append(ref, b)
        ref = ST.flush_grow(ref)
    rh, rc = ST.compact(ref)

    t = ST.make_sorted_table(1 << 6, 1 << 13)
    bound = 0
    pending = None
    for i, b in enumerate(batches):
        t = ST.append(t, b)
        if pending is not None:
            bound = int(np.asarray(pending))  # exact one-flush-stale fill
            pending = None
        buffered = t.buf_n
        t, nreal = ST.flush_sliced(t, bound)
        if nreal is not None:
            pending = nreal
        bound = bound + buffered  # loose advance until the exact lands
    gh, gc = ST.compact(t)
    assert (rh == gh).all() and (rc == gc).all()
    assert int(np.asarray(t.spilled)) == 0


def test_flush_sliced_empty_and_tiny():
    t = ST.make_sorted_table(1 << 4, 1 << 6)
    t2, nreal = ST.flush_sliced(t, 0)
    assert nreal is None and t2 is t
    t = ST.append(t, np.array([42], np.uint64))
    t, nreal = ST.flush_sliced(t, 0)
    assert int(np.asarray(nreal)) == 1
    h, c = ST.compact(t)
    assert list(h) == [42] and list(c) == [1]
