"""Device open-addressing table vs the dict oracle: exact counts, determinism,
overflow accounting (SURVEY.md §5 items 2/4)."""

import numpy as np
import pytest

from hash10x_jax.hashspec import HashSpec, U64MAX
from hash10x_jax.core import seqhash_jnp as J
from hash10x_jax.oracle import table_ref as TO
from hash10x_jax.table import oa_table as T

from conftest import random_codes


def rand_hashes(rng, n, space=1 << 20, pad_to=None):
    h = rng.integers(0, space, size=n).astype(np.uint64)
    if pad_to:
        h = np.concatenate([h, np.full(pad_to - n, U64MAX, np.uint64)])
    return h


def table_dict(table):
    keys = np.asarray(table.keys)
    counts = np.asarray(table.counts)
    m = keys != U64MAX
    return dict(zip(keys[m].tolist(), counts[m].tolist()))


def test_insert_counts_match_oracle(rng):
    t = T.make_table(bits=12)
    h = rand_hashes(rng, 3000, space=500, pad_to=4096)  # heavy duplication
    t = T.insert(t, h, np.ones(4096, np.uint32))
    expect = {}
    for x in h[h != U64MAX].tolist():
        expect[x] = expect.get(x, 0) + 1
    assert table_dict(t) == expect
    assert int(t.overflow) == 0


def test_insert_across_batches_accumulates(rng):
    t = T.make_table(bits=12)
    h1 = rand_hashes(rng, 1000, space=300, pad_to=1024)
    h2 = rand_hashes(rng, 1000, space=300, pad_to=1024)
    t = T.insert(t, h1, np.ones(1024, np.uint32))
    t = T.insert(t, h2, np.ones(1024, np.uint32))
    expect = {}
    for x in np.concatenate([h1, h2]).tolist():
        if x != U64MAX:
            expect[x] = expect.get(x, 0) + 1
    assert table_dict(t) == expect


def test_insert_order_invariance(rng):
    """Same multiset in different order/batching -> identical table contents.

    (Holds whenever nothing overflows; parity runs size tables so overflow = 0,
    matching the reference's never-dropping chained table.)
    """
    h = rand_hashes(rng, 2048, space=1 << 16)
    w = np.ones(2048, np.uint32)
    t1 = T.insert(T.make_table(12), h, w)
    perm = rng.permutation(2048)
    t2 = T.make_table(12)
    t2 = T.insert(t2, h[perm][:1024], w[:1024])
    t2 = T.insert(t2, h[perm][1024:], w[:1024])
    assert int(t1.overflow) == 0 and int(t2.overflow) == 0
    assert table_dict(t1) == table_dict(t2)


def test_overflow_accounting(rng):
    """More distinct keys than slots: every key is either resident or counted
    in overflow — nothing silently dropped (SURVEY.md §8.3)."""
    h = rand_hashes(rng, 2048, space=1 << 16)
    t = T.insert(T.make_table(10), h, np.ones(2048, np.uint32))
    n_resident = int((np.asarray(t.keys) != U64MAX).sum())
    n_unique = len(set(h.tolist()))
    assert n_resident == 1024  # table completely full
    assert n_resident + int(t.overflow) == n_unique
    # resident counts are still exact for the keys that made it in
    expect = {}
    for x in h.tolist():
        expect[x] = expect.get(x, 0) + 1
    for k, c in table_dict(t).items():
        assert expect[k] == c


def test_lookup(rng):
    t = T.make_table(bits=12)
    h = rand_hashes(rng, 2000, space=1 << 30, pad_to=2048)
    t = T.insert(t, h, np.ones(2048, np.uint32))
    slots, found = T.lookup(t, h)
    slots, found = np.asarray(slots), np.asarray(found)
    real = h != U64MAX
    assert found[real].all() and not found[~real].any()
    keys = np.asarray(t.keys)
    assert (keys[slots[real]] == h[real]).all()
    # absent keys report not-found
    absent = (rng.integers(1 << 40, 1 << 41, size=64)).astype(np.uint64)
    _, f2 = T.lookup(t, absent)
    assert not np.asarray(f2).any()


def test_histogram_and_compact(rng):
    t = T.make_table(bits=12)
    # known count profile: hash i repeated (i % 5 + 1) times
    hs, ws = [], []
    for i in range(200):
        hs.append(np.uint64(i * 1000 + 7))
        ws.append(i % 5 + 1)
    h = np.array(hs, np.uint64)
    t = T.insert(t, h, np.array(ws, np.uint32))
    hist = np.asarray(T.count_histogram(t, max_count=10))
    for c in range(1, 6):
        assert hist[c] == 40, (c, hist[:8])
    assert hist[6:].sum() == 0 and hist[0] == 0
    # band filter [2,4] keeps counts 2..4; canonical order = sorted hash
    ch, cc = T.compact(t, min_count=2, max_count=4)
    assert (np.diff(ch.astype(np.int64)) > 0).all()
    assert set(cc.tolist()) == {2, 3, 4} and len(ch) == 120


def test_end_to_end_sketch_counts_match_oracle(rng):
    """reads -> minimizer sketch -> device table == oracle dict counts."""
    spec = HashSpec(k=21, w=7, seed=17)
    B, L = 32, 120
    codes = np.stack([random_codes(rng, L) for _ in range(B)])
    lengths = np.full(B, L, np.int32)
    hashes, _, emit = J.sketch(spec, codes, lengths, mode="minimizer")
    flat = np.where(np.asarray(emit), np.asarray(hashes), U64MAX).reshape(-1)
    t = T.insert(T.make_table(14), flat, np.ones(flat.shape, np.uint32))
    expect = TO.count_reads(spec, [list(r) for r in codes], mode="minimizer")
    assert table_dict(t) == dict(expect)
