"""Sort-based join primitives (table/incidence.py, utils/dense.py).

These replace gather-based binary search on the device hot paths (BENCH r5:
the default ``jnp.searchsorted`` ran ~log2(T) random gather passes per batch
and was the measured warm incidence/split wall).  Differential vs numpy.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from hash10x_jax.hashspec import U64MAX
from hash10x_jax.table.incidence import (combined_key_bits,
                                         finalize_combined_pairs, rank_join)
from hash10x_jax.utils.dense import device_dense_ranks, distinct_below


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_join_matches_searchsorted(seed):
    rng = np.random.default_rng(seed)
    T, Q = 1 << 10, 1 << 12
    tab = np.sort(rng.choice(2 ** 40, T - 100, replace=False).astype(np.uint64))
    tab = np.concatenate([tab, np.full(100, U64MAX, np.uint64)])  # pads
    q = np.concatenate([rng.choice(tab[:T - 100], Q // 2),
                        rng.integers(0, 2 ** 40, Q // 2).astype(np.uint64)])
    idx, found = (np.asarray(x) for x in
                  rank_join(jnp.asarray(tab), jnp.asarray(q)))
    ref_idx = np.searchsorted(tab, q)
    ref_c = np.minimum(ref_idx, len(tab) - 1)
    ref_found = tab[ref_c] == q
    assert (found == ref_found).all()
    assert (idx[found] == ref_c[found]).all()


def test_rank_join_below_all_and_zero():
    tab = jnp.asarray(np.array([5, 9, 9, 12], np.uint64))
    q = jnp.asarray(np.array([0, 5, 6, 9, 13], np.uint64))
    idx, found = (np.asarray(x) for x in rank_join(tab, q))
    assert found.tolist() == [False, True, False, True, False]
    assert idx[1] == 0 and idx[3] in (1, 2)


def test_combined_key_bits_gate():
    assert combined_key_bits(21, 50_000) == 42
    assert combined_key_bits(21, (1 << 22) - 1) == 42
    assert combined_key_bits(21, 1 << 22) == 0     # max key would hit U64MAX
    assert combined_key_bits(32, 2) == 0           # hash fills the word


def test_finalize_combined_pairs_matches_host():
    rng = np.random.default_rng(3)
    k, n_codes = 21, 37
    hb = combined_key_bits(k, n_codes)
    retained = np.sort(rng.choice(1 << (2 * k), 500, replace=False)
                       .astype(np.uint64))
    pad = np.full(512 - 500, U64MAX, np.uint64)
    ret_pad = np.concatenate([retained, pad])
    # distinct (code, hash) keys: half retained hashes, half strangers
    bcs = rng.integers(0, n_codes, 2000).astype(np.uint64)
    hs = np.concatenate([rng.choice(retained, 1000),
                         rng.integers(0, 1 << 42, 1000).astype(np.uint64)])
    keys = np.unique((bcs << np.uint64(hb)) | hs)
    kp = np.full(4096, U64MAX, np.uint64)
    kp[:len(keys)] = keys
    got, n_real = finalize_combined_pairs(
        jnp.asarray(kp), jnp.asarray(ret_pad), jnp.uint64(len(retained)), hb)
    got = np.asarray(got)[:int(n_real)]
    # host reference
    rid = np.searchsorted(retained, hs)
    rc = np.minimum(rid, len(retained) - 1)
    ok = retained[rc] == hs
    want = np.unique(bcs[ok] * np.uint64(len(retained))
                     + rc[ok].astype(np.uint64))
    assert got.tolist() == want.tolist()


def test_distinct_below_and_dense_ranks():
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 50, 400).astype(np.int64)
    got = device_dense_ranks(vals)
    want = np.searchsorted(np.unique(vals), vals)
    assert got.tolist() == want.tolist()
    # absent queries: count of distinct strictly below
    s = np.sort(vals)
    is_new = np.concatenate([[True], s[1:] != s[:-1]])
    q = np.array([-5, 0, 7, 200], np.int64)
    d = np.asarray(distinct_below(jnp.asarray(s),
                                  jnp.asarray(is_new), jnp.asarray(q)))
    uniq = np.unique(vals)
    want_q = [(uniq < x).sum() for x in q]
    assert d.tolist() == want_q
