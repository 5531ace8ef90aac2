"""Device-side unique / dense-rank helpers.

np.unique over the flat pair volume (sort + boundary scan on host) shows up
in every report-shaped pass at 1M+ barcodes; these helpers run the sort,
boundary detection, counts, and rank joins on device and hand back compact
numpy arrays (the final boolean compress is a single host memcpy-speed pass).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["device_unique", "device_dense_ranks"]


@jax.jit
def _sorted_marks(c):
    s = jnp.sort(c)
    is_new = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]])
    return s, is_new


def distinct_below(s, is_new, q):
    """For each query in ``q``: the number of DISTINCT values of the sorted
    array ``s`` strictly below it — which equals dense_rank(q) when q is
    present in s, and searchsorted-left's dense rank when absent.  Pure
    lax.sort merge join, zero gathers (``dense_of_sorted[idx]`` was a random
    gather over the full pair volume, one of the warm split/report walls)."""
    T, Q = s.shape[0], q.shape[0]
    key = jnp.concatenate([s, q])
    # queries sort BEFORE equal table entries (tag 0 < 1), so the running
    # distinct-table count at a query position counts strictly-less values
    tag = jnp.concatenate([jnp.ones(T, jnp.int32), jnp.zeros(Q, jnp.int32)])
    pay = jnp.concatenate([is_new.astype(jnp.int64),
                           jnp.zeros(Q, jnp.int64)])
    pos = jnp.concatenate([jnp.zeros(T, jnp.int32),
                           jnp.arange(Q, dtype=jnp.int32)])
    sk, stag, spay, spos = jax.lax.sort((key, tag, pay, pos),
                                        dimension=0, num_keys=2)
    run = jnp.cumsum(jnp.where(stag == 1, spay, 0))
    # unsort: queries (tag 0) land first, in original order
    _, _, dq = jax.lax.sort((stag, spos, run), dimension=0, num_keys=2)
    return dq[:Q]


@jax.jit
def _dense_of(c):
    s, is_new = _sorted_marks(c)
    return distinct_below(s, is_new, c)


def device_unique(values: np.ndarray, return_counts: bool = False):
    """np.unique(values[, return_counts=True]) with the heavy lifting on
    device; values must be integer-typed."""
    if len(values) == 0:
        u = np.zeros(0, np.asarray(values).dtype)
        return (u, np.zeros(0, np.int64)) if return_counts else u
    s, is_new = (np.asarray(x) for x in _sorted_marks(jnp.asarray(values)))
    if return_counts:
        # segment lengths from boundary positions — same single host pass as
        # the boolean compress below (positions are cheaper than an int64
        # reverse-cummin counts variant on device)
        pos = np.flatnonzero(is_new)
        return s[pos], np.diff(np.append(pos, len(s))).astype(np.int64,
                                                              copy=False)
    return s[is_new]


def device_dense_ranks(values: np.ndarray) -> np.ndarray:
    """Rank of each element among the sorted distinct values — equal to
    np.searchsorted(np.unique(values), values) — computed on device."""
    if len(values) == 0:
        return np.zeros(0, np.int64)
    return np.asarray(_dense_of(jnp.asarray(values)))
