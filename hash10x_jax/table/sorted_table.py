"""Sorted-run (LSM-style) k-mer count table — the count-pass path.

Why this exists: the open-addressing probe loop (``oa_table.py``) is exact but
pays data-dependent probe rounds of scatters over the whole table; this table
embraces sorting instead, the way KMC2/Gerbil bucket-and-sort counters do on
CPU/GPU (PAPERS.md).  Which of the two is faster on the H100 is not measured
yet (ROADMAP Y4):

* state: ``hashes (C,) u64`` ascending with U64MAX padding, ``counts (C,) u32``,
  plus a *weighted* append buffer ``buf (Bc,) u64`` + ``bufw (Bc,) u32``: each
  entry is a (key, multiplicity) pair, so callers can pre-reduce a batch on
  device (``dedup_weighted`` / ``dedup_pairs_weighted``) and append ~5-10x
  fewer entries than raw emissions — flushes get proportionally rarer/cheaper.
  ``append`` of raw emissions (weight 1 each) still works.
* ``append``/``append_pairs``: one fused ``dynamic_update_slice`` pair per
  batch — O(batch).
* ``flush`` (when the buffer would overflow): two-operand sort of
  (table ++ buffer) carrying weights, segment-sum of equal keys onto their first
  slot, then a second stable sort that compacts survivors to the front (U64MAX
  pads sink to the end).  Fully deterministic and batch-order invariant.
* ``lookup``/canonical ids: the table IS the sorted retained array — binary
  search (``searchsorted``), ~log2(C) vectorized gathers per batch.

Capacity overflow is detected exactly (any real key past C after a flush) and
reported via ``spilled``; callers grow C and re-run — never silent (SURVEY.md
§8.3).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..hashspec import U64MAX

__all__ = ["SortedTable", "make_sorted_table", "append", "append_pairs",
           "flush", "flush_grow", "flush_sliced", "grow_buf",
           "count_histogram", "compact", "lookup_ids", "dedup_weighted",
           "dedup_pairs_weighted"]

# numpy scalar, NOT jnp: a module-level jnp array would initialize the
# backend at import; np scalars lower as literals
_U64MAX = np.uint64(U64MAX)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class SortedTable:
    hashes: jnp.ndarray    # (C,) uint64 ascending, U64MAX padded
    counts: jnp.ndarray    # (C,) uint32
    buf: jnp.ndarray       # (Bc,) uint64 buffered keys, U64MAX padded
    bufw: jnp.ndarray      # (Bc,) uint32 per-key multiplicities
    buf_n: int             # host-tracked fill (static per flush schedule)
    spilled: jnp.ndarray   # () uint32 — keys lost to capacity overflow

    def tree_flatten(self):
        return ((self.hashes, self.counts, self.buf, self.bufw, self.spilled),
                self.buf_n)

    @classmethod
    def tree_unflatten(cls, aux, children):
        h, c, b, w, s = children
        return cls(h, c, b, w, aux, s)

    @property
    def capacity(self) -> int:
        return self.hashes.shape[0]

    @property
    def n_filled(self) -> jnp.ndarray:
        return jnp.sum(self.hashes != _U64MAX)


def make_sorted_table(capacity: int, buf_capacity: int) -> SortedTable:
    return SortedTable(
        hashes=jnp.full((capacity,), _U64MAX, jnp.uint64),
        counts=jnp.zeros((capacity,), jnp.uint32),
        buf=jnp.full((buf_capacity,), _U64MAX, jnp.uint64),
        bufw=jnp.zeros((buf_capacity,), jnp.uint32),
        buf_n=0,
        spilled=jnp.zeros((), jnp.uint32),
    )


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _buf_write(buf, bufw, emissions, offset):
    # offset is a traced scalar: a static offset would force one XLA compile per
    # distinct buffer position
    w = (emissions != _U64MAX).astype(jnp.uint32)
    return (jax.lax.dynamic_update_slice(buf, emissions, (jnp.int32(offset),)),
            jax.lax.dynamic_update_slice(bufw, w, (jnp.int32(offset),)))


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _buf_write_pairs(buf, bufw, keys, weights, offset):
    return (jax.lax.dynamic_update_slice(buf, keys, (jnp.int32(offset),)),
            jax.lax.dynamic_update_slice(bufw, weights.astype(jnp.uint32),
                                         (jnp.int32(offset),)))


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _merge_impl(hashes, counts, other_h, other_w):
    """Merge (hashes, counts) with (other_h, other_w): sort, segment-sum equal
    keys, compact.  Returns (merged_h[:C], merged_w[:C], spilled) with C =
    hashes' capacity."""
    C = hashes.shape[0]
    all_h = jnp.concatenate([hashes, other_h])
    all_w = jnp.concatenate([counts, other_w.astype(jnp.uint32)])
    all_h, all_w = jax.lax.sort((all_h, all_w), dimension=0, num_keys=1)
    # Segment totals via cumsum differences at segment boundaries (chosen over a
    # scatter-based segment-sum; not re-measured on the H100).  With c =
    # inclusive cumsum(w), the sum of a segment ending at its
    # last element p is c[p] - c[last element of the previous segment]; the latter
    # is an exclusive running max of c masked to last-positions (c is
    # nondecreasing, weights are unsigned).
    is_last = jnp.concatenate([all_h[:-1] != all_h[1:], jnp.ones((1,), bool)])
    c = jnp.cumsum(all_w.astype(jnp.uint64))
    boundary = jnp.where(is_last, c, 0)
    prev_boundary = jnp.concatenate(
        [jnp.zeros((1,), jnp.uint64), jax.lax.cummax(boundary)[:-1]])
    seg_sum = (c - prev_boundary).astype(jnp.uint32)
    keep = is_last & (all_h != _U64MAX)
    uniq_h = jnp.where(keep, all_h, _U64MAX)
    uniq_w = jnp.where(keep, seg_sum, 0)
    # compact: stable sort sinks U64MAX pads, keeps survivors ascending
    uniq_h, uniq_w = jax.lax.sort((uniq_h, uniq_w), dimension=0, num_keys=1)
    spilled_now = jnp.sum(uniq_h[C:] != _U64MAX).astype(jnp.uint32)
    return uniq_h[:C], uniq_w[:C].astype(jnp.uint32), spilled_now


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _fresh_buf(buf, bufw):
    return (jnp.full(buf.shape, _U64MAX, jnp.uint64),
            jnp.zeros(bufw.shape, jnp.uint32))


def flush(t: SortedTable) -> SortedTable:
    if t.buf_n == 0:
        return t
    h, c, spilled_now = _merge_impl(t.hashes, t.counts, t.buf, t.bufw)
    fb, fw = _fresh_buf(t.buf, t.bufw)
    return SortedTable(h, c, fb, fw, 0, t.spilled + spilled_now)


@functools.partial(jax.jit, static_argnames=("b1", "b2"),
                   donate_argnums=(0, 1))
def _merge_sliced(hashes, counts, buf, bufw, b1: int, b2: int):
    """Fill-proportional flush merge: sort only the table's first ``b1`` slots
    (ALL real keys live there — the table is ascending with U64MAX pads at the
    end, and callers pass b1 >= the exact fill after the previous flush) with
    the buffer's first ``b2`` slots (>= buf_n), then write the merged run back
    over ``table[:b1+b2]`` — positions past b1+b2 were pads and stay pads, so
    the full-width table remains globally sorted.  Sort volume is ~pow2(fill)
    instead of capacity+buffer (a mostly-empty 4M-slot table would sort its
    pads).  Requires capacity >= b1+b2 (host-checked; grow is a pad-concat).
    Returns (hashes', counts', n_real) with n_real a DEVICE scalar — callers
    fetch it asynchronously so the count loop never blocks on a per-flush
    host sync."""
    all_h = jnp.concatenate([hashes[:b1], buf[:b2]])
    all_w = jnp.concatenate([counts[:b1], bufw[:b2].astype(jnp.uint32)])
    all_h, all_w = jax.lax.sort((all_h, all_w), dimension=0, num_keys=1)
    is_last = jnp.concatenate([all_h[:-1] != all_h[1:], jnp.ones((1,), bool)])
    c = jnp.cumsum(all_w.astype(jnp.uint64))
    boundary = jnp.where(is_last, c, 0)
    prev_boundary = jnp.concatenate(
        [jnp.zeros((1,), jnp.uint64), jax.lax.cummax(boundary)[:-1]])
    seg_sum = (c - prev_boundary).astype(jnp.uint32)
    keep = is_last & (all_h != _U64MAX)
    uniq_h = jnp.where(keep, all_h, _U64MAX)
    uniq_w = jnp.where(keep, seg_sum, 0)
    uniq_h, uniq_w = jax.lax.sort((uniq_h, uniq_w), dimension=0, num_keys=1)
    n_real = jnp.sum(keep).astype(jnp.int64)
    h2 = jax.lax.dynamic_update_slice(hashes, uniq_h, (0,))
    c2 = jax.lax.dynamic_update_slice(counts, uniq_w, (0,))
    return h2, c2, n_real


def _pow2ceil(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def flush_sliced(t: SortedTable, fill_bound: int):
    """Sliced, never-spilling, sync-free flush for the count hot loop.

    ``fill_bound`` must be >= the table's true fill (exact one-flush-stale
    counts qualify: the table only changes at flushes, so the previous
    flush's n_real IS the current fill).  Capacity grows by pad-concat when
    the merged run wouldn't fit — no host sync, no spill, ever.  Returns
    (table', n_real_device_scalar | None); callers may fetch n_real
    asynchronously to refresh their bound."""
    if t.buf_n == 0:
        return t, None
    b1 = min(_pow2ceil(max(fill_bound, 1)), t.capacity)
    b2 = min(_pow2ceil(t.buf_n), t.buf.shape[0])
    hashes, counts = t.hashes, t.counts
    if b1 + b2 > t.capacity:
        new_cap = _pow2ceil(b1 + b2)
        hashes, counts = _take_cap(hashes, counts, new_cap)
    h, c, n_real_d = _merge_sliced(hashes, counts, t.buf, t.bufw, b1, b2)
    fb, fw = _fresh_buf(t.buf, t.bufw)
    return SortedTable(h, c, fb, fw, 0, t.spilled), n_real_d


@jax.jit
def _merge_full(hashes, counts, other_h, other_w):
    """_merge_impl without capacity truncation: returns the full (C+B,) merged
    arrays (real keys ascending first, U64MAX pads last) — cannot spill.
    No donation: input and output shapes never match (C vs C+B), donated
    buffers would just warn and copy."""
    all_h = jnp.concatenate([hashes, other_h])
    all_w = jnp.concatenate([counts, other_w.astype(jnp.uint32)])
    all_h, all_w = jax.lax.sort((all_h, all_w), dimension=0, num_keys=1)
    is_last = jnp.concatenate([all_h[:-1] != all_h[1:], jnp.ones((1,), bool)])
    c = jnp.cumsum(all_w.astype(jnp.uint64))
    boundary = jnp.where(is_last, c, 0)
    prev_boundary = jnp.concatenate(
        [jnp.zeros((1,), jnp.uint64), jax.lax.cummax(boundary)[:-1]])
    seg_sum = (c - prev_boundary).astype(jnp.uint32)
    keep = is_last & (all_h != _U64MAX)
    uniq_h = jnp.where(keep, all_h, _U64MAX)
    uniq_w = jnp.where(keep, seg_sum, 0)
    uniq_h, uniq_w = jax.lax.sort((uniq_h, uniq_w), dimension=0, num_keys=1)
    return uniq_h, uniq_w, jnp.sum(keep).astype(jnp.int64)


@functools.partial(jax.jit, static_argnames=("cap",))
def _take_cap(h, w, cap: int):
    n = h.shape[0]
    if cap <= n:
        return h[:cap], w[:cap]
    return (jnp.concatenate([h, jnp.full((cap - n,), _U64MAX, jnp.uint64)]),
            jnp.concatenate([w, jnp.zeros((cap - n,), jnp.uint32)]))


def flush_grow(t: SortedTable, load: float = 0.6, return_count: bool = False):
    """Flush with automatic capacity adoption: the merge runs at full
    (capacity + buffer) width so it can NEVER spill, then the table re-homes at
    the power-of-two capacity that keeps occupancy under ``load``.  Costs one
    host sync per flush (the true fill count) — steady-state callers avoid it
    by tracking a host-side occupancy UPPER BOUND and calling the sync-free
    ``flush`` while the bound stays under ``load`` (engine._flush_table).
    This removes table_bits tuning: capacity follows the data.
    ``return_count=True`` additionally returns the exact fill count the sync
    already paid for (callers refresh their bound with it)."""
    if t.buf_n == 0:
        return (t, int(np.asarray(t.n_filled))) if return_count else t
    h, w, n_real_d = _merge_full(t.hashes, t.counts, t.buf, t.bufw)
    n_real = int(np.asarray(n_real_d))  # one sync per flush (rare by sizing)
    new_cap = t.capacity
    while n_real > load * new_cap:
        new_cap *= 2
    nh, nw = _take_cap(h, w, new_cap)
    fb, fw = _fresh_buf(t.buf, t.bufw)
    res = SortedTable(nh, nw, fb, fw, 0, t.spilled)
    return (res, n_real) if return_count else res


@functools.partial(jax.jit, static_argnames=("cap",), donate_argnums=(0, 1))
def _grow_buf_impl(buf, bufw, cap: int):
    n = buf.shape[0]
    return (jnp.concatenate([buf, jnp.full((cap - n,), _U64MAX, jnp.uint64)]),
            jnp.concatenate([bufw, jnp.zeros((cap - n,), jnp.uint32)]))


def grow_buf(t: SortedTable, buf_capacity: int) -> SortedTable:
    """Grow the append buffer in place (pad-concat, keeps buffered entries).

    Callers whose per-dispatch append width can EXCEED the buffer created at
    table time (e.g. a jnp-fallback step variant with ~2x the kernel variant's
    slots) must grow before writing: ``_buf_write``'s dynamic_update_slice
    CLAMPS out-of-range offsets and would silently overwrite earlier appends."""
    if buf_capacity <= t.buf.shape[0]:
        return t
    buf, bufw = _grow_buf_impl(t.buf, t.bufw, _pow2ceil(buf_capacity))
    return SortedTable(t.hashes, t.counts, buf, bufw, t.buf_n, t.spilled)


def merge_counts(t: SortedTable, other_h, other_w) -> SortedTable:
    """Merge external (hash, count) pairs (e.g. a loaded checkpoint or another
    shard's table) into this table."""
    t = flush(t)
    h, c, spilled_now = _merge_impl(t.hashes, t.counts,
                                    jnp.asarray(other_h, jnp.uint64),
                                    jnp.asarray(other_w, jnp.uint32))
    return SortedTable(h, c, t.buf, t.bufw, 0, t.spilled + spilled_now)


def grow(t: SortedTable, new_capacity: int, buf_capacity: int = 0) -> SortedTable:
    """Re-house the table in a larger capacity (host-triggered on high water).
    Growing the buffer alongside keeps the amortized flush-sort cost per
    appended element bounded (~2x) as the table outgrows the buffer."""
    t = flush(t)
    nt = make_sorted_table(new_capacity, buf_capacity or t.buf.shape[0])
    nt = merge_counts(nt, t.hashes, t.counts)
    return SortedTable(nt.hashes, nt.counts, nt.buf, nt.bufw, 0,
                       t.spilled + nt.spilled)


def append(t: SortedTable, emissions: jnp.ndarray) -> SortedTable:
    """Append a batch of emissions ((N,) u64, U64MAX pads fine); auto-flush."""
    n = emissions.shape[0]
    if n > t.buf.shape[0]:
        raise ValueError(f"batch {n} exceeds buffer capacity {t.buf.shape[0]}")
    if t.buf_n + n > t.buf.shape[0]:
        t = flush(t)
    buf, bufw = _buf_write(t.buf, t.bufw, emissions, t.buf_n)
    return SortedTable(t.hashes, t.counts, buf, bufw, t.buf_n + n, t.spilled)


def append_pairs(t: SortedTable, keys: jnp.ndarray, weights: jnp.ndarray
                 ) -> SortedTable:
    """Append pre-reduced (key, multiplicity) pairs ((N,) u64 + (N,) u32,
    U64MAX keys must carry weight 0); auto-flush."""
    n = keys.shape[0]
    if n > t.buf.shape[0]:
        raise ValueError(f"batch {n} exceeds buffer capacity {t.buf.shape[0]}")
    if t.buf_n + n > t.buf.shape[0]:
        t = flush(t)
    buf, bufw = _buf_write_pairs(t.buf, t.bufw, keys, weights, t.buf_n)
    return SortedTable(t.hashes, t.counts, buf, bufw, t.buf_n + n, t.spilled)


@functools.partial(jax.jit, static_argnames=("slots",))
def dedup_weighted(keyed: jnp.ndarray, slots: int):
    """Reduce raw emissions ((N,) u64, U64MAX pads) to (keys (slots,) u64,
    weights (slots,) u32, overflow ()) — sort, segment-sum equal keys, compact.
    ``overflow`` counts distinct keys beyond ``slots`` (callers raise — never
    silent).  The per-batch pre-reduction that makes buffered entries
    ~n_distinct instead of ~n_emissions."""
    s = jnp.sort(keyed)
    is_last = jnp.concatenate([s[:-1] != s[1:], jnp.ones((1,), bool)])
    valid = s != _U64MAX
    c = jnp.cumsum(valid.astype(jnp.uint32))
    boundary = jnp.where(is_last, c, 0)
    prev = jnp.concatenate(
        [jnp.zeros((1,), jnp.uint32), jax.lax.cummax(boundary)[:-1]])
    keep = is_last & valid
    uh = jnp.where(keep, s, _U64MAX)
    uw = jnp.where(keep, c - prev, 0)
    uh, uw = jax.lax.sort((uh, uw), dimension=0, num_keys=1)
    overflow = jnp.sum(uh[slots:] != _U64MAX).astype(jnp.uint32)
    return uh[:slots], uw[:slots], overflow


@functools.partial(jax.jit, static_argnames=("slots",))
def dedup_pairs_weighted(flat_h: jnp.ndarray, flat_bc: jnp.ndarray, slots: int):
    """Barcode-count pre-reduction: distinct (hash, barcode) pairs collapse to
    weight 1, then equal hashes segment-sum — so the returned weight per hash is
    its number of distinct barcodes in this batch (exact across batches when
    batches are barcode-aligned).  Rows with barcode < 0 (padding) are dropped.
    Returns (keys (slots,) u64, weights (slots,) u32, overflow ())."""
    # two-key lax.sort, NOT lexsort: one sort instead of an argsort plus
    # gathers (not re-measured on the H100)
    hs, bs = jax.lax.sort((flat_h, flat_bc), dimension=0, num_keys=2)
    first = jnp.concatenate([jnp.ones((1,), bool),
                             (hs[1:] != hs[:-1]) | (bs[1:] != bs[:-1])])
    valid = first & (bs >= 0) & (hs != _U64MAX)
    is_last = jnp.concatenate([hs[:-1] != hs[1:], jnp.ones((1,), bool)])
    c = jnp.cumsum(valid.astype(jnp.uint32))
    boundary = jnp.where(is_last, c, 0)
    prev = jnp.concatenate(
        [jnp.zeros((1,), jnp.uint32), jax.lax.cummax(boundary)[:-1]])
    keep = is_last & (hs != _U64MAX) & ((c - prev) > 0)
    uh = jnp.where(keep, hs, _U64MAX)
    uw = jnp.where(keep, c - prev, 0)
    uh, uw = jax.lax.sort((uh, uw), dimension=0, num_keys=1)
    overflow = jnp.sum(uh[slots:] != _U64MAX).astype(jnp.uint32)
    return uh[:slots], uw[:slots], overflow


@functools.partial(jax.jit, static_argnames=("max_count",))
def count_histogram(hashes, counts, max_count: int = 256) -> jnp.ndarray:
    resident = hashes != _U64MAX
    c = jnp.clip(counts, 0, max_count).astype(jnp.int32)
    return jnp.zeros((max_count + 1,), jnp.int64).at[
        jnp.where(resident, c, 0)].add(resident.astype(jnp.int64)).at[0].set(0)


@jax.jit
def _compact_impl(h, c, lo, hi):
    keep = (h != _U64MAX) & (c >= lo) & (c <= hi)
    hh = jnp.where(keep, h, _U64MAX)
    cc = jnp.where(keep, c, 0)
    hh, cc = jax.lax.sort((hh, cc), dimension=0, num_keys=1)
    return hh, cc, jnp.sum(keep)


def compact(t: SortedTable, min_count: int = 0, max_count: int = 0
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Host (hash, count) arrays, count-band filtered, ascending (already sorted
    — canonical ids are positions).  Flush first: ``t = flush(t)`` (flush donates
    the old buffers, so compact cannot flush on the caller's behalf).

    Filters and squeezes ON DEVICE and pulls a pow2 bucket of the survivor
    count — pulling the raw capacity arrays would move up to ~3x the data
    (400 MB at a 2^25 table)."""
    if t.buf_n:
        raise ValueError("compact requires a flushed table: t = flush(t) first")
    hh, cc, n_keep = _compact_impl(
        t.hashes, t.counts, jnp.uint32(min_count),
        jnp.uint32(max_count if max_count else 0xFFFFFFFF))
    n = int(n_keep)
    w = min(1 << max(int(n - 1).bit_length(), 4), int(hh.shape[0]))
    return np.asarray(hh[:w])[:n], np.asarray(cc[:w])[:n]


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _prune_impl(hashes, counts, min_count):
    keep = counts >= min_count
    h = jnp.where(keep, hashes, _U64MAX)
    c = jnp.where(keep, counts, 0)
    return jax.lax.sort((h, c), dimension=0, num_keys=1)


def prune(t: SortedTable, min_count: int) -> SortedTable:
    """Drop k-mers with count < min_count (the minimal error-fix pass — see
    engine.error_fix).  Flush first (move semantics)."""
    if t.buf_n:
        raise ValueError("prune requires a flushed table")
    h, c = _prune_impl(t.hashes, t.counts, jnp.uint32(min_count))
    return SortedTable(h, c, t.buf, t.bufw, 0, t.spilled)


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _prune_rescue_impl(hashes, counts, occ_h, occ_c, max_count, min_reads):
    idx = jnp.searchsorted(occ_h, hashes)
    idx_c = jnp.minimum(idx, jnp.maximum(occ_h.shape[0] - 1, 0))
    occ = jnp.where((hashes != _U64MAX) & (occ_h[idx_c] == hashes),
                    occ_c[idx_c], 0)
    keep = (counts > max_count) | ((counts > 0) & (occ >= min_reads))
    n_rescued = jnp.sum(keep & (counts <= max_count) & (counts > 0))
    h = jnp.where(keep, hashes, _U64MAX)
    c = jnp.where(keep, counts, 0)
    h, c = jax.lax.sort((h, c), dimension=0, num_keys=1)
    return h, c, n_rescued


def prune_rescue(t: SortedTable, occ_h, occ_c, max_count: int,
                 min_reads: int) -> Tuple[SortedTable, int]:
    """Error-band prune with occurrence-context rescue (engine.error_fix):
    drop k-mers with count <= max_count UNLESS their raw occurrence count
    (``occ_h``/``occ_c``, sorted) is >= min_reads.  Returns (table,
    n_rescued).  Flush first (move semantics)."""
    if t.buf_n:
        raise ValueError("prune_rescue requires a flushed table")
    if np.asarray(occ_h).shape[0] == 0:  # nothing can be rescued
        return prune(t, max_count + 1), 0
    h, c, n_resc = _prune_rescue_impl(
        t.hashes, t.counts, jnp.asarray(occ_h, jnp.uint64),
        jnp.asarray(occ_c, jnp.uint32), jnp.uint32(max_count),
        jnp.uint32(min_reads))
    return (SortedTable(h, c, t.buf, t.bufw, 0, t.spilled),
            int(np.asarray(n_resc)))


@jax.jit
def lookup_ids(hashes: jnp.ndarray, queries: jnp.ndarray
               ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Vectorized binary search: queries -> (position int32, found bool)."""
    idx = jnp.searchsorted(hashes, queries)
    idx_c = jnp.minimum(idx, hashes.shape[0] - 1)
    found = (queries != _U64MAX) & (hashes[idx_c] == queries)
    return jnp.where(found, idx_c, -1).astype(jnp.int32), found
