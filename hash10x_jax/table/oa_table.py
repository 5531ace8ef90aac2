"""Open-addressing k-mer count table in device memory — the replacement for the
reference's chained hash table (``hash10x.c:~fillHashTable``, SURVEY.md §3.1 #5;
BASELINE.json mandate: "chained hash table → sharded open-addressing table in HBM").

Design (single device; ``dist/sharded_table.py`` wraps this per shard):

* ``keys (S,) uint64`` with S = 2^bits; the sentinel U64MAX marks an empty slot
  (canonical seqhash values occupy at most 2k <= 62 bits, so U64MAX never collides).
* ``counts (S,) uint32`` — barcode/occurrence counts per resident k-mer.
* Insertion is batched and **deterministic**: the batch is pre-aggregated
  (sort + segment-sum, so in-batch keys are unique), then a bounded linear-probe
  loop runs; empty slots are claimed by scatter-min over the key array, so when
  several distinct keys probe one empty slot the smallest key wins — a fixed rule
  independent of batch order.  Losers and key-mismatches advance one slot (linear
  probing, wrap-around) next round.
* Overflow (keys still unplaced after ``max_probes`` rounds) is counted and
  surfaced, never silently dropped (SURVEY.md §8.3 — silent drops would break
  oracle equality).

All ops are XLA scatters/gathers with static shapes; no host round-trips.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..hashspec import U64MAX

__all__ = ["KmerTable", "make_table", "pre_aggregate", "insert", "lookup",
           "count_histogram", "compact"]

# numpy scalar, NOT jnp: a module-level jnp array would initialize the
# backend at import; np scalars lower as literals
_U64MAX = np.uint64(U64MAX)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class KmerTable:
    """Device-resident open-addressing table (pytree: jit/scan/shard-friendly)."""

    keys: jnp.ndarray     # (S,) uint64, U64MAX = empty
    counts: jnp.ndarray   # (S,) uint32
    overflow: jnp.ndarray  # () uint32 — keys dropped due to probe exhaustion

    def tree_flatten(self):
        return (self.keys, self.counts, self.overflow), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def n_slots(self) -> int:
        return self.keys.shape[0]

    @property
    def n_filled(self) -> jnp.ndarray:
        return jnp.sum(self.keys != _U64MAX)


def make_table(bits: int) -> KmerTable:
    """Fresh table with 2^bits slots (the reference's ``--tableBits B``)."""
    s = 1 << bits
    return KmerTable(
        keys=jnp.full((s,), _U64MAX, jnp.uint64),
        counts=jnp.zeros((s,), jnp.uint32),
        overflow=jnp.zeros((), jnp.uint32),
    )


@jax.jit
def pre_aggregate(hashes: jnp.ndarray, weights: jnp.ndarray
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Sort a padded hash vector and sum weights of equal keys.

    Input: ``hashes (N,) uint64`` with U64MAX padding, ``weights (N,) uint32``.
    Output: same-shape (unique_hashes, summed_weights) where each distinct key
    appears once (at its first sorted slot) and duplicates become U64MAX / 0.
    """
    order = jnp.argsort(hashes)
    h = hashes[order]
    w = weights[order].astype(jnp.uint32)
    is_first = jnp.concatenate([jnp.ones((1,), bool), h[1:] != h[:-1]])
    # Segment-sum: scatter each weight onto its segment's rank, then read back the
    # segment total at every element; first elements carry their segment's sum.
    seg_id = jnp.cumsum(is_first.astype(jnp.int32)) - 1
    seg_total = jnp.zeros_like(w).at[seg_id].add(w)
    uniq_h = jnp.where(is_first, h, _U64MAX)
    uniq_w = jnp.where(is_first & (h != _U64MAX), seg_total[seg_id], 0).astype(jnp.uint32)
    return uniq_h, uniq_w


@functools.partial(jax.jit, static_argnames=("max_probes", "slot_shift"),
                   donate_argnums=0)
def insert(table: KmerTable, hashes: jnp.ndarray, weights: jnp.ndarray,
           max_probes: int = 128, slot_shift: int = 0) -> KmerTable:
    """Scatter a batch of (hash, weight) into the table.

    ``hashes (N,) uint64`` (U64MAX entries ignored), ``weights (N,)`` any int dtype.
    Deterministic regardless of batch ordering (see module docstring).
    ``slot_shift``: in a table sharded by the hash's low bits (dist/), those bits
    are constant within a shard — shift them off before slotting so occupancy
    stays uniform.
    """
    h, w = pre_aggregate(hashes, weights)
    mask = jnp.uint64(table.n_slots - 1)
    slot0 = ((h >> jnp.uint64(slot_shift)) & mask).astype(jnp.int64)
    n = jnp.int64(table.n_slots)

    def cond(state):
        _, _, pending, r = state
        return jnp.any(pending) & (r < max_probes)

    def body(state):
        keys, counts, pending, r = state
        slot = ((slot0 + r) % n).astype(jnp.int32)
        probe_key = jnp.where(pending, h, _U64MAX)
        cur = keys[slot]
        empty = (cur == _U64MAX) & pending
        # Claim empty slots: smallest contending key wins (scatter-min).
        keys = keys.at[slot].min(jnp.where(empty, probe_key, _U64MAX))
        placed = pending & (keys[slot] == h)
        counts = counts.at[slot].add(jnp.where(placed, w, 0).astype(jnp.uint32))
        return keys, counts, pending & ~placed, r + 1

    pending0 = (h != _U64MAX) & (w > 0)
    keys, counts, pending, _ = jax.lax.while_loop(
        cond, body, (table.keys, table.counts, pending0, jnp.int64(0)))
    overflow = table.overflow + jnp.sum(pending).astype(jnp.uint32)
    return KmerTable(keys, counts, overflow)


@functools.partial(jax.jit, static_argnames=("max_probes", "slot_shift"))
def lookup(table: KmerTable, hashes: jnp.ndarray, max_probes: int = 128,
           slot_shift: int = 0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Find each hash: returns (slot (N,) int32, found (N,) bool).

    Missing keys (probe hit an empty slot, or exhausted) get slot = -1.
    """
    mask = jnp.uint64(table.n_slots - 1)
    slot0 = ((hashes >> jnp.uint64(slot_shift)) & mask).astype(jnp.int64)
    n = jnp.int64(table.n_slots)
    valid = hashes != _U64MAX

    def cond(state):
        pending, _, r = state
        return jnp.any(pending) & (r < max_probes)

    def body(state):
        pending, result, r = state
        slot = ((slot0 + r) % n).astype(jnp.int32)
        cur = table.keys[slot]
        found = pending & (cur == hashes)
        miss = pending & (cur == _U64MAX)          # empty slot => key absent
        result = jnp.where(found, slot, result)
        return pending & ~found & ~miss, result, r + 1

    pending, result, _ = jax.lax.while_loop(
        cond, body, (valid, jnp.full(hashes.shape, -1, jnp.int32), jnp.int64(0)))
    return result, result >= 0


@functools.partial(jax.jit, static_argnames=("max_count",))
def count_histogram(table: KmerTable, max_count: int = 256) -> jnp.ndarray:
    """Histogram of per-k-mer counts (the reference's ``--hashDist``, SURVEY.md
    §3.1 #7): hist[c] = number of distinct k-mers with count c (c clipped to
    max_count; hist[0] unused)."""
    resident = table.keys != _U64MAX
    c = jnp.clip(table.counts, 0, max_count).astype(jnp.int32)
    return jnp.zeros((max_count + 1,), jnp.int64).at[jnp.where(resident, c, 0)].add(
        resident.astype(jnp.int64)).at[0].set(0)


def compact(table: KmerTable, min_count: int = 0, max_count: int = 0
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract resident (hash, count) pairs sorted by hash, optionally count-band
    filtered (the reference's "good k-mer" band, SURVEY.md §3.1 #5).  Sorted-hash
    rank is the framework's canonical k-mer id: deterministic under any insertion
    or shard order.  Returns host numpy arrays (hashes u64, counts u32)."""
    keys = np.asarray(table.keys)
    counts = np.asarray(table.counts)
    keep = keys != U64MAX
    if min_count:
        keep &= counts >= min_count
    if max_count:
        keep &= counts <= max_count
    h = keys[keep]
    c = counts[keep]
    order = np.argsort(h, kind="stable")
    return h[order], c[order]
