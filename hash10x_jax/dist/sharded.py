"""Multi-chip sharded pipeline: DP read streams + hash-sharded table + collectives.

The distributed design mandated by BASELINE.json and SURVEY.md §3.2/§4.5, absent
from the single-process reference:

* **Data parallelism** — the read batch axis is sharded over the mesh axis ``d``;
  every chip sketches its own read shard.
* **Table sharding (TP/EP analog)** — the k-mer table is range-partitioned by the
  hash's low ``log2(n)`` bits (deterministic "expert routing": ``shard = hash & n-1``);
  each device owns one open-addressing shard in its memory, slotting by the remaining
  bits (``slot_shift``) so occupancy stays uniform.
* **Ragged all_to_all routing** — each chip buckets its emissions by owner shard
  into fixed-capacity send lanes (static shapes; lane overflow is *counted*, never
  silent — SURVEY.md §8.3) and one ``jax.lax.all_to_all`` delivers them.
* **Collective merges** — histograms/stats merge with ``psum`` (BASELINE.json:
  "per-shard count tables ... merge via psum/all-gather collectives").

Everything lives inside one ``shard_map`` so XLA sees a single fused program per
count step.  The same step runs on any mesh size, including a 1-device mesh
(identical results to the single-device engine — tested).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..hashspec import HashSpec, U64MAX
from ..core import seqhash_jnp
from ..table import oa_table as oat

__all__ = ["ShardedTable", "make_mesh", "make_count_step", "merged_histogram",
           "gather_compact"]

# numpy scalar, NOT jnp: a module-level jnp array would initialize the
# backend at import; np scalars lower as literals
_U64MAX = np.uint64(U64MAX)


def make_mesh(n_devices: int = 0) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if len(devs) < n:
        raise ValueError(f"need {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), ("d",))


class ShardedTable:
    """Per-shard open-addressing tables as one device-sharded KmerTable whose
    leading axis is the shard id (keys (n, S) etc.), plus routing drop counters."""

    def __init__(self, mesh: Mesh, bits_per_shard: int):
        self.mesh = mesh
        self.n_shards = mesh.devices.size
        self.shard_bits = int(self.n_shards - 1).bit_length()
        if (1 << self.shard_bits) != self.n_shards:
            raise ValueError("mesh size must be a power of two")
        self.bits_per_shard = bits_per_shard
        s = 1 << bits_per_shard
        sh = NamedSharding(mesh, P("d"))
        self.keys = jax.device_put(
            jnp.full((self.n_shards, s), _U64MAX, jnp.uint64), sh)
        self.counts = jax.device_put(jnp.zeros((self.n_shards, s), jnp.uint32), sh)
        self.overflow = jax.device_put(jnp.zeros((self.n_shards,), jnp.uint32), sh)
        self.route_drops = jax.device_put(jnp.zeros((self.n_shards,), jnp.uint32), sh)

    @property
    def n_filled(self):
        return int(jnp.sum(self.keys != _U64MAX))


def make_count_step(spec: HashSpec, mesh: Mesh, mode: str = "minimizer",
                    modulus: int = 0, lane_capacity: int = 0,
                    count_mode: str = "occurrences", max_probes: int = 128):
    """Build the jitted sharded count step.

    Returns step(keys, counts, overflow, drops, codes, lengths, bcs) -> updated
    (keys, counts, overflow, drops).  ``codes (B, L)`` is globally sharded on B
    over the mesh; per-device emissions are routed to owner shards and inserted.
    ``lane_capacity``: per-destination send-lane size; 0 => auto (4x fair share).
    """
    n = mesh.devices.size
    shard_bits = int(n - 1).bit_length()
    shard_mask = jnp.uint64(n - 1)

    if count_mode != "occurrences":
        # pre-routing (hash,barcode) dedup would miscount barcodes whose reads
        # are DP-split across devices; the exact owner-side dedup lives in
        # dist/sharded_sorted.make_sorted_count_step (the production path)
        raise NotImplementedError(
            "count_mode='barcodes' on the open-addressing shard path: use "
            "dist.sharded_sorted.make_sorted_count_step")

    def local_sketch(codes, lengths, bcs):
        h, _, emit = seqhash_jnp.sketch(spec, codes, lengths, mode=mode, m=modulus)
        flat_h = jnp.where(emit, h, _U64MAX).reshape(-1)
        w = (flat_h != _U64MAX).astype(jnp.uint32)
        return flat_h, w

    def step_body(keys, counts, overflow, drops, codes, lengths, bcs):
        # keys (1, S) block per device under shard_map; squeeze the shard axis.
        keys, counts = keys[0], counts[0]
        overflow, drops = overflow[0], drops[0]
        flat_h, w = local_sketch(codes, lengths, bcs)
        # pre-aggregate locally: fewer pairs cross the interconnect
        flat_h, w = oat.pre_aggregate(flat_h, w)

        # ---- bucket by destination shard into (n, cap) send lanes ----
        E = flat_h.shape[0]
        cap = lane_capacity or max(int(4 * E // max(n, 1)), 1)
        dest = jnp.where(flat_h != _U64MAX,
                         (flat_h & shard_mask).astype(jnp.int32), n)
        order = jnp.argsort(dest, stable=True)
        hs, ws, ds = flat_h[order], w[order], dest[order]
        pos_in_dest = jnp.arange(E, dtype=jnp.int32) - jnp.searchsorted(
            ds, ds, side="left").astype(jnp.int32)
        lane_ok = (ds < n) & (pos_in_dest < cap)
        # non-lane entries keep an out-of-bounds index so mode="drop" discards them
        send_h = jnp.full((n, cap), _U64MAX, jnp.uint64)
        send_w = jnp.zeros((n, cap), jnp.uint32)
        row = jnp.where(lane_ok, ds, n)
        send_h = send_h.at[row, pos_in_dest].set(hs, mode="drop")
        send_w = send_w.at[row, pos_in_dest].set(ws, mode="drop")
        # dropped *mass* (summed weights): keeps delivered + dropped == emitted
        n_dropped = jnp.sum(jnp.where((ds < n) & ~lane_ok, ws, 0)).astype(jnp.uint32)

        # ---- deliver ----
        if n > 1:
            recv_h = jax.lax.all_to_all(send_h, "d", split_axis=0, concat_axis=0,
                                        tiled=True)
            recv_w = jax.lax.all_to_all(send_w, "d", split_axis=0, concat_axis=0,
                                        tiled=True)
        else:
            recv_h, recv_w = send_h, send_w

        # ---- insert into the local shard (slot by the non-shard bits) ----
        table = oat.KmerTable(keys, counts, overflow)
        table = oat.insert(table, recv_h.reshape(-1), recv_w.reshape(-1),
                           max_probes=max_probes, slot_shift=shard_bits)
        return (table.keys[None], table.counts[None], table.overflow[None],
                (drops + n_dropped)[None])

    step = jax.jit(jax.shard_map(
        step_body, mesh=mesh,
        in_specs=(P("d"), P("d"), P("d"), P("d"), P("d"), P("d"), P("d")),
        out_specs=(P("d"), P("d"), P("d"), P("d")),
        check_vma=False),
        donate_argnums=(0, 1, 2, 3))

    def apply(st: ShardedTable, codes, lengths, bcs) -> ShardedTable:
        (st.keys, st.counts, st.overflow, st.route_drops) = step(
            st.keys, st.counts, st.overflow, st.route_drops,
            jnp.asarray(codes), jnp.asarray(lengths), jnp.asarray(bcs))
        return st

    apply.step = step
    return apply


def merged_histogram(st: ShardedTable, max_count: int = 256) -> np.ndarray:
    """psum-merged count histogram over all shards."""

    @functools.partial(jax.shard_map, mesh=st.mesh, in_specs=(P("d"), P("d")),
                       out_specs=P(), check_vma=False)
    def hist(keys, counts):
        t = oat.KmerTable(keys[0], counts[0], jnp.zeros((), jnp.uint32))
        h = oat.count_histogram(t, max_count)
        return jax.lax.psum(h, "d")

    return np.asarray(jax.jit(hist)(st.keys, st.counts))


def gather_compact(st: ShardedTable, min_count: int = 0, max_count: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-gather the global (hash, count) table, sorted by hash (canonical ids
    are global sorted ranks — shard-order independent)."""
    keys = np.asarray(st.keys).reshape(-1)
    counts = np.asarray(st.counts).reshape(-1)
    keep = keys != U64MAX
    if min_count:
        keep &= counts >= min_count
    if max_count:
        keep &= counts <= max_count
    h, c = keys[keep], counts[keep]
    order = np.argsort(h, kind="stable")
    return h[order], c[order]
