"""Sharded sorted-run count tables: the production multi-chip count path.

Same mesh design as ``sharded.py`` (DP read shards, one all_to_all of
owner-routed emissions, psum merges — SURVEY.md §3.2), but each shard's table
is the sort-centric ``table/sorted_table.py`` design rather than
open-addressing probing, and hashes route by
contiguous VALUE ranges of their 2k-bit space (``range_splitters``: equal
ranges for uniform emissions, CDF-inverted for minimizer minima): shard s
owns an ascending key range, so the per-shard sorted tables concatenate into
the globally sorted table with no re-sort, and canonical global k-mer ids
are shard-local ranks plus a shard offset — no host-side global sort at any
scale (distributed canonical ids).  Received lanes are appended to a
per-shard buffer; flushes run shard-parallel under the same mesh.

Also provides the sharded-table snapshot/restore of SURVEY.md §6
(checkpoint/resume row): per-shard (hash, count) arrays + a json manifest
holding the HashSpec, routing rule, and shard map; reload is mesh-shape-
portable (keys re-route under the target mesh size).
"""

from __future__ import annotations

import functools
import json
import os
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..hashspec import HashSpec, U64MAX
from ..core import seqhash_jnp
from ..core.encode import unpack_2bit_jnp
from ..table import sorted_table as st

__all__ = ["ShardedSortedTable", "make_sorted_count_step", "sorted_histogram",
           "gather_sorted_compact", "save_snapshot", "load_snapshot",
           "range_splitters", "emit_dist_eff"]

# numpy scalar, NOT jnp: a module-level jnp array would initialize the
# backend at import; np scalars lower as literals
_U64MAX = np.uint64(U64MAX)


class LaneOverflowError(RuntimeError):
    """A routing send lane overflowed its expected-load size (pathological
    skew).  ``auto_cap`` carries the lane size that overflowed — the doubling
    base for the engine's auto-retry."""

    def __init__(self, msg: str, auto_cap: int = 0):
        super().__init__(msg)
        self.auto_cap = int(auto_cap)


def range_splitters(spec: HashSpec, n: int, eff: int = 1) -> np.ndarray:
    """n-1 ascending u64 splitters partitioning the 2k-bit hash value range
    into n contiguous shard ranges of ~equal EMITTED mass.

    eff = 1: emitted hashes are uniform over the range (kmer / modimizer /
    syncmer modes — the mix is pseudorandom and those samplers don't select
    on the k-mer hash value).  eff = w+1 (minimizer mode): emitted hashes are
    window MINIMA, CDF(v) ~= 1 - (1 - v/M)^(w+1), so equal-bit ranges would
    send ~88% of keys to shard 0 (measured); inverting the CDF at s/n gives
    splitters within ~1.25x of ideal balance on real lanes — deterministic,
    input-independent, snapshot-portable."""
    M = 1 << (64 - spec.shift1)
    if eff <= 1:
        return np.array([(M * s) // n for s in range(1, n)], np.uint64)
    return np.array([int(M * (1.0 - (1.0 - s / n) ** (1.0 / eff)))
                     for s in range(1, n)], np.uint64)


def emit_dist_eff(spec: HashSpec, mode: str) -> int:
    """The emitted-hash distribution exponent for range_splitters."""
    return spec.w + 1 if (mode == "minimizer" and spec.w > 1) else 1


class ShardedSortedTable:
    """Per-shard sorted tables as (n, C)/(n, Bc) device-sharded arrays.

    routing="range" (default): shard s owns the contiguous ascending key
    range [splitter_{s-1}, splitter_s) (splitters from ``range_splitters``),
    so the per-shard sorted tables concatenate into the GLOBALLY sorted table
    with no re-sort, and a key's canonical global rank is shard_offset[s] +
    local rank (the distributed-canonical-ids property).  routing="low":
    shard = key & (n-1) — for key spaces with no usable range structure
    (incidence pair keys are code-major).

    The buffer is WEIGHTED ((buf, bufw) (key, multiplicity) pairs, like
    ``table/sorted_table.py``): the count step pre-reduces each batch's
    receipts at the owner shard, so buffered entries are ~n_distinct rather
    than ~n_emissions — flush merge-sort volume shrinks by the pad +
    multiplicity ratio, as on the single-device path.

    ``fill_bound``/``pending_nreal`` track a host-side occupancy upper bound
    with an async exact refresh for fill-proportional SLICED flushes
    (``flush_sliced_sharded``), mirroring the single-device engine's
    _flush_any discipline: no per-flush host sync, sort volume ∝ fill."""

    def __init__(self, mesh: Mesh, capacity: int, buf_capacity: int,
                 spec: Optional[HashSpec] = None, routing: str = "range",
                 range_eff: Optional[int] = None):
        self.mesh = mesh
        self.spec = spec
        self.routing = routing
        # None = adopt the first count step's emitted-distribution exponent
        self.range_eff = range_eff
        self.n_shards = mesh.devices.size
        self.shard_bits = int(self.n_shards - 1).bit_length()
        if (1 << self.shard_bits) != self.n_shards:
            raise ValueError("mesh size must be a power of two")
        self.capacity = capacity
        self.buf_capacity = buf_capacity
        sh = NamedSharding(mesh, P("d"))
        n = self.n_shards
        self.hashes = jax.device_put(
            jnp.full((n, capacity), _U64MAX, jnp.uint64), sh)
        self.counts = jax.device_put(jnp.zeros((n, capacity), jnp.uint32), sh)
        self.buf = jax.device_put(
            jnp.full((n, buf_capacity), _U64MAX, jnp.uint64), sh)
        self.bufw = jax.device_put(
            jnp.zeros((n, buf_capacity), jnp.uint32), sh)
        self.buf_n = 0
        self.fill_bound = 0           # host upper bound on per-shard fill
        self.pending_nreal = None     # async exact max-fill scalar (device)
        self.spilled = jax.device_put(jnp.zeros((n,), jnp.uint32), sh)
        self.route_drops = jax.device_put(jnp.zeros((n,), jnp.uint32), sh)

    @property
    def n_filled(self) -> int:
        return int(jnp.sum(self.hashes != _U64MAX))


@functools.partial(jax.jit, static_argnames=("cap",), donate_argnums=(0, 1))
def _grow_rows(hashes, counts, cap: int):
    """Pad-concat per-shard capacity growth (columns; rows stay sharded)."""
    n, c = hashes.shape
    return (jnp.concatenate(
                [hashes, jnp.full((n, cap - c), _U64MAX, jnp.uint64)], axis=1),
            jnp.concatenate(
                [counts, jnp.zeros((n, cap - c), jnp.uint32)], axis=1))


_FLUSH_SLICED_CACHE = {}


def _make_flush_sliced(mesh: Mesh, b1: int, b2: int):
    """Shard-parallel fill-proportional flush: each shard merges only its
    first ``b1`` table slots (>= every shard's true fill — ascending with
    U64MAX pads, so all real keys live there) with its first ``b2`` buffer
    slots, exactly ``st._merge_sliced`` per row.  Returns the per-shard
    tables plus the REPLICATED max new fill as a device scalar for the
    caller's async bound refresh.  Never spills: callers grow capacity by
    pad-concat first when b1 + b2 > capacity."""
    key = (mesh, b1, b2)  # Mesh is hashable; id() could alias after gc
    fn = _FLUSH_SLICED_CACHE.get(key)
    if fn is not None:
        return fn

    # n_real returns PER SHARD (P("d")); the caller maxes on host at consume
    # time, which works on every backend (a lax.pmax here would return the
    # max replicated instead: ROADMAP R1)
    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(P("d"), P("d"), P("d"), P("d")),
                       out_specs=(P("d"), P("d"), P("d"), P("d"), P("d")),
                       check_vma=False)
    def flush_body(hashes, counts, buf, bufw):
        h, c, n_real = st._merge_sliced.__wrapped__(
            hashes[0], counts[0], buf[0], bufw[0], b1, b2)
        fresh = jnp.full(buf.shape[1:], _U64MAX, jnp.uint64)
        freshw = jnp.zeros(bufw.shape[1:], jnp.uint32)
        return (h[None], c[None], fresh[None], freshw[None], n_real[None])

    fn = jax.jit(flush_body, donate_argnums=(0, 1, 2, 3))
    _FLUSH_SLICED_CACHE[key] = fn
    return fn


def flush_sliced_sharded(t: ShardedSortedTable) -> ShardedSortedTable:
    """Flush the weighted buffer without blocking: consume the previous
    flush's async exact max-fill if it landed, slice the merge to
    pow2(bound) + pow2(buf_n), grow capacity by pad-concat when the merged
    run would not fit (never spills), and leave the new exact fill as an
    async device scalar for the NEXT flush (the sharded port of the
    engine's _flush_any)."""
    if t.buf_n == 0:
        return t
    if t.pending_nreal is not None:
        # per-shard (n,) fills; the bound is the max.  Multi-process meshes:
        # the array may not be fully addressable — every process sees its
        # own shards' fills, so allgather the max (uniform across processes)
        p = t.pending_nreal
        if not getattr(p, "is_fully_addressable", True):
            rep = NamedSharding(t.mesh, P())
            p = jax.jit(lambda x: jnp.max(x), out_shardings=rep)(p)
        t.fill_bound = int(np.asarray(p).max())
        t.pending_nreal = None
    b1 = min(st._pow2ceil(max(t.fill_bound, 1)), t.capacity)
    b2 = min(st._pow2ceil(t.buf_n), t.buf_capacity)
    if b1 + b2 > t.capacity:
        new_cap = st._pow2ceil(b1 + b2)
        t.hashes, t.counts = _grow_rows(t.hashes, t.counts, new_cap)
        t.capacity = new_cap
    fn = _make_flush_sliced(t.mesh, b1, b2)
    t.hashes, t.counts, t.buf, t.bufw, n_real = fn(
        t.hashes, t.counts, t.buf, t.bufw)
    try:
        n_real.copy_to_host_async()
    except AttributeError:
        pass
    t.pending_nreal = n_real
    t.fill_bound = t.fill_bound + t.buf_n
    t.buf_n = 0
    return t


def code_range_bounds(n_codes: int, n: int) -> np.ndarray:
    """(n+1,) code boundaries partitioning [0, n_codes) into n ~equal ranges
    — the pair-key shard map (shard s owns codes [b[s], b[s+1]))."""
    return np.array([(n_codes * s) // n for s in range(n + 1)], np.int64)


def make_sorted_count_step(spec: HashSpec, mesh: Mesh, mode: str = "minimizer",
                           modulus: int = 0, lane_capacity: int = 0,
                           packed_read_len: int = 0,
                           count_mode: str = "occurrences",
                           emission_cap_factor: int = 4, syncmer_s: int = 0,
                           pair_retained=None, pair_retained_sharded=None):
    """Sharded count step over sorted tables.

    Returns ``step(table, codes, lengths, bcs, nmask=None) -> table`` where
    codes (B, L) — or 2-bit packed (B, W) rows when ``packed_read_len`` is set —
    is batch-sharded over the mesh.  Each device sketches (packing its
    batch's emissions, ``seqhash_jnp.sketch_emitted``), buckets emissions by
    owner shard, one all_to_all delivers them, and the receiver appends to
    its buffer (flushing shard-parallel when full).  Counts match the
    single-device path and oracle for every input (never-silent contract,
    SURVEY.md §8.3).

    count_mode="barcodes": (hash, barcode) pairs are routed together and
    deduplicated *at the owner shard* — exact even when a barcode's reads are
    split across devices (local pre-routing dedup would undercount there);
    exactness across batches relies on barcode-aligned batching (engine).

    pair_retained: the sorted retained-hash array (U64MAX pads tolerated) —
    the step then builds the INCIDENCE PAIR SET ``code * n_kmers +
    rank(hash)`` (the second pass of SURVEY.md §3.1 #6, distributed) in two
    hops: (1) raw (hash, barcode) emissions route to the hash's range-owner
    shard, which holds only ITS slice of the retained set (never replicated —
    the pod-scale requirement) and maps hash -> canonical global rank as
    local rank + shard offset; (2) the pair keys route by their low bits to
    dedup owners, whose LSM flushes dedup them; ``gather_sorted_compact``
    returns the globally sorted unique pair set that
    ``incidence_from_sorted_pairs`` consumes.  Implies pair-key occurrence
    semantics (the dedup IS the goal; weights are discarded).

    pair_retained_sharded: ``(rows, offsets, n_kmers)`` — the retained set
    ALREADY sharded by the count table's value ranges (rows (n, R_pad) u64
    device-sharded ascending slices with U64MAX pads, offsets (n,) int64
    global rank of each shard's first key, n_kmers total) — the zero-gather
    path from a sharded filter (engine keeps the table device-resident end to
    end).  Mutually exclusive with pair_retained.
    """
    n = mesh.devices.size
    # H10X_FORCE_ROUTING=1: run the n>1 routing code (dest handling, lanes,
    # identity all_to_all) even at n=1 — a measurement knob that isolates the
    # per-batch routing-machinery cost from multi-device contention on a
    # single card (bench.py routing_ab point)
    force_routing = os.environ.get("H10X_FORCE_ROUTING") == "1"
    uni = (n == 1) and not force_routing  # identity-routing specialization
    # hash values span 2k bits (hashspec: (x*factor1 mod 2^64) >> (64-2k));
    # route by contiguous VALUE ranges (splitters matched to the emitted-hash
    # distribution) so shard s owns an ascending range — gather is then a
    # concat and global ranks are shard-local ranks plus an offset
    # (distributed canonical ids).  Pair keys (code-major, no usable range
    # structure) route by LOW bits instead.
    if pair_retained is not None and pair_retained_sharded is not None:
        raise ValueError("pass pair_retained OR pair_retained_sharded")
    pair = pair_retained is not None or pair_retained_sharded is not None
    # Pair keys route by LOW bits during streaming — batches are
    # barcode-sorted, so code-range routing here would hot-spot one owner
    # per batch while every other shard buffers pads; low bits keep the
    # stream balanced.  dist/sharded_inc.build_sharded_incidence then
    # redistributes the finished runs into code-aligned CSR slices with ONE
    # all_to_all round (O(n_pairs/n) per shard).
    routing = "low" if pair else "range"
    range_eff = emit_dist_eff(spec, mode)
    splitters_d = jnp.asarray(range_splitters(spec, n, range_eff))
    shard_mask = jnp.uint64(n - 1)

    # range routing is MONOTONE in the key (dest = #splitters <= key), so a
    # key-sorted array is already dest-sorted and lane boundaries fall out of
    # one searchsorted against the splitters — no separate (dest, key) sort
    # per batch (the key sort doubles as the
    # pre-reduction / pad-strip sort).  U64MAX pads exceed every real hash
    # value (hashes span < 64 bits), landing past bounds[-1] = U64MAX.
    def range_starts(hs):
        bounds = jnp.concatenate(
            [splitters_d, jnp.asarray([_U64MAX], jnp.uint64)])
        return jnp.concatenate(
            [jnp.zeros((1,), jnp.int32),
             jnp.searchsorted(hs, bounds).astype(jnp.int32)])

    retained_rows = retained_off = None
    if pair_retained_sharded is not None:
        retained_rows, r_off_np, n_ret = pair_retained_sharded
        n_kmers_u = jnp.uint64(max(int(n_ret), 1))
        retained_off = jax.device_put(
            jnp.asarray(np.asarray(r_off_np, np.int64)),
            NamedSharding(mesh, P("d")))
    elif pair_retained is not None:
        # Shard the retained set by the SAME value-range splitters as the
        # count table: each hash's range-owner holds its slice of the sorted
        # retained array, whose local rank + shard offset IS the canonical
        # global k-mer id — the retained set is never replicated (the
        # pod-scale requirement; a 1B-kmer set is GBs).
        ret = np.asarray(pair_retained)
        ret = ret[ret != U64MAX]  # accept padded or raw
        n_kmers_u = jnp.uint64(max(len(ret), 1))
        r_dest = np.searchsorted(range_splitters(spec, n, range_eff), ret,
                                 side="right")
        r_counts = np.bincount(r_dest, minlength=n)
        r_off = np.concatenate([[0], np.cumsum(r_counts)])[:-1]
        # pad slices to a common power of two so retained sizes bucket into
        # few distinct compiles (U64MAX pads never match real queries)
        R_pad = 1 << max(int(max(int(r_counts.max(initial=0)), 1) - 1
                             ).bit_length(), 8)
        rows = np.full((n, R_pad), U64MAX, np.uint64)
        for s_ in range(n):
            rows[s_, :r_counts[s_]] = ret[r_dest == s_]  # ascending slices
        sh_d = NamedSharding(mesh, P("d"))
        retained_rows = jax.device_put(jnp.asarray(rows), sh_d)
        retained_off = jax.device_put(
            jnp.asarray(np.asarray(r_off, np.int64)), sh_d)

    def compact_to(Pp: int) -> int:
        """Emission slots per read (the plain engine's _compact_rows)."""
        return seqhash_jnp.compact_width(spec, Pp, mode, modulus, syncmer_s,
                                         emission_cap_factor)

    def emissions_of(codes, lengths, bcs, nmask):
        """-> (flat_h, flat_bc, cap_overflow), the device's batch packed
        into ``compact_to`` slots per read; ``codes`` are 2-bit packed rows
        when ``packed_read_len`` is set."""
        with jax.named_scope("sketch"):
            if packed_read_len:
                codes = unpack_2bit_jnp(codes, packed_read_len, nmask)
            flat, read, over = seqhash_jnp.sketch_emitted(
                spec, codes, lengths, mode=mode, m=modulus,
                syncmer_s=syncmer_s,
                compact_to=compact_to(codes.shape[1] - spec.k + 1))
        return flat, bcs[read], over

    def lane_cap(E):
        """Send-lane slots per destination for E emissions on this device.
        Routing is ~uniform (CDF-matched range splitters / low bits), so
        expected per-dest load is E/n; 2x headroom + slack covers skew, and
        overflow is counted exactly and raises — never silent.  Worst-case
        4E/n lanes would make received pads (hence LSM flush volume) grow
        with the mesh size.

        TRADEOFF (deliberate): expected-load sizing means a pathologically
        skewed batch (one hash value or barcode dominating) that FIT under
        worst-case lanes can now overflow — a loud, data-dependent
        RuntimeError at scale rather than a silent drop.  ``lane_capacity``
        (CLI ``--laneCapacity``) overrides the auto size for such lanes; the
        error message names it."""
        if lane_capacity:
            return lane_capacity
        if n == 1:
            return max(int(E), 8)  # single lane: exact, no pads, no drops
        return max(min(int(E), int(2 * E // n + 4096)), 8)

    def to_lanes(starts, payloads_pads, cap):
        """Dest-sorted payload arrays -> per-dest (n, cap) lane stacks +
        dropped count.  ``starts`` is the (n+1,) int32 per-dest segment
        boundary vector (from ``range_starts`` for range routing, or a
        searchsorted over the dest vector for low-bit routing); contiguous
        per-dest segments become lanes via static slices (no argsort,
        gathers or (row, pos) scatter).  ``payloads_pads`` = [(array, pad)]."""
        lane_idx = jnp.arange(cap, dtype=jnp.int32)
        padded = [jnp.concatenate([x, jnp.full((cap,), pv, x.dtype)])
                  for x, pv in payloads_pads]
        outs = [[] for _ in payloads_pads]
        dropped = jnp.uint32(0)
        for r in range(n):
            seg_len = starts[r + 1] - starts[r]
            for i, (xp, (_, pv)) in enumerate(zip(padded, payloads_pads)):
                lane = jax.lax.dynamic_slice(xp, (starts[r],), (cap,))
                outs[i].append(jnp.where(lane_idx < seg_len, lane, pv))
            dropped += jnp.maximum(seg_len - cap, 0).astype(jnp.uint32)
        return [jnp.stack(o) for o in outs], dropped

    def a2a(x):
        if n > 1:
            return jax.lax.all_to_all(x, "d", split_axis=0, concat_axis=0,
                                      tiled=True)
        return x

    def expected_per_read(Pp: int) -> int:
        """Expected emissions per read position window (see compact_width)."""
        if mode == "minimizer" and spec.w > 1:
            return 2 * Pp // (spec.w + 1) + 1
        if mode == "modimizer":
            return Pp // max(modulus or spec.w, 1) + 1
        if mode == "syncmer" and syncmer_s:
            return Pp // (spec.k - syncmer_s + 1) + 1
        return Pp

    def flat_per_read(Pp: int) -> int:
        return compact_to(Pp) or Pp

    def slots_recv(batch_reads: int, read_len: int) -> int:
        """Owner-side pre-reduction slots per shard per batch — the number
        of entries a batch APPENDS to each shard's weighted buffer.

        Each shard receives ~1/n of the global batch's real emissions
        (routing is balanced: CDF-matched splitters / low bits), i.e. about
        one device's emitted real count; distinct keys are fewer still.  2x
        that expectation + slack is far beyond any non-adversarial batch, and
        overflow is counted exactly and raises (never silent).  Buffering
        raw receipts instead (n * lane_cap slots, mostly pads) would make
        the flush merge-sort volume ~4-8x the data."""
        Pp = read_len - spec.k + 1
        per = max(batch_reads // n, 1)
        exp = per * expected_per_read(Pp)
        raw = n * lane_cap(per * flat_per_read(Pp))  # max receivable
        if pair:
            raw = n * lane_cap(raw)
        # n == 1: routing is the identity — the received set IS one device's
        # emissions, so the plain engine's 5/4 concentration bound applies;
        # n > 1 adds headroom for routing skew (splitters balance to ~1.25x)
        s = (exp + exp // 4 + 4096) if n == 1 else (2 * exp + 4096)
        return min(raw, ((s + 1023) // 1024) * 1024)

    def core(buf, bufw, drops, codes, lengths, bcs, offset, nmask, rrow,
             roffv, slots: int):
        """Per-shard, per-batch core: sketch -> route -> all_to_all ->
        owner-side pre-reduction -> weighted buffer write.  All arguments are
        shard-LOCAL (no leading shard axis); ``slots`` is the static dedup
        width (overflow exact, raises at finish)."""
        flat_h, flat_bc, cap_over = emissions_of(codes, lengths, bcs, nmask)
        E = flat_h.shape[0]
        cap = lane_cap(E)
        if pair:
            if uni:
                # single shard: routing is the identity on BOTH hops — no
                # dest sorts, no lanes, no drops (cap >= E exactly)
                rh, rb = flat_h, flat_bc.astype(jnp.int32)
                drop1 = drop2 = jnp.uint32(0)
            else:
                # hop 1: route (hash, barcode) to the hash's range-owner
                # shard — the hash sort IS the dest sort (range_starts)
                rh_s, rb_s = jax.lax.sort(
                    (flat_h, flat_bc.astype(jnp.int32)),
                    dimension=0, num_keys=1)
                (sh_l, sb_l), drop1 = to_lanes(
                    range_starts(rh_s), [(rh_s, _U64MAX), (rb_s, -1)], cap)
                rh = a2a(sh_l).reshape(-1)
                rb = a2a(sb_l).reshape(-1)
            # owner-side canonical rank: local slice rank + shard offset
            # (rank_join: one sort instead of ~log2(R) random gather passes
            # per batch, as on the plain path)
            from ..table.incidence import rank_join
            idx_c, found0 = rank_join(rrow, rh)
            found = found0 & (rh != _U64MAX) & (rb >= 0)
            rank = roffv.astype(jnp.uint64) + idx_c.astype(jnp.uint64)
            key = jnp.where(found,
                            rb.astype(jnp.uint64) * n_kmers_u + rank, _U64MAX)
            if n > 1 or force_routing:
                # hop 2: route pair keys to their low-bits owner for dedup
                # (code-major keys have no range structure; keep the dest
                # sort here)
                cap2 = lane_cap(key.shape[0])
                d2 = jnp.where(key != _U64MAX,
                               (key & shard_mask).astype(jnp.int32), n)
                ds2, ks2 = jax.lax.sort((d2, key), dimension=0, num_keys=1)
                starts2 = jnp.searchsorted(
                    ds2, jnp.arange(n + 1, dtype=jnp.int32)).astype(jnp.int32)
                (sk_l,), drop2 = to_lanes(starts2, [(ks2, _U64MAX)], cap2)
                key = a2a(sk_l).reshape(-1)
            uh, uw, over = st.dedup_weighted(key, slots)
            drops = drops + cap_over + drop1 + drop2 + over
        else:
            if count_mode == "barcodes":
                if uni:
                    # identity routing: feed emissions straight into the
                    # (hash, barcode) pre-reduction (its own sort suffices)
                    flat, fb = flat_h, flat_bc.astype(jnp.int32)
                    n_drop = jnp.uint32(0)
                else:
                    hs, bs = jax.lax.sort(
                        (flat_h, flat_bc.astype(jnp.int32)),
                        dimension=0, num_keys=1)
                    (send, send_bc), n_drop = to_lanes(
                        range_starts(hs), [(hs, _U64MAX), (bs, -1)], cap)
                    flat = a2a(send).reshape(-1)
                    fb = a2a(send_bc).reshape(-1)
                # owner-side (hash, barcode) pre-reduction: weight = distinct
                # barcodes of the hash in THIS batch — exact for barcodes
                # split across devices (they meet at the owner) and across
                # batches (barcode-aligned batching, engine contract)
                uh, uw, over = st.dedup_pairs_weighted(flat, fb, slots)
            elif uni:
                # single shard, occurrence counts: the plain engine's exact
                # discipline — ONE sort strips pads (weights are 1 per real
                # key; the LSM merge sums them), no routing machinery at all.
                # This is the whole difference between the 1-shard sharded
                # path and the plain hot path (3 sorts/batch -> 1).
                srt = jnp.sort(flat_h)
                over = jnp.sum(srt[slots:] != _U64MAX).astype(jnp.uint32)
                uh = srt[:slots]
                uw = (uh != _U64MAX).astype(jnp.uint32)
                n_drop = jnp.uint32(0)
            else:
                hs = jnp.sort(flat_h)
                (send,), n_drop = to_lanes(range_starts(hs),
                                           [(hs, _U64MAX)], cap)
                flat = a2a(send).reshape(-1)
                uh, uw, over = st.dedup_weighted(flat, slots)
            drops = drops + cap_over + n_drop + over
        buf = jax.lax.dynamic_update_slice(buf, uh, (jnp.int32(offset),))
        bufw = jax.lax.dynamic_update_slice(bufw, uw, (jnp.int32(offset),))
        return buf, bufw, drops

    # step variants keyed by (with_nmask, slots) — and for the scan-fused
    # variant also (S, per, chunk shape via retrace); traced lazily so unused
    # variants never compile
    _steps = {}

    def get_step(with_nmask: bool, slots: int):
        key = ("batch", with_nmask, slots)
        if key not in _steps:
            ret_specs = (P("d"), P("d")) if pair else ()

            def body(buf, bufw, drops, *args):
                if pair:
                    rrow, roffv = args[0][0], args[1][0]
                    args = args[2:]
                else:
                    rrow = roffv = None
                codes, lengths, bcs, offset = args[:4]
                nmask = args[4] if with_nmask else None
                b, w, dr = core(buf[0], bufw[0], drops[0], codes, lengths,
                                bcs, offset, nmask, rrow, roffv, slots)
                return b[None], w[None], dr[None]

            specs = (P("d"), P("d"), P("d")) + ret_specs + \
                (P("d"), P("d"), P("d"), P()) + \
                ((P("d"),) if with_nmask else ())
            _steps[key] = jax.jit(jax.shard_map(
                body, mesh=mesh, in_specs=specs,
                out_specs=(P("d"), P("d"), P("d")), check_vma=False),
                donate_argnums=(0, 1, 2))
        return _steps[key]

    def get_scan(S: int, per: int, with_nmask: bool, slots: int):
        """Scan-fused dispatch: S batches per jit, each carved from a
        device-resident chunk (REPLICATED across the mesh — single-host
        feeding; multi-process paths feed per-batch global arrays instead).
        One dispatch amortizes the per-dispatch host cost S-fold and lets
        XLA pipeline iterations."""
        key = ("scan", S, per, with_nmask, slots)
        if key not in _steps:
            ret_specs = (P("d"), P("d")) if pair else ()

            def body(buf, bufw, drops, *args):
                if pair:
                    rrow, roffv = args[0][0], args[1][0]
                    args = args[2:]
                else:
                    rrow = roffv = None
                if with_nmask:
                    dp, dl, dc, dnm, offs, ms, base = args
                else:
                    dp, dl, dc, offs, ms, base = args
                    dnm = None
                buf, bufw, drops = buf[0], bufw[0], drops[0]
                d_idx = jax.lax.axis_index("d")

                def it(carry, xs):
                    b, w, dr = carry
                    off, m, i = xs
                    start = off + d_idx * per
                    pk = jax.lax.dynamic_slice(
                        dp, (start, jnp.int32(0)), (per, dp.shape[1]))
                    ln = jax.lax.dynamic_slice(dl, (start,), (per,))
                    bc = jax.lax.dynamic_slice(dc, (start,), (per,))
                    rowid = d_idx * per + jnp.arange(per, dtype=jnp.int32)
                    ln = jnp.where(rowid < m, ln, 0)
                    bc = jnp.where(rowid < m, bc, -1)
                    nm = None
                    if dnm is not None:
                        nm = jax.lax.dynamic_slice(
                            dnm, (start, jnp.int32(0)), (per, dnm.shape[1]))
                        nm = jnp.where((rowid < m)[:, None], nm, 0)
                    b, w, dr = core(b, w, dr, pk, ln, bc,
                                    base + i * jnp.int32(slots), nm,
                                    rrow, roffv, slots)
                    return (b, w, dr), None

                (buf, bufw, drops), _ = jax.lax.scan(
                    it, (buf, bufw, drops),
                    (offs, ms, jnp.arange(S, dtype=jnp.int32)))
                return buf[None], bufw[None], drops[None]

            specs = (P("d"), P("d"), P("d")) + ret_specs + \
                (P(), P(), P()) + ((P(),) if with_nmask else ()) + \
                (P(), P(), P())
            _steps[key] = jax.jit(jax.shard_map(
                body, mesh=mesh, in_specs=specs,
                out_specs=(P("d"), P("d"), P("d")), check_vma=False),
                donate_argnums=(0, 1, 2))
        return _steps[key]

    def get_scan_stacked(S: int, perdev: int, with_nmask: bool, slots: int):
        """Scan-fused dispatch over a DEVICE-SHARDED stacked block: the
        feeder stacks S batches device-major into one global (S*batch_reads,
        ...) array (each device's slice holds its S per-batch row blocks,
        batch-ascending), so one dispatch + one host->device construction
        covers S batches — the multi-process analog of ``get_scan``'s
        replicated-chunk carve (which assumes single-host feeding).  Pad
        batches are all-zero rows (length 0, barcode -1): they emit only
        U64MAX keys and their buffer writes land past the caller's buf_n
        advance (overwritten or flush-sliced away)."""
        key = ("scanstk", S, perdev, with_nmask, slots)
        if key not in _steps:
            ret_specs = (P("d"), P("d")) if pair else ()

            def body(buf, bufw, drops, *args):
                if pair:
                    rrow, roffv = args[0][0], args[1][0]
                    args = args[2:]
                else:
                    rrow = roffv = None
                if with_nmask:
                    gp, gl, gc, gnm, base = args
                else:
                    gp, gl, gc, base = args
                    gnm = None
                buf, bufw, drops = buf[0], bufw[0], drops[0]

                def it(carry, i):
                    b, w, dr = carry
                    pk = jax.lax.dynamic_slice(
                        gp, (i * perdev, jnp.int32(0)), (perdev, gp.shape[1]))
                    ln = jax.lax.dynamic_slice(gl, (i * perdev,), (perdev,))
                    bc = jax.lax.dynamic_slice(gc, (i * perdev,), (perdev,))
                    nm = None
                    if gnm is not None:
                        nm = jax.lax.dynamic_slice(
                            gnm, (i * perdev, jnp.int32(0)),
                            (perdev, gnm.shape[1]))
                    b, w, dr = core(b, w, dr, pk, ln, bc,
                                    base + i * jnp.int32(slots), nm,
                                    rrow, roffv, slots)
                    return (b, w, dr), None

                (buf, bufw, drops), _ = jax.lax.scan(
                    it, (buf, bufw, drops), jnp.arange(S, dtype=jnp.int32))
                return buf[None], bufw[None], drops[None]

            specs = (P("d"), P("d"), P("d")) + ret_specs + \
                (P("d"), P("d"), P("d")) + ((P("d"),) if with_nmask else ()) \
                + (P(),)
            _steps[key] = jax.jit(jax.shard_map(
                body, mesh=mesh, in_specs=specs,
                out_specs=(P("d"), P("d"), P("d")), check_vma=False),
                donate_argnums=(0, 1, 2))
        return _steps[key]

    def scan_stacked(t: ShardedSortedTable, gp, gl, gc, gnm, S: int,
                     n_real: int) -> ShardedSortedTable:
        """Dispatch one device-major stacked block of S batches (``gp`` is
        the global (S*batch_reads, W) packed array, device-sharded; ``gnm``
        its N-mask or None; ``n_real`` <= S real batches — the rest are
        zero pads).  Only real batches advance buf_n."""
        _check_routing(t)
        bsz = gp.shape[0] // S
        L = packed_read_len or gp.shape[1]
        perdev = bsz // n
        slots = slots_recv(bsz, L)
        t = _room(t, S * slots)
        step_fn = get_scan_stacked(S, perdev, gnm is not None, slots)
        args = (t.buf, t.bufw, t.route_drops)
        if pair:
            args = args + (retained_rows, retained_off)
        args = args + (gp, gl, gc)
        if gnm is not None:
            args = args + (gnm,)
        args = args + (jnp.int32(t.buf_n),)
        (t.buf, t.bufw, t.route_drops) = step_fn(*args)
        t.buf_n += n_real * slots
        return t

    # entries appended to each shard's buffer per batch (engine buffer sizing)
    recv_width = slots_recv

    def _check_routing(t: ShardedSortedTable):
        if t.routing != routing:
            raise ValueError(f"table routing {t.routing!r} != step routing "
                             f"{routing!r}")
        if routing == "range":
            if t.range_eff is None:
                t.range_eff = range_eff
            elif t.range_eff != range_eff:
                raise ValueError(f"table range_eff {t.range_eff} != step "
                                 f"range_eff {range_eff}")

    def _room(t: ShardedSortedTable, need: int):
        if t.buf_n + need > t.buf_capacity:
            t = flush_sliced_sharded(t)
        if need > t.buf_capacity:
            new_cap = st._pow2ceil(need)
            n_sh, c = t.buf.shape
            t.buf = jnp.concatenate(
                [t.buf, jnp.full((n_sh, new_cap - c), _U64MAX, jnp.uint64)],
                axis=1)
            t.bufw = jnp.concatenate(
                [t.bufw, jnp.zeros((n_sh, new_cap - c), jnp.uint32)], axis=1)
            t.buf_capacity = new_cap
        return t

    def apply(t: ShardedSortedTable, codes, lengths, bcs,
              nmask=None) -> ShardedSortedTable:
        _check_routing(t)
        L = packed_read_len or codes.shape[1]
        slots = slots_recv(codes.shape[0], L)
        t = _room(t, slots)
        step_fn = get_step(nmask is not None, slots)
        args = (t.buf, t.bufw, t.route_drops)
        if pair:
            args = args + (retained_rows, retained_off)
        args = args + (jnp.asarray(codes), jnp.asarray(lengths),
                       jnp.asarray(bcs), jnp.int32(t.buf_n))
        if nmask is not None:
            args = args + (jnp.asarray(nmask),)
        (t.buf, t.bufw, t.route_drops) = step_fn(*args)
        t.buf_n += slots
        return t

    def scan_spans(t: ShardedSortedTable, dp, dl, dc, dnm, offs, ms,
                   batch_reads: int) -> ShardedSortedTable:
        """Dispatch one scan group of batches carved from a device-resident
        chunk (``dp``/``dl``/``dc``/``dnm`` as engine._chunks yields them;
        replicated across the mesh inside the jit).  ``offs``/``ms`` are the
        group's batch offsets and valid-row counts, zero-padded to the scan
        length S; only the REAL batches advance buf_n (pad iterations write
        all-pad dedup output past the advance point, overwritten by the next
        dispatch or discarded by the flush slice)."""
        _check_routing(t)
        S = len(offs)
        n_real = int(np.count_nonzero(np.asarray(ms)))
        L = packed_read_len or dp.shape[1]
        per = batch_reads // n
        slots = slots_recv(batch_reads, L)
        t = _room(t, S * slots)
        step_fn = get_scan(S, per, dnm is not None, slots)
        args = (t.buf, t.bufw, t.route_drops)
        if pair:
            args = args + (retained_rows, retained_off)
        args = args + (dp, dl, dc)
        if dnm is not None:
            args = args + (dnm,)
        args = args + (jnp.asarray(np.asarray(offs, np.int32)),
                       jnp.asarray(np.asarray(ms, np.int32)),
                       jnp.int32(t.buf_n))
        (t.buf, t.bufw, t.route_drops) = step_fn(*args)
        t.buf_n += n_real * slots
        return t

    def finish(t: ShardedSortedTable) -> ShardedSortedTable:
        return flush_sliced_sharded(t)

    def auto_lane_cap(batch_reads: int, read_len: int) -> int:
        """The auto send-lane size a batch of this shape gets — the doubling
        base for the engine's lane-overflow auto-retry (a skewed lane raises
        at finish; the retry recounts with 2x this per attempt)."""
        per = max(batch_reads // n, 1)
        return lane_cap(per * flat_per_read(read_len - spec.k + 1))

    apply.finish = finish
    apply.recv_width = recv_width
    apply.scan_spans = scan_spans
    apply.scan_stacked = scan_stacked
    apply.auto_lane_cap = auto_lane_cap
    return apply


def host_sum(t: ShardedSortedTable, x) -> int:
    """Sum a per-shard device array to a host int (replicates first so it
    works when shards live on other processes)."""
    rep = NamedSharding(t.mesh, P())
    return int(np.asarray(jax.jit(jnp.sum, out_shardings=rep)(x)))


def sorted_histogram(t: ShardedSortedTable, max_count: int = 256) -> np.ndarray:
    """psum-merged histogram across shards."""

    @functools.partial(jax.shard_map, mesh=t.mesh, in_specs=(P("d"), P("d")),
                       out_specs=P(), check_vma=False)
    def hist(hashes, counts):
        h = st.count_histogram(hashes[0], counts[0], max_count)
        return jax.lax.psum(h, "d")

    return np.asarray(jax.jit(hist)(t.hashes, t.counts))


def gather_sorted_compact(t: ShardedSortedTable, min_count: int = 0,
                          max_count: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Host-gathered global (hash, count), ascending — canonical global ids.

    With routing="range" the shards own contiguous ascending key ranges, so
    the gather is a pad-stripping CONCAT — no global re-sort; a key's
    canonical global rank is its shard's offset plus its local rank (the
    distributed-canonical-ids property the pod-scale path relies on).
    routing="low" shards interleave and need the sort.

    Multi-process: shards on other hosts are not addressable, so replicate
    first (jit identity with a replicated out-sharding inserts the
    all_gather); every process then holds the identical global table."""
    hashes, counts = t.hashes, t.counts
    if not hashes.is_fully_addressable:
        rep = NamedSharding(t.mesh, P())
        hashes, counts = jax.jit(lambda a, b: (a, b),
                                 out_shardings=(rep, rep))(hashes, counts)
    h = np.asarray(hashes).reshape(-1)
    c = np.asarray(counts).reshape(-1)
    keep = h != U64MAX
    if min_count:
        keep &= c >= min_count
    if max_count:
        keep &= c <= max_count
    h, c = h[keep], c[keep]
    if t.routing != "range":
        order = np.argsort(h, kind="stable")
        h, c = h[order], c[order]
    return h, c


# -- sharded snapshot / restore (SURVEY.md §6 checkpoint row) --------------------

def save_snapshot(t: ShardedSortedTable, path: str) -> None:
    """Per-shard (hash, count) files + manifest; the .hash-file analog.

    Multi-process: shards on other hosts are replicated first, and only
    process 0 writes (shared storage assumed, as for every report file)."""
    hashes, counts = t.hashes, t.counts
    if not hashes.is_fully_addressable:
        rep = NamedSharding(t.mesh, P())
        hashes, counts = jax.jit(lambda a, b: (a, b),
                                 out_shardings=(rep, rep))(hashes, counts)
        if jax.process_index() != 0:
            return
    os.makedirs(path, exist_ok=True)
    manifest = {
        "version": 2,
        "n_shards": t.n_shards,
        "shard_bits": t.shard_bits,
        "capacity": t.capacity,
        "routing": t.routing,
        "range_eff": t.range_eff or 1,
        "spec": json.loads(t.spec.to_json()) if t.spec else None,
    }
    hashes = np.asarray(hashes)
    counts = np.asarray(counts)
    for s in range(t.n_shards):
        keep = hashes[s] != U64MAX
        np.savez(os.path.join(path, f"shard_{s:05d}.npz"),
                 hashes=hashes[s][keep], counts=counts[s][keep])
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def load_snapshot(path: str, mesh: Mesh, capacity: int = 0,
                  buf_capacity: int = 0,
                  expect_spec: Optional[HashSpec] = None) -> ShardedSortedTable:
    """Restore a snapshot onto ``mesh`` (any power-of-two size — keys re-route
    under the new shard count by the manifest's routing rule)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    spec = HashSpec(**manifest["spec"]) if manifest["spec"] else None
    if expect_spec is not None and spec is not None and spec != expect_spec:
        raise ValueError(f"snapshot spec {spec} != expected {expect_spec} "
                         "(tables are only comparable with identical k/w/seed)")
    hs, cs = [], []
    for s in range(manifest["n_shards"]):
        z = np.load(os.path.join(path, f"shard_{s:05d}.npz"))
        hs.append(z["hashes"])
        cs.append(z["counts"])
    all_h = np.concatenate(hs)
    all_c = np.concatenate(cs)

    n = mesh.devices.size
    cap = capacity or manifest["capacity"]
    routing = manifest.get("routing", "low")  # v1 snapshots routed by low bits
    range_eff = int(manifest.get("range_eff", 1))
    t = ShardedSortedTable(mesh, cap, buf_capacity or cap, spec=spec,
                           routing=routing, range_eff=range_eff)
    # re-route under the new mesh size; merge shard-parallel
    per_shard_h = np.full((n, cap), U64MAX, np.uint64)
    per_shard_c = np.zeros((n, cap), np.uint32)
    if routing == "range":
        if spec is None:
            raise ValueError("range-routed snapshot requires a spec")
        dest = np.searchsorted(range_splitters(spec, n, range_eff), all_h,
                               side="right").astype(np.int64)
    else:
        dest = (all_h & (n - 1)).astype(np.int64)
    for s in range(n):
        sel = dest == s
        m = int(sel.sum())
        if m > cap:
            raise ValueError(f"shard {s} needs {m} > capacity {cap}")
        order = np.argsort(all_h[sel], kind="stable")
        per_shard_h[s, :m] = all_h[sel][order]
        per_shard_c[s, :m] = all_c[sel][order]
    sh = NamedSharding(mesh, P("d"))
    t.hashes = jax.device_put(jnp.asarray(per_shard_h), sh)
    t.counts = jax.device_put(jnp.asarray(per_shard_c), sh)
    return t
