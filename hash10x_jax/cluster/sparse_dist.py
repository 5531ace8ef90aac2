"""Mesh-distributed sparse friend clustering — ``--codeClusters`` on a pod
slice (BASELINE configs #4/#5: 1M+ barcodes).

Distributes the three phases of ``cluster/sparse.py`` over a 1-D device mesh
(SURVEY.md §3.2's collective rows, BASELINE verbatim: "barcode-barcode
co-occurrence matrices merge via psum/all-gather collectives"):

1. **Co-occurrence counts** — the inverted incidence's k-mer segments are
   DEALT to shards (longest-first round-robin, ``_ShardedShiftJoin``); each
   shard holds ONLY its own segments' codes/seg arrays (~n_pairs/n per chip —
   nothing whole-lane is ever replicated) and runs the shift-join sweep over
   them locally; emitted pair keys route to their owner shard by key low bits
   through ONE ``all_to_all`` per round (the same EP-style deterministic
   routing as the count pass), landing in per-shard LSM sorted tables that
   flush shard-parallel.  Send lanes are sized to the expected per-dest load
   (~W/n with low-bit routing), not the worst case — overflow is counted and
   raises, never silent.
2. **Friend thresholding — SHARD-SIDE.**  Each shard filters its own slice of
   the co-occurrence table to share >= threshold; only the survivors (the
   friend set, ~1000x smaller than the pair volume) are ever gathered,
   mirrored to both orders, and replicated (tens of bytes per barcode).
3. **Friend edges** — each shard sweeps its own segments and emits edges for
   friend pairs; edges accumulate in per-shard LSM tables and never route.
4. **Propagation** — labels ((n_p,) int32) are replicated; each iteration
   computes per-device partial ``segment_min`` over its local edges and merges
   with ``lax.pmin`` over the mesh — the psum/all-gather merge of BASELINE,
   with min as the monoid.  ``label_block_pairs`` switches to barcode-aligned
   label blocks when the replicated vector would not fit (config #5).

Equality with the single-device sparse path (and hence the union-find oracle)
is enforced by tests on a virtual 8-device CPU mesh.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..hashspec import U64MAX
from ..dist import sharded_sorted as SS
from ..table import sorted_table as st
from .sparse import (_forward_positions, _local_indices, _pow2,
                     _win_edges, _win_keys, canonical_ranks, friend_pairs)

__all__ = ["cluster_codes_sparse_dist", "cooccurrence_counts_dist",
           "friend_keys_dist"]

# numpy scalar, NOT jnp: a module-level jnp array would initialize the
# backend at import; np scalars lower as literals
_U64MAX = np.uint64(U64MAX)


def _put_rows(rows: np.ndarray, mesh: Mesh):
    """Place a host (n, ...) array so row s lives on mesh device s (works
    multi-process: only addressable shards materialize per process)."""
    sh = NamedSharding(mesh, P("d"))
    return jax.make_array_from_callback(rows.shape, sh,
                                        lambda idx: rows[idx])


class _ShardedShiftJoin:
    """Segment-partitioned shift join: k-mer segments dealt to shards
    longest-first round-robin; each shard holds only ITS segments' arrays
    (per-chip memory ~ n_pairs/n — the whole-lane replication of the round-2
    path was ~O(n_pairs) PER CHIP, the config-#4/#5 collapse point)."""

    def __init__(self, inc, mesh: Mesh, max_window: int,
                 with_positions: bool = False):
        n = mesh.devices.size
        self.n = n
        self.n_codes = inc.n_codes
        lens = np.diff(inc.kmer_offsets).astype(np.int64)
        order = np.argsort(-lens, kind="stable")
        self.per = [order[s::n] for s in range(n)]  # descending within shard
        self.sls = [lens[p] for p in self.per]
        self.cums = [np.concatenate([[0], np.cumsum(sl)]) for sl in self.sls]
        self.Ds = [int(sl[0]) if len(sl) else 0 for sl in self.sls]
        maxpairs = max((int(c[-1]) for c in self.cums), default=1)
        D = max(self.Ds + [1])
        # one window width for every shard and sweep: each distinct shape is a
        # separate XLA program
        self.W = min(_pow2(max(maxpairs, 1)),
                     max(_pow2(max_window), _pow2(4 * D)))
        Wtot = _pow2(max(maxpairs, 1))
        codes = np.zeros((n, Wtot + self.W), np.int32)
        seg = np.full((n, Wtot + self.W), -1, np.int32)
        pos = np.zeros((n, Wtot + self.W), np.int64) if with_positions else None
        fwd_pos = _forward_positions(inc) if with_positions else None
        for s in range(n):
            p, sl, cum = self.per[s], self.sls[s], self.cums[s]
            npair = int(cum[-1])
            if npair == 0:
                continue
            starts = inc.kmer_offsets[:-1][p]
            pos_old = (np.arange(npair, dtype=np.int64)
                       - np.repeat(cum[:-1], sl) + np.repeat(starts, sl))
            codes[s, :npair] = inc.kmer_codes[pos_old]
            seg[s, :npair] = np.repeat(np.arange(len(sl), dtype=np.int32), sl)
            if pos is not None:
                pos[s, :npair] = fwd_pos[pos_old]
        self.codes_d = _put_rows(codes, mesh)
        self.seg_d = _put_rows(seg, mesh)
        self.pos_d = _put_rows(pos, mesh) if pos is not None else None

    def _wins(self, s: int):
        out = []
        sl, cum = self.sls[s], self.cums[s]
        for d in range(1, self.Ds[s]):
            m = int(np.searchsorted(-sl, -(d + 1), side="right"))
            b = int(cum[m])
            if b - d <= 0:
                continue
            a = 0
            while a < b - d:
                out.append((a, d))
                a += self.W - d
        return out

    def rounds(self):
        return _rounds_of(self)

    def total_win_pairs(self) -> int:
        """Σ len·(len-1)/2 over all segments — the co-occurrence key mass."""
        return int(sum(int((sl * (sl - 1) // 2).sum()) for sl in self.sls))


def _rounds_of(sj):
    """Per round: (a (n,) int64, d (n,) int32) — each shard's next window;
    exhausted shards pad with the d=0 no-op."""
    wins = [sj._wins(s) for s in range(sj.n)]
    R = max((len(w) for w in wins), default=0)
    for w in wins:
        w.extend([(0, 0)] * (R - len(w)))
    return [(np.array([wins[s][r][0] for s in range(sj.n)], np.int64),
             np.array([wins[s][r][1] for s in range(sj.n)], np.int32))
            for r in range(R)]


class _ShiftJoinDev:
    """Shift-join sweep arrays built ON DEVICE from a ShardedIncidence
    (dist/sharded_inc.py): the host receives only per-shard segment-length
    histograms, never O(n_pairs) — the config-#4/#5 requirement.  Exposes
    the same surface as _ShardedShiftJoin (codes_d/seg_d/pos_d/W/Ds/
    rounds())."""

    def __init__(self, inc_sh, max_window: int, with_positions: bool = False):
        self.n = inc_sh.n
        self.n_codes = inc_sh.n_codes
        res = inc_sh.shift_join_arrays(max_window)
        if res is None:
            self.Ds = [0] * self.n
            self.W = 0
            self.hist = np.zeros((self.n, 1), np.int64)
            self.codes_d = self.seg_d = self.pos_d = None
            return
        codes_d, seg_d, pos_d, hist, W, Ds = res
        self.codes_d, self.seg_d = codes_d, seg_d
        self.pos_d = pos_d if with_positions else None
        self.hist = hist   # (n, D+1): positions in segments of length l
        self.W = W
        self.Ds = Ds

    def _wins(self, s: int):
        out = []
        hs = self.hist[s]
        # b(d) = positions in segments of length >= d+1 (suffix sum)
        suf = np.concatenate([np.cumsum(hs[::-1])[::-1], [0]])
        for d in range(1, self.Ds[s]):
            b = int(suf[d + 1]) if d + 1 < len(suf) else 0
            if b - d <= 0:
                continue
            a = 0
            while a < b - d:
                out.append((a, d))
                a += self.W - d
        return out

    def rounds(self):
        return _rounds_of(self)

    def total_win_pairs(self) -> int:
        ls = np.arange(self.hist.shape[1], dtype=np.int64)
        return int((self.hist * np.maximum(ls - 1, 0) // 2).sum())


def _make_pair_route_step(mesh: Mesh, W: int, n_codes: int, cap_lane: int):
    """One routed sweep round: every shard computes one window's pair keys
    over ITS OWN segments, buckets them by owner shard (key & (n-1)), one
    all_to_all delivers, and the receipts append to the per-shard buffer."""
    n = mesh.devices.size
    n_codes_u = jnp.uint64(max(n_codes, 1))

    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(P("d"), P("d"), P("d"), P("d"), P("d"),
                                 P("d"), P()),
                       out_specs=(P("d"), P("d")),
                       check_vma=False)
    def body(buf, drops, codes_pad, seg_pad, a, d, offset):
        buf, drops = buf[0], drops[0]
        key = _win_keys(codes_pad[0], seg_pad[0], a[0], jnp.int32(d[0]),
                        n_codes_u, W)
        key = jnp.where(d[0] > 0, key, _U64MAX)  # d=0 round padding: no-op
        dest = jnp.where(key != _U64MAX,
                         (key & jnp.uint64(n - 1)).astype(jnp.int32), n)
        dest, key = jax.lax.sort((dest, key), dimension=0, num_keys=1)
        # contiguous per-shard segments -> (n, cap_lane) send lanes by static
        # slices (no scatter); shard r's segment is [start[r], start[r+1]).
        # Pad so dynamic_slice never clamps the start (it clamps to
        # size - slice_size, which would alias every lane to offset 0 when
        # cap_lane == len(key)).
        key_pad = jnp.concatenate(
            [key, jnp.full((cap_lane,), _U64MAX, jnp.uint64)])
        starts = jnp.searchsorted(dest, jnp.arange(n + 1, dtype=jnp.int32)
                                  ).astype(jnp.int32)
        lanes = []
        dropped = jnp.uint32(0)
        for r in range(n):
            seg_len = starts[r + 1] - starts[r]
            lane = jax.lax.dynamic_slice(key_pad, (starts[r],), (cap_lane,))
            lane = jnp.where(jnp.arange(cap_lane, dtype=jnp.int32) < seg_len,
                             lane, _U64MAX)
            lanes.append(lane)
            dropped += jnp.maximum(seg_len - cap_lane, 0).astype(jnp.uint32)
        send = jnp.stack(lanes)                          # (n, cap_lane)
        if n > 1:
            recv = jax.lax.all_to_all(send, "d", split_axis=0, concat_axis=0,
                                      tiled=True)
        else:
            recv = send
        buf = jax.lax.dynamic_update_slice(buf, recv.reshape(-1),
                                           (jnp.int32(offset),))
        return buf[None], (drops + dropped)[None]

    return jax.jit(body, donate_argnums=(0, 1)), n * cap_lane


def _make_flush(mesh: Mesh):
    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(P("d"), P("d"), P("d")),
                       out_specs=(P("d"), P("d"), P("d"), P("d")),
                       check_vma=False)
    def flush_body(hashes, counts, buf):
        h, c, spilled = st._merge_impl(
            hashes[0], counts[0], buf[0],
            (buf[0] != _U64MAX).astype(jnp.uint32))
        fresh = jnp.full(buf.shape[1:], _U64MAX, jnp.uint64)
        return h[None], c[None], fresh[None], spilled[None]

    return jax.jit(flush_body, donate_argnums=(0, 1, 2))


def _shift_join_of(inc, mesh: Mesh, chunk: int, with_positions=False):
    """Host-incidence lanes deal segments from numpy (_ShardedShiftJoin);
    a ShardedIncidence builds the sweep arrays on device (_ShiftJoinDev —
    no O(n_pairs) host materialization)."""
    from ..dist.sharded_inc import ShardedIncidence
    if isinstance(inc, ShardedIncidence):
        if inc.mesh != mesh:
            raise ValueError("ShardedIncidence mesh != cluster mesh")
        return _ShiftJoinDev(inc, chunk, with_positions=with_positions)
    return _ShardedShiftJoin(inc, mesh, chunk, with_positions=with_positions)


def _cooccur_table(inc, mesh: Mesh, chunk: int):
    """Run the sharded co-occurrence sweep; returns the per-shard sorted
    (hashes (n, cap), counts (n, cap)) device arrays (shards own key low
    bits) — or None when there are no pairs to enumerate."""
    n = mesh.devices.size
    sj = _shift_join_of(inc, mesh, chunk)
    if inc.n_pairs == 0 or max(sj.Ds) < 2:
        return None
    W = sj.W
    rounds = sj.rounds()
    total_pairs = sj.total_win_pairs()
    cap = _pow2(max(2 * total_pairs // n, 1 << 12))
    flush = _make_flush(mesh)

    def sweep(cap_lane):
        step, recv_width = _make_pair_route_step(mesh, W, inc.n_codes,
                                                 cap_lane)
        buf_cap = _pow2(max(4 * recv_width, 1 << 12))
        sh = NamedSharding(mesh, P("d"))
        hashes = jax.device_put(jnp.full((n, cap), _U64MAX, jnp.uint64), sh)
        counts = jax.device_put(jnp.zeros((n, cap), jnp.uint32), sh)
        buf = jax.device_put(jnp.full((n, buf_cap), _U64MAX, jnp.uint64), sh)
        drops = jax.device_put(jnp.zeros((n,), jnp.uint32), sh)
        spilled = jax.device_put(jnp.zeros((n,), jnp.uint32), sh)
        buf_n = 0
        for a, d in rounds:
            if buf_n + recv_width > buf_cap:
                hashes, counts, buf, sp = flush(hashes, counts, buf)
                spilled = spilled + sp
                buf_n = 0
            buf, drops = step(buf, drops, sj.codes_d, sj.seg_d,
                              _put_rows(a, mesh), _put_rows(d, mesh),
                              jnp.int32(buf_n))
            buf_n += recv_width
        if buf_n:
            hashes, counts, buf, sp = flush(hashes, counts, buf)
            spilled = spilled + sp
        if int(np.asarray(jnp.sum(drops))):
            raise SS.LaneOverflowError(
                "pair routing dropped keys (lane overflow)",
                auto_cap=cap_lane)
        if int(np.asarray(jnp.sum(spilled))):
            raise RuntimeError("sharded co-occurrence table spilled; raise "
                               "chunk or shard count")
        return hashes, counts

    # low-bit routing spreads a window's keys ~uniformly; size lanes to the
    # expected load with 4x headroom (exact overflow accounting raises) —
    # worst-case W lanes made flush volume scale WITH the mesh size, the
    # round-2 inverse-scaling artifact.  A pathologically skewed window
    # (one owner receiving >4x its expected share) DOUBLES the lane and
    # re-sweeps instead of aborting (capped retries; the sweep is pure
    # recompute, so a retry is exact); ``chunk``
    # (bigger windows => more averaging) remains the caller-facing knob
    cap_lane = min(W, _pow2(4 * W // max(n, 1) + 1024))
    for attempt in range(4):
        try:
            return sweep(cap_lane)
        except SS.LaneOverflowError:
            if cap_lane >= W or attempt == 3:
                raise
            cap_lane = min(W, 2 * cap_lane)


def friend_keys_dist(inc, mesh: Mesh, min_friend_share: int,
                     chunk: int = 1 << 20) -> np.ndarray:
    """Sorted friend keys (both orders), thresholded SHARD-SIDE: only the
    survivors — the friend set, ~1000x smaller than the pair volume — are
    gathered and mirrored; no phase materializes O(n_pairs) on one device or
    host."""
    hc = _cooccur_table(inc, mesh, chunk)
    if hc is None:
        return np.zeros(0, np.uint64)
    hashes, counts = hc
    thr = jnp.uint32(min_friend_share)

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(P("d"), P("d")),
                       out_specs=P("d"), check_vma=False)
    def nsurv(h, c):
        keep = (c[0] >= thr) & (h[0] != _U64MAX)
        return jnp.sum(keep).astype(jnp.int64)[None]

    counts_per = np.asarray(jax.jit(nsurv, out_shardings=NamedSharding(
        mesh, P()))(hashes, counts))
    Wf = _pow2(max(int(counts_per.max(initial=0)), 8))

    def filt(h, c):
        keep = (c[0] >= thr) & (h[0] != _U64MAX)
        hh = jnp.sort(jnp.where(keep, h[0], _U64MAX))
        return hh[:Wf][None]

    fil = jax.jit(jax.shard_map(filt, mesh=mesh, in_specs=(P("d"), P("d")),
                                out_specs=P("d"), check_vma=False),
                  out_shardings=NamedSharding(mesh, P()))
    rows = np.asarray(fil(hashes, counts)).reshape(-1)
    k1 = rows[rows != U64MAX]
    if len(k1) == 0:
        return np.zeros(0, np.uint64)
    # mirror to both orders (keys were emitted c1 < c2 only) and sort — the
    # friend set is small, one device sort
    from .sparse import _mirror_sort
    keys, _ = _mirror_sort(k1, np.ones(len(k1), np.uint32), inc.n_codes)
    return keys


def cooccurrence_counts_dist(inc, mesh: Mesh, chunk: int = 1 << 20,
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-gathered sorted (keys, shares) — both orders — equal to the
    single-device ``cooccurrence_counts``.  TEST/COMPAT SURFACE ONLY: this
    gathers the full pair set; the production cluster path thresholds
    shard-side (``friend_keys_dist``) and never gathers it."""
    hc = _cooccur_table(inc, mesh, chunk)
    if hc is None:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint32)
    hashes, counts = hc
    if not hashes.is_fully_addressable:
        rep = NamedSharding(mesh, P())
        hashes, counts = jax.jit(lambda a, b: (a, b),
                                 out_shardings=(rep, rep))(hashes, counts)
    h = np.asarray(hashes).reshape(-1)
    c = np.asarray(counts).reshape(-1)
    keep = h != U64MAX
    h, c = h[keep], c[keep]
    from .sparse import _mirror_sort
    return _mirror_sort(h, c, inc.n_codes)


def _make_edge_step(mesh: Mesh, W: int, n_codes: int):
    n = mesh.devices.size
    n_codes_u = jnp.uint64(max(n_codes, 1))

    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(P("d"), P("d"), P("d"), P("d"), P(),
                                 P("d"), P("d"), P()),
                       out_specs=P("d"),
                       check_vma=False)
    def body(ebuf, codes_pad, seg_pad, p_pad, fkeys, a, d, offset):
        ebuf = ebuf[0]
        n_f_u = jnp.uint64(fkeys.shape[0])
        e1, e2 = _win_edges(codes_pad[0], seg_pad[0], p_pad[0], a[0],
                            jnp.int32(d[0]), fkeys, n_codes_u, n_f_u, W)
        live = (d[0] > 0)
        e = jnp.where(live, jnp.concatenate([e1, e2]), _U64MAX)
        ebuf = jax.lax.dynamic_update_slice(ebuf, e, (jnp.int32(offset),))
        return ebuf[None]

    return jax.jit(body, donate_argnums=(0,))


def _make_propagate(mesh: Mesh, n_p: int, n_f: int):
    """Labels are GLOBAL forward-CSR positions (replicated across the mesh),
    so each round pointer-jumps ``lab[lab]`` locally after the pmin merge —
    O(log diameter) rounds; see cluster/sparse._propagate."""
    if n_p >= 2 ** 31:
        # int32 global positions wrap past 2^31 pairs — and a replicated
        # (n_p,) vector would not fit anyway; the config-#5 path is
        # label_block_pairs (block-relative int32 labels, int64 at the write)
        raise ValueError(
            f"replicated label propagation needs n_pairs < 2^31 (got "
            f"{n_p}); use label_block_pairs / --labelBlocks for this lane")
    big = jnp.int32(2 ** 31 - 1)

    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(P("d"),), out_specs=P(),
                       check_vma=False)
    def prop(ebuf):
        init = jnp.arange(n_p, dtype=jnp.int32)
        # per-shard edges arrive LSM-compacted: ascending (= p-major) with
        # U64MAX pads at the end — no sort needed here
        e = ebuf[0]
        nf_u = jnp.uint64(max(n_f, 1))
        valid = e != _U64MAX
        p_sorted = jnp.where(valid, (e // nf_u).astype(jnp.int32), n_p)
        f_by_p = jnp.where(valid, (e % nf_u).astype(jnp.int32), n_f)
        # f-major order for the other segment_min
        fkey = jnp.where(valid,
                         (e % nf_u) * jnp.uint64(n_p) + (e // nf_u), _U64MAX)
        fkey = jnp.sort(fkey)
        fvalid = fkey != _U64MAX
        f_sorted = jnp.where(fvalid, (fkey // jnp.uint64(n_p))
                             .astype(jnp.int32), n_f)
        p_by_f = jnp.where(fvalid, (fkey % jnp.uint64(n_p))
                           .astype(jnp.int32), n_p)

        def cond(state):
            return state[1]

        def body(state):
            lab, _ = state
            part_f = jax.ops.segment_min(
                lab[jnp.minimum(p_by_f, n_p - 1)], f_sorted,
                num_segments=n_f + 1, indices_are_sorted=True)[:n_f]
            f_lab = jax.lax.pmin(part_f, "d")
            part_p = jax.ops.segment_min(
                f_lab[jnp.minimum(f_by_p, n_f - 1)], p_sorted,
                num_segments=n_p + 1, indices_are_sorted=True)[:n_p]
            back = jax.lax.pmin(part_p, "d")
            new = jnp.minimum(lab, jnp.minimum(back, big))
            new = jnp.minimum(new, new[new])   # pointer jump x2 (local:
            new = jnp.minimum(new, new[new])   # labels are replicated)
            changed = jax.lax.pmax(jnp.any(new != lab).astype(jnp.int32),
                                   "d") > 0
            return (new, changed)

        lab, _ = jax.lax.while_loop(cond, body, (init, jnp.bool_(True)))
        return lab

    return jax.jit(prop)


def _make_propagate_block(mesh: Mesh, blk_pad: int, n_f: int, e_blk: int):
    """Block variant of :func:`_make_propagate` for lanes whose full label
    vector does not fit replicated (SCALING.md phase 3, config #5): labels
    cover only positions [p0, p0 + blk_pad); each shard contributes the
    contiguous slice of its p-sorted edge table that falls in the block
    (host-verified to fit e_blk).  Blocks must align to barcode boundaries —
    components never cross barcodes, so every label stays inside its block
    and the pointer jump stays local.

    Labels are BLOCK-RELATIVE int32 positions (never global: a global int32
    wraps once n_pairs >= 2^31, exactly the config-#5 scale this path
    exists for); callers widen to int64 global positions by adding p0."""
    big = jnp.int32(2 ** 31 - 1)

    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(P("d"), P("d"), P(), P()), out_specs=P(),
                       check_vma=False)
    def prop(ebuf, lo, p0, p1):
        nf_u = jnp.uint64(max(n_f, 1))
        # dynamic_slice clamps the start near the row end; the explicit key-
        # range mask below drops any pulled-in out-of-block edges (which sit
        # at the FRONT of the slice, so p_loc is NOT sorted — segment ids are
        # passed unsorted)
        e = jax.lax.dynamic_slice(ebuf[0], (lo[0],), (e_blk,))
        valid = (e >= p0.astype(jnp.uint64) * nf_u) & \
                (e < p1.astype(jnp.uint64) * nf_u) & (e != _U64MAX)
        # subtract p0 in uint64 BEFORE the int32 cast: the global position
        # e // nf_u exceeds int32 past 2^31 pairs, the block offset never does
        p_loc = jnp.where(valid, (e // nf_u - p0.astype(jnp.uint64))
                          .astype(jnp.int32), blk_pad)
        f_by_p = jnp.where(valid, (e % nf_u).astype(jnp.int32), n_f)
        fkey = jnp.where(valid, (e % nf_u) * jnp.uint64(blk_pad)
                         + jnp.where(valid, p_loc, 0).astype(jnp.uint64),
                         _U64MAX)
        fkey = jnp.sort(fkey)
        fvalid = fkey != _U64MAX
        f_sorted = jnp.where(fvalid, (fkey // jnp.uint64(blk_pad))
                             .astype(jnp.int32), n_f)
        p_by_f = jnp.where(fvalid, (fkey % jnp.uint64(blk_pad))
                           .astype(jnp.int32), blk_pad)
        init = jnp.arange(blk_pad, dtype=jnp.int32)

        def jump(lab):
            # labels are block-relative positions: gather locally
            j = jnp.clip(lab, 0, blk_pad - 1)
            return jnp.minimum(lab, lab[j])

        def cond(state):
            return state[1]

        def body(state):
            lab, _ = state
            part_f = jax.ops.segment_min(
                lab[jnp.minimum(p_by_f, blk_pad - 1)], f_sorted,
                num_segments=n_f + 1, indices_are_sorted=True)[:n_f]
            f_lab = jax.lax.pmin(part_f, "d")
            part_p = jax.ops.segment_min(
                f_lab[jnp.minimum(f_by_p, n_f - 1)], p_loc,
                num_segments=blk_pad + 1)[:blk_pad]
            back = jax.lax.pmin(part_p, "d")
            new = jnp.minimum(lab, jnp.minimum(back, big))
            new = jump(jump(new))
            changed = jax.lax.pmax(jnp.any(new != lab).astype(jnp.int32),
                                   "d") > 0
            return (new, changed)

        lab, _ = jax.lax.while_loop(cond, body, (init, jnp.bool_(True)))
        return lab

    return jax.jit(prop)


def _make_block_writer(mesh: Mesh, Ppad: int, blk_pad: int):
    """Write one block's replicated label vector into each shard's
    position-aligned global-label row: shard s owns global positions
    [poff_s, poff_s + Ppad); the intersection with the block [p0, p1) is
    gathered from ``lab`` (block-relative int32) and widened to int64
    GLOBAL positions (lab + p0) at the write — the global-label array is
    int64 so config-#5 lanes (n_pairs >= 2^31) never wrap."""

    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(P("d"), P(), P("d"), P(), P()),
                       out_specs=P("d"), check_vma=False)
    def wr(glab, lab, poff_sh, p0, p1):
        pos = poff_sh[0] + jnp.arange(Ppad, dtype=jnp.int64)
        idx = jnp.clip(pos - p0, 0, blk_pad - 1).astype(jnp.int32)
        v = (pos >= p0) & (pos < p1)
        return jnp.where(v, p0 + lab[idx].astype(jnp.int64), glab[0])[None]

    return jax.jit(wr, donate_argnums=(0,))


def _propagate_blocks(inc, mesh: Mesh, ehashes, n_f: int,
                      target_pairs: int, sharded_out: bool = False):
    """Run the label fixpoint block by block (barcode-aligned position
    ranges).  Per-block device state is the block's label vector plus each
    shard's contiguous slice of its p-sorted edge table; block and edge
    widths bucket to powers of two so few fixpoint programs compile.

    ``sharded_out`` (requires a ShardedIncidence): block results write into
    a shard-resident (n, Ppad) global-label array aligned with
    ``inc.keys`` — the host never assembles the O(n_pairs) label vector
    (the config-#5 output path; the host variant returns the flat numpy
    labels for host-incidence lanes and tests)."""
    blocks = _label_blocks(inc, target_pairs)
    n = mesh.devices.size
    sh = NamedSharding(mesh, P("d"))
    nf_u = np.uint64(max(n_f, 1))
    # per-shard edge counts per block boundary, one device pass
    bounds = np.array([b[0] for b in blocks] + [blocks[-1][1]],
                      np.uint64) * nf_u

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(P("d"), P()),
                       out_specs=P("d"), check_vma=False)
    def find_bounds(eh, b):
        return jnp.searchsorted(eh[0], b).astype(jnp.int64)[None]

    starts = np.asarray(jax.jit(find_bounds)(ehashes, jnp.asarray(bounds)))
    if sharded_out:
        Ppad = inc.keys.shape[1]
        poff = jax.device_put(jnp.asarray(inc.pair_offsets[:-1]), sh)
        glab = jax.device_put(jnp.zeros((n, Ppad), jnp.int64), sh)
        writers = {}
    else:
        glob = np.empty(inc.n_pairs, np.int64)
    props = {}
    for i, (p0, p1) in enumerate(blocks):
        blk_pad = _pow2(max(p1 - p0, 8))
        e_blk = _pow2(max(int((starts[:, i + 1] - starts[:, i]).max()), 8))
        key = (blk_pad, e_blk)
        if key not in props:
            props[key] = _make_propagate_block(mesh, blk_pad, n_f, e_blk)
        lab = props[key](ehashes,
                         jax.device_put(starts[:, i].copy(), sh),
                         jnp.int64(p0), jnp.int64(p1))
        if sharded_out:
            if blk_pad not in writers:
                writers[blk_pad] = _make_block_writer(mesh, Ppad, blk_pad)
            glab = writers[blk_pad](glab, lab, poff, jnp.int64(p0),
                                    jnp.int64(p1))
        else:
            glob[p0:p1] = p0 + np.asarray(lab, np.int64)[:p1 - p0]
    return glab if sharded_out else glob


def _label_blocks(inc, target_pairs: int):
    """Barcode-aligned position blocks of ~target_pairs each: (p0, p1) list."""
    offs = inc.code_offsets
    blocks = []
    start = 0
    for c in range(inc.n_codes):
        if offs[c + 1] - start >= target_pairs:
            blocks.append((int(start), int(offs[c + 1])))
            start = int(offs[c + 1])
    if start < inc.n_pairs:
        blocks.append((int(start), int(inc.n_pairs)))
    return blocks or [(0, int(inc.n_pairs))]


def cluster_codes_sparse_dist(inc, mesh: Mesh, min_friend_share: int = 8,
                              chunk: int = 1 << 20, flat: bool = False,
                              label_block_pairs: int = 0):
    """Mesh-distributed ``cluster_codes_sparse`` — identical labels, device
    memory and sweep work split over the mesh (per-chip memory ~ n_pairs/n:
    segments, co-occurrence, and edges are all shard-resident; only the
    friend set and labels replicate).

    label_block_pairs > 0: propagate in barcode-aligned position blocks of
    roughly that many pairs (labels and per-iteration state sized per block,
    not per lane — the config-#5 path where a replicated (n_pairs,) label
    vector no longer fits; see SCALING.md phase 3)."""
    fkeys = friend_keys_dist(inc, mesh, min_friend_share, chunk=chunk)
    if len(fkeys) == 0 or inc.n_pairs == 0:
        canon = canonical_ranks(inc, _local_indices(inc)) \
            if inc.n_pairs else np.zeros(0, np.int32)
    else:
        n = mesh.devices.size
        sj = _shift_join_of(inc, mesh, chunk, with_positions=True)
        W = sj.W
        rep = NamedSharding(mesh, P())
        sh = NamedSharding(mesh, P("d"))
        fkeys_r = jax.device_put(jnp.asarray(fkeys), rep)
        rounds = sj.rounds()
        # stream edges through per-shard LSM tables: per-device memory is
        # ∝ its REAL edge count.  Edges are unique per (p, f), so the
        # flush's dedup is a no-op compaction; spills are counted and raise.
        e_cap = _pow2(max(8 * inc.n_pairs // n, 1 << 12))
        buf_cap = _pow2(max(8 * 2 * W, 1 << 12))
        ehashes = jax.device_put(jnp.full((n, e_cap), _U64MAX, jnp.uint64), sh)
        ecounts = jax.device_put(jnp.zeros((n, e_cap), jnp.uint32), sh)
        ebuf = jax.device_put(jnp.full((n, buf_cap), _U64MAX, jnp.uint64), sh)
        espill = jax.device_put(jnp.zeros((n,), jnp.uint32), sh)
        eflush = _make_flush(mesh)
        estep = _make_edge_step(mesh, W, inc.n_codes)
        off = 0
        for a, d in rounds:
            if off + 2 * W > buf_cap:
                ehashes, ecounts, ebuf, sp = eflush(ehashes, ecounts, ebuf)
                espill = espill + sp
                off = 0
            ebuf = estep(ebuf, sj.codes_d, sj.seg_d, sj.pos_d, fkeys_r,
                         _put_rows(a, mesh), _put_rows(d, mesh),
                         jnp.int32(off))
            off += 2 * W
        if off:
            ehashes, ecounts, ebuf, sp = eflush(ehashes, ecounts, ebuf)
            espill = espill + sp
        if int(np.asarray(jnp.sum(espill))):
            raise RuntimeError("distributed cluster edge table spilled; "
                               "raise shard count or edge capacity")
        from ..dist.sharded_inc import ShardedIncidence, canon_labels_sharded
        if label_block_pairs and isinstance(inc, ShardedIncidence) and flat:
            # config-#5 memory path, device end to end: per-block label
            # vectors write into a shard-resident global-label array and
            # canonicalize shard-side — nothing O(n_pairs) ever lands on
            # host or on one device (SCALING.md phase 3)
            glab = _propagate_blocks(inc, mesh, ehashes, len(fkeys),
                                     label_block_pairs, sharded_out=True)
            return canon_labels_sharded(inc, glab, sharded_lab=True)
        if label_block_pairs:
            # host-incidence lanes (and the non-flat compat surface): block
            # results assemble on host
            glob = _propagate_blocks(inc, mesh, ehashes, len(fkeys),
                                     label_block_pairs)
        elif isinstance(inc, ShardedIncidence) and flat:
            # device end to end: replicated min-position labels -> shard-side
            # canonicalization; the host sees nothing O(n_pairs)
            prop = _make_propagate(mesh, inc.n_pairs, len(fkeys))
            return canon_labels_sharded(inc, prop(ehashes))
        else:
            prop = _make_propagate(mesh, inc.n_pairs, len(fkeys))
            glob = np.asarray(prop(ehashes)).astype(np.int64)
        code_of_p = np.repeat(np.arange(inc.n_codes, dtype=np.int64),
                              np.diff(inc.code_offsets))
        labels = (glob - inc.code_offsets[code_of_p]).astype(np.int32)
        canon = canonical_ranks(inc, labels)
    if flat:
        return canon
    return [canon[inc.code_offsets[c]:inc.code_offsets[c + 1]]
            for c in range(inc.n_codes)]
