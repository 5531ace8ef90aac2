"""Sparse global friend clustering — the at-scale ``--codeClusters`` path.

The reference walks barcodes serially, tallying per-other-barcode share counts
into an accumulator (``hash10x.c:~codeClusterFind``, SURVEY.md §3.1 #8, §4.2).
The round-1 device path batched that tally as dense ``(B, n_codes)`` share rows —
O(n_codes) memory per barcode row, which collapses at 1M+ barcodes (BASELINE
configs #4/#5).  This module holds the co-occurrence sparse: device memory is
proportional to the *pair set*, never n_codes².

v2 design — a **shift-join**, no gathers (the v1 sweep decoded flat pair
indices through ``searchsorted`` + large random gathers; whether gathers would
now be cheaper on the H100 is ROADMAP Y3):

1. **Length-ordered CSR** — the inverted incidence (codes-per-kmer lists,
   each ascending) is reordered host-side so longer lists come first.  For a
   shift distance d, every ordered pair (codes[i], codes[i+d]) with both
   positions in one k-mer's segment is a co-occurring pair with c1 < c2; the
   segments still containing pairs at distance d form a PREFIX of the array.
2. **Shift sweep** — for d = 1..maxlen-1, one device step per window:
   ``c2 = roll(codes_win, -d)``, same-segment mask, ``key = c1*n_codes + c2``
   — pure elementwise ops on contiguous arrays (window size per d rounds the
   live prefix to a power of two, so traces stay bounded).  List lengths are
   count-band bounded (filter's max_count), so maxlen is small.
3. **Sparse co-occurrence counts** — keys accumulate in the LSM sorted-run
   table (``table/sorted_table.py``, flush_grow: never spills).  This IS the
   barcode x barcode co-occurrence matrix A·Aᵀ of BASELINE.json, held sparse
   and sorted; c1 < c2 halves the volume and the mirror order is recovered
   from the compacted result in one cheap pass.
4. **Friend edges** — a second shift sweep emits bipartite edges for pairs
   whose share passed the threshold: (p = forward-CSR position of (c1, h),
   f = rank of (c1, c2) among friend keys), packed as u64 keys and
   accumulated device-resident in another sorted table — compaction returns
   them already p-sorted; the f-sorted order is one more device sort.
5. **Global min-label propagation** — one flat fixpoint over ALL barcodes at
   once (components never cross barcodes, so one global pass is exact).
   Deterministic, order-free; equals the oracle's union-find
   (``cluster_barcode_friend`` with no cap) — first-appearing-k-mer canonical
   numbering falls out as the dense rank of labels per barcode.

Memory: O(window) for enumeration, O(|cooccur entries|) for the count table,
O(|edges|) for propagation.  No (B, n_codes) anything.
"""

from __future__ import annotations

import functools
import os
import sys
import time
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..hashspec import U64MAX
from ..table import sorted_table as st
from ..table.incidence import Incidence

__all__ = ["cooccurrence_counts", "friend_pairs", "propagate_labels",
           "canonical_ranks", "cluster_codes_sparse"]

# numpy scalar, NOT jnp: a module-level jnp array would initialize the
# backend at import; np scalars lower as literals
_U64MAX = np.uint64(U64MAX)

# default enumeration window (keys generated per device step, static shape)
_CHUNK = 1 << 22


def _pow2(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 3)


class _ShiftJoin:
    """Host-side reorder + device arrays for the shift-join sweeps."""

    def __init__(self, inc: Incidence, max_window: int):
        lens = np.diff(inc.kmer_offsets).astype(np.int64)
        order = np.argsort(-lens, kind="stable")
        sl = lens[order]
        n_pairs = inc.n_pairs
        new_off = np.concatenate([[0], np.cumsum(sl)])
        starts = inc.kmer_offsets[:-1][order]
        pos_old = (np.arange(n_pairs, dtype=np.int64)
                   - np.repeat(new_off[:-1], sl) + np.repeat(starts, sl))
        self.pos_old = pos_old
        self.sl = sl
        self.cum = new_off
        self.D = int(sl[0]) if len(sl) else 0
        self.n_codes = inc.n_codes
        # window floor 4*D keeps every shift distance coverable (w > d)
        self.W = min(_pow2(max(n_pairs, 1)),
                     max(_pow2(max_window), _pow2(4 * max(self.D, 1))))
        codes = inc.kmer_codes[pos_old].astype(np.int32)
        seg = np.repeat(np.arange(len(sl), dtype=np.int32), sl)
        # pad by one max window so fixed-size dynamic slices at any offset are
        # in-bounds; padded seg = -1 never matches a real segment
        self.codes_d = jnp.asarray(
            np.concatenate([codes, np.zeros(self.W, np.int32)]))
        self.seg_d = jnp.asarray(
            np.concatenate([seg, np.full(self.W, -1, np.int32)]))

    def b(self, d: int) -> int:
        """Positions in segments still containing pairs at distance d (a
        prefix, lists being length-ordered): sum of lens >= d+1."""
        m = int(np.searchsorted(-self.sl, -(d + 1), side="right"))
        return int(self.cum[m])

    def windows(self, d: int):
        """(offset, width) windows covering all pair starts i in [0, b-d)."""
        b = self.b(d)
        if b - d <= 0:
            return
        # ONE window width for the whole sweep: every distinct shape is a
        # separate XLA program, and compiles may cost more than the
        # padded-window compute they would save (not measured on the H100)
        w = self.W
        a = 0
        while a < b - d:
            yield a, w
            a += w - d


@functools.partial(jax.jit, static_argnames=("w",))
def _win_keys(codes_pad, seg_pad, a, d, n_codes_u, w: int):
    """Pair keys c1*n_codes+c2 for starts i in [a, a+w-d) at distance d
    (U64MAX where the two positions straddle segments or run off the window)."""
    cw = jax.lax.dynamic_slice(codes_pad, (a,), (w,))
    sw = jax.lax.dynamic_slice(seg_pad, (a,), (w,))
    c1 = cw.astype(jnp.uint64)
    c2 = jnp.roll(cw, -d).astype(jnp.uint64)
    ok = (sw == jnp.roll(sw, -d)) & (sw >= 0) & \
        (jnp.arange(w, dtype=jnp.int32) < (jnp.int32(w) - d))
    return jnp.where(ok, c1 * n_codes_u + c2, _U64MAX)


@functools.partial(jax.jit, static_argnames=("w",))
def _win_edges(codes_pad, seg_pad, p_pad, a, d, fkeys, n_codes_u, n_f_u,
               w: int):
    """Bipartite edge keys for one window: for friend pairs (c1,c2) sharing
    k-mer h, edges (p1 = fwd position of (c1,h)) -> rank(c1,c2) and
    (p2 = fwd position of (c2,h)) -> rank(c2,c1), packed p*n_f+f (U64MAX
    elsewhere).  ``fkeys`` may carry U64MAX pads at the tail (device-
    resident friend set).  rank_join: the earlier searchsorted+verify form
    still random-gathered ``fkeys[i]`` per window; the join is now pure
    lax.sort end to end."""
    from ..table.incidence import rank_join
    cw = jax.lax.dynamic_slice(codes_pad, (a,), (w,))
    sw = jax.lax.dynamic_slice(seg_pad, (a,), (w,))
    pw = jax.lax.dynamic_slice(p_pad, (a,), (w,))
    c1 = cw.astype(jnp.uint64)
    c2 = jnp.roll(cw, -d).astype(jnp.uint64)
    ok = (sw == jnp.roll(sw, -d)) & (sw >= 0) & \
        (jnp.arange(w, dtype=jnp.int32) < (jnp.int32(w) - d))
    key = jnp.where(ok, c1 * n_codes_u + c2, _U64MAX)
    km = jnp.where(ok, c2 * n_codes_u + c1, _U64MAX)
    i1, f1 = rank_join(fkeys, key)
    i2, _ = rank_join(fkeys, km)
    isf = ok & f1
    p1 = pw.astype(jnp.uint64)
    p2 = jnp.roll(pw, -d).astype(jnp.uint64)
    e1 = jnp.where(isf, p1 * n_f_u + i1.astype(jnp.uint64), _U64MAX)
    e2 = jnp.where(isf, p2 * n_f_u + i2.astype(jnp.uint64), _U64MAX)
    return e1, e2


def _cooccur_table(sj: "_ShiftJoin", n_codes: int):
    """Run the c1 < c2 co-occurrence sweep into an LSM table; returns the
    flushed DEVICE (sorted keys with U64MAX pads, shares) sliced to a pow2
    bucket of the real fill (device-resident — no host round trip of the
    full co-occurrence set)."""
    n_codes_u = jnp.uint64(max(n_codes, 1))

    def gen():
        for d in range(1, sj.D):
            for a, w in sj.windows(d):
                yield w, _win_keys(sj.codes_d, sj.seg_d, jnp.int64(a),
                                   jnp.int32(d), n_codes_u, w)

    t = None
    bound = 0
    for w, keys in gen():
        if t is None:
            t = st.make_sorted_table(1 << 18, _pow2(8 * w))
        if t.buf_n + w > t.buf.shape[0]:
            if bound + t.buf_n <= 0.25 * t.capacity:
                bound += t.buf_n
                t = st.flush(t)
            else:
                t, bound = st.flush_grow(t, load=0.25, return_count=True)
        t = st.append(t, keys)
    if t is None:
        return None, None, 0
    t, n_fill = st.flush_grow(t, return_count=True)
    w = _pow2(max(n_fill, 8))
    return t.hashes[:w], t.counts[:w], n_fill


def cooccurrence_counts(inc: Incidence, chunk: int = _CHUNK,
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Sparse barcode x barcode co-occurrence: sorted (pair key, share) arrays.

    share(c1, c2) = |{h : (c1,h), (c2,h) in incidence}| — exactly the oracle's
    ``barcode_shares`` for every c1 at once (symmetric; both orders present)."""
    sj = _ShiftJoin(inc, chunk)
    k1, s1, n_fill = _cooccur_table(sj, inc.n_codes)
    if n_fill == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint32)
    return _mirror_sort(np.asarray(k1)[:n_fill], np.asarray(s1)[:n_fill],
                        inc.n_codes)


def _mirror_sort(k1, s1, n_codes: int):
    """Mirror c1 < c2 co-occurrence keys to both orders (shares are
    symmetric) and sort — on device (a host argsort of 2x the pair volume was
    the residual host cost of this phase at scale)."""
    k1d = jnp.asarray(k1)
    s1d = jnp.asarray(s1)
    nc = jnp.uint64(n_codes)
    k2 = (k1d % nc) * nc + (k1d // nc)
    keys, shares = jax.lax.sort(
        (jnp.concatenate([k1d, k2]), jnp.concatenate([s1d, s1d])),
        dimension=0, num_keys=1)
    return np.asarray(keys), np.asarray(shares)


def friend_pairs(pair_keys: np.ndarray, shares: np.ndarray,
                 min_friend_share: int) -> np.ndarray:
    """Sorted u64 keys (c1 * n_codes + c2) whose share >= threshold."""
    return pair_keys[shares >= min_friend_share]


@jax.jit
def _friend_mirror(h, c, nc_u, thr_u):
    """Device friend set from the c1 < c2 co-occurrence table: band-filter,
    mirror to both orders, sort.  Returns (sorted friend keys with U64MAX
    pads, real count).  Mirrors AFTER the threshold filter — mirroring
    first would sort 2x the pair volume and move the FULL co-occurrence set
    to the host."""
    keep = (h != _U64MAX) & (c >= thr_u)
    f1 = jnp.where(keep, h, _U64MAX)
    f2 = jnp.where(keep, (h % nc_u) * nc_u + (h // nc_u), _U64MAX)
    fk = jnp.sort(jnp.concatenate([f1, f2]))
    return fk, jnp.sum(fk != _U64MAX)


def _forward_positions(inc: Incidence) -> np.ndarray:
    """inv2fwd[i]: forward-CSR position of the (code, kmer) pair at inverted-
    CSR position i.  The engine's CSR build carries it out of the inverted
    sort for free (``Incidence.inv2fwd``); hand-built instances recompute it
    as a device dense-rank of the combined (code, kmer) key (forward CSR is
    code-major kmer-ascending, so the rank IS the forward position)."""
    if inc.inv2fwd is not None:
        return inc.inv2fwd
    from ..utils.dense import device_dense_ranks
    kmer_of_i = np.repeat(np.arange(inc.n_kmers, dtype=np.int64),
                          np.diff(inc.kmer_offsets))
    code_of_i = inc.kmer_codes.astype(np.int64)
    fwd_key = code_of_i * np.int64(inc.n_kmers) + kmer_of_i
    return device_dense_ranks(fwd_key).astype(np.int32)


# edges above this fall back to the BLOCKED propagate: the monolithic
# while_loop's per-round temporaries (gathers + segment mins over the padded
# edge width) scale with the edge count; the blocked path bounds per-dispatch
# memory to one block and pays one host sync per fixpoint round instead
# (whether the H100 needs it is ROADMAP Y1)
_EDGE_BLOCK = 1 << 25


def propagate_labels(inc: Incidence, p_edges, f_edges, n_f: int) -> np.ndarray:
    """Component labels for every forward-CSR position (local min k-mer index
    within its barcode), via global flat min-label propagation."""
    local = _local_indices(inc)
    if inc.n_pairs == 0 or (hasattr(p_edges, "__len__") and len(p_edges) == 0):
        return local
    p_e = jnp.asarray(p_edges)
    f_e = jnp.asarray(f_edges)
    # both edge orders on device (argsort+gather is fine here: one-off, and
    # edges are already p-sorted from the edge table, so only f-order sorts)
    fkey = f_e.astype(jnp.uint64) * jnp.uint64(inc.n_pairs) + \
        p_e.astype(jnp.uint64)
    fkey = jnp.sort(fkey)
    p_by_f = (fkey % jnp.uint64(inc.n_pairs)).astype(jnp.int32)
    f_sorted = (fkey // jnp.uint64(inc.n_pairs)).astype(jnp.int32)
    if p_e.shape[0] > _EDGE_BLOCK:
        glob = _propagate_blocked(p_by_f, f_sorted, p_e.astype(jnp.int32),
                                  f_e.astype(jnp.int32),
                                  n_p=inc.n_pairs, n_f=n_f)
    else:
        glob = _propagate(p_by_f, f_sorted, p_e.astype(jnp.int32),
                          f_e.astype(jnp.int32),
                          n_p=inc.n_pairs, n_f=n_f)
    # global min position -> local min k-mer index within the barcode
    code_of_p = np.repeat(
        np.arange(inc.n_codes, dtype=np.int64), np.diff(inc.code_offsets))
    return (np.asarray(glob).astype(np.int64)
            - inc.code_offsets[code_of_p]).astype(np.int32)


@functools.partial(jax.jit, static_argnames=("n_seg",))
def _seg_min_block(acc, lab_src, idx_block, seg_block, n_seg: int):
    """min-combine one edge block's segment_min into the accumulator.
    Sentinel edges carry idx = len(lab_src)-1 and seg = n_seg-1, so they only
    ever touch the sentinel rows."""
    part = jax.ops.segment_min(lab_src[idx_block], seg_block,
                               num_segments=n_seg, indices_are_sorted=True)
    return jnp.minimum(acc, part)


@functools.partial(jax.jit, static_argnames=("n_p",))
def _jump_round(lab, back, n_p: int):
    new = jnp.minimum(lab, back)
    new = jnp.minimum(new, new[new])   # pointer jump x2
    new = jnp.minimum(new, new[new])
    return new, jnp.any(new != lab)


def _propagate_blocked(p_by_f, f_sorted, p_ids_sorted, f_by_p,
                       n_p: int, n_f: int):
    """_propagate with bounded per-dispatch memory: each fixpoint round folds
    segment mins over fixed-size edge blocks (one device program per block
    shape) instead of one program over the whole padded edge array.  Same
    labels as _propagate (min over a union == min over its blocks); costs one
    host sync per round for the convergence flag.  Labels live in (n_p+1,)
    arrays whose last row is the sentinel target of pad edges (pads pack
    p = n_p, f = n_f, so they never touch real rows)."""
    E = int(p_by_f.shape[0])
    nb = (E + _EDGE_BLOCK - 1) // _EDGE_BLOCK
    # pad to whole blocks with sentinel edges
    pad = nb * _EDGE_BLOCK - E
    if pad:
        p_by_f = jnp.concatenate([p_by_f, jnp.full((pad,), n_p, jnp.int32)])
        f_sorted = jnp.concatenate([f_sorted, jnp.full((pad,), n_f, jnp.int32)])
        p_ids_sorted = jnp.concatenate(
            [p_ids_sorted, jnp.full((pad,), n_p, jnp.int32)])
        f_by_p = jnp.concatenate([f_by_p, jnp.full((pad,), n_f, jnp.int32)])
    big = np.int32(2 ** 31 - 1)
    lab = jnp.arange(n_p + 1, dtype=jnp.int32)
    while True:
        f_lab = jnp.full((n_f + 1,), big, jnp.int32)
        for b in range(nb):
            s = slice(b * _EDGE_BLOCK, (b + 1) * _EDGE_BLOCK)
            f_lab = _seg_min_block(f_lab, lab, p_by_f[s], f_sorted[s],
                                   n_f + 1)
        back = jnp.full((n_p + 1,), big, jnp.int32)
        for b in range(nb):
            s = slice(b * _EDGE_BLOCK, (b + 1) * _EDGE_BLOCK)
            back = _seg_min_block(back, f_lab, f_by_p[s], p_ids_sorted[s],
                                  n_p + 1)
        # an edgeless row's back stays `big`: min(lab, big) = lab
        lab, changed = _jump_round(lab, back, n_p + 1)
        if not bool(np.asarray(changed)):
            return lab[:n_p]


@functools.partial(jax.jit, static_argnames=("n_p", "n_f"))
def _propagate(p_by_f, f_ids_sorted, p_ids_sorted, f_by_p,
               n_p: int, n_f: int):
    """Fixpoint of the bipartite min-label relaxation (edges pre-sorted both
    ways: (p_by_f, f_ids_sorted) = edge list sorted by f; (p_ids_sorted,
    f_by_p) = sorted by p).

    Labels are GLOBAL forward-CSR positions (init = arange), so each round can
    pointer-jump ``lab[lab]`` — a label is itself a position whose label is at
    least as small and in the same component — collapsing convergence from
    O(component diameter) rounds to O(log diameter).  Components never cross
    barcodes, so the fixpoint per position is its component's min global
    position; callers subtract the barcode's code_offset to recover the local
    min k-mer index (the oracle's labeling)."""
    big = jnp.int32(2 ** 31 - 1)
    init = jnp.arange(n_p, dtype=jnp.int32)

    def cond(state):
        return state[1]

    def body(state):
        lab, _ = state
        f_lab = jax.ops.segment_min(lab[p_by_f], f_ids_sorted,
                                    num_segments=n_f,
                                    indices_are_sorted=True)
        back = jax.ops.segment_min(f_lab[f_by_p], p_ids_sorted,
                                   num_segments=n_p,
                                   indices_are_sorted=True)
        new = jnp.minimum(lab, jnp.minimum(back, big))
        new = jnp.minimum(new, new[new])   # pointer jump x2
        new = jnp.minimum(new, new[new])
        return (new, jnp.any(new != lab))

    lab, _ = jax.lax.while_loop(cond, body, (init, jnp.bool_(True)))
    return lab


def _local_indices(inc: Incidence) -> np.ndarray:
    code_of_p = np.repeat(
        np.arange(inc.n_codes, dtype=np.int64), np.diff(inc.code_offsets))
    return (np.arange(inc.n_pairs, dtype=np.int64)
            - inc.code_offsets[code_of_p]).astype(np.int32)


@jax.jit
def _dense_rank_delta(combined, base):
    """dense_rank(combined) - dense_rank(base) over the distinct values of
    ``combined`` — the device form of np.unique + two searchsorteds (host
    unique over the pair volume was the residual cost at 1M+ barcodes).
    distinct_below: merge-join ranks, no gathers (``dense_of_sorted[idx]``
    random-gathered the full pair volume)."""
    from ..utils.dense import distinct_below
    s = jnp.sort(combined)
    is_new = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]])
    q = jnp.concatenate([combined, base])
    d = distinct_below(s, is_new, q)
    n = combined.shape[0]
    return (d[:n] - d[n:]).astype(jnp.int32)


@jax.jit
def _canon_fused(labels, offsets_pad, K_u, n_real_u):
    """combined/base built ON device (boundary scatter + cumsum) — uploading
    host-built combined AND base would move 4x the label volume."""
    Np = labels.shape[0]
    pos = jnp.arange(Np, dtype=jnp.int32)
    valid = pos.astype(jnp.int64) < n_real_u
    marks = jnp.zeros(Np, jnp.int32).at[offsets_pad].add(1, mode="drop")
    code_of_p = jnp.cumsum(marks).astype(jnp.int64)
    big = jnp.int64(1) << 62
    combined = jnp.where(valid, code_of_p * K_u + labels.astype(jnp.int64),
                         big)
    base = jnp.where(valid, code_of_p * K_u, big)
    return _dense_rank_delta(combined, base)


def canonical_ranks(inc: Incidence, labels: np.ndarray) -> np.ndarray:
    """Dense-rank labels per barcode into canonical cluster ids (first-
    appearing k-mer numbering: a component's label IS its min local index, so
    ascending label order == first-appearance order).  Ranking runs on
    device (sort + boundary cumsum + merge-join, gather-free)."""
    if inc.n_pairs == 0:
        return np.zeros(0, np.int32)
    n_pairs = inc.n_pairs
    Np = _pow2(n_pairs)
    K = int(labels.max(initial=0)) + 1
    lab_pad = np.zeros(Np, np.int32)
    lab_pad[:n_pairs] = labels
    offs_in = inc.code_offsets[1:-1]
    offs_pad = np.full(_pow2(max(len(offs_in), 4)), Np, np.int64)
    offs_pad[:len(offs_in)] = np.minimum(offs_in, Np)
    d = _canon_fused(jnp.asarray(lab_pad), jnp.asarray(offs_pad),
                     jnp.int64(K), jnp.int64(n_pairs))
    return np.asarray(d)[:n_pairs].astype(np.int32)


def cluster_codes_sparse(inc: Incidence, min_friend_share: int = 8,
                         chunk: int = _CHUNK, flat: bool = False):
    """The scalable ``--codeClusters`` pass: sparse co-occurrence + global
    propagation.  Bit-equal to ``oracle.cluster_ref.cluster_barcode_friend``
    with no cap (tests enforce).  Returns per-code label arrays (or the flat
    position-aligned array when ``flat``).

    One ``_ShiftJoin`` serves both sweeps, and the co-occurrence/friend sets
    stay DEVICE-resident between them.  ``H10X_PHASE_TIMERS=1`` prints a
    per-phase wall attribution line to stderr (each listed phase ends at a
    host sync, so the walls are real)."""
    timers = os.environ.get("H10X_PHASE_TIMERS") == "1"
    walls = {}
    t_last = time.monotonic()

    def tick(name, sync=None):
        nonlocal t_last
        if not timers:
            return
        if sync is not None:
            jax.block_until_ready(sync)
        now = time.monotonic()
        walls[name] = round(now - t_last, 3)
        t_last = now

    sj = _ShiftJoin(inc, chunk) if inc.n_pairs else None
    tick("shiftjoin_build")
    k1, s1, n_fill = (_cooccur_table(sj, inc.n_codes) if sj is not None
                      else (None, None, 0))
    tick("cooccur_sweep", k1)
    if n_fill == 0 or inc.n_pairs == 0:
        canon = canonical_ranks(inc, _local_indices(inc)) \
            if inc.n_pairs else np.zeros(0, np.int32)
        fkeys = np.zeros(0, np.uint64)
    else:
        fk_full, n_f_d = _friend_mirror(k1, s1, jnp.uint64(max(inc.n_codes, 1)),
                                        jnp.uint32(min_friend_share))
        n_f = int(n_f_d)
        tick("friend_mirror")
        fkeys = fk_full  # device; n_f real entries
    if n_fill and inc.n_pairs and n_f == 0:
        canon = canonical_ranks(inc, _local_indices(inc))
    elif n_fill and inc.n_pairs:
        # i32 positions (half the upload; n_pairs < 2^31 by construction)
        p_pad = jnp.asarray(np.concatenate(
            [np.asarray(_forward_positions(inc), np.int32)[sj.pos_old],
             np.zeros(sj.W, np.int32)]))
        tick("forward_positions")
        fkeys_d = fk_full[:_pow2(n_f)]
        n_codes_u = jnp.uint64(inc.n_codes)
        n_f_u = jnp.uint64(n_f)

        # edges need no merging (each (p, f) arises once), so accumulate the
        # window outputs device-side and sort in few large rounds — routing
        # them through the LSM table would re-sort the whole table per
        # flush.  A memory budget
        # bounds the accumulated slots: window outputs are mostly U64MAX
        # (few window pairs are friend edges), so drains are rare and peak
        # device memory is ∝ budget + real edges.  Each drain sorts ONLY its
        # own window outputs and keeps the pad-stripped result as one run of
        # a run LIST (LSM discipline); the runs merge in ONE final sort —
        # re-sorting ALL previously-drained edges at every drain would cost
        # O(drains x edges) sort volume
        budget = _CHUNK * 8  # slots (u64) held before a drain
        parts, held, runs = [], 0, []

        def drain():
            nonlocal parts, held
            if not parts:
                return
            s = jnp.sort(parts[0] if len(parts) == 1
                         else jnp.concatenate(parts))
            n_real = int(jnp.searchsorted(s, _U64MAX))  # one sync per drain
            runs.append(s[:max(n_real, 1)])
            parts, held = [], 0

        for d in range(1, sj.D):
            for a, w in sj.windows(d):
                if held + 2 * w > budget:
                    drain()
                e1, e2 = _win_edges(sj.codes_d, sj.seg_d, p_pad,
                                    jnp.int64(a), jnp.int32(d), fkeys_d,
                                    n_codes_u, n_f_u, w)
                parts.append(e1)
                parts.append(e2)
                held += 2 * w
        drain()
        all_e = (runs[0] if len(runs) == 1
                 else jnp.sort(jnp.concatenate(runs)))
        n_real = int(jnp.searchsorted(all_e, _U64MAX))
        tick("edge_sweep")
        # pad the edge count to a power of two so downstream jits see few
        # distinct shapes; pad edges map to sentinel segments (p=n_p, f=n_f)
        # which segment_min drops
        n_pad = _pow2(max(n_real, 1))
        if n_pad > all_e.shape[0]:
            all_e = jnp.concatenate(
                [all_e, jnp.full((n_pad - all_e.shape[0],), _U64MAX,
                                 jnp.uint64)])
        ekeys_d = all_e[:n_pad]
        valid = ekeys_d != _U64MAX
        p_e = jnp.where(valid, (ekeys_d // n_f_u).astype(jnp.int64),
                        inc.n_pairs)
        f_e = jnp.where(valid, (ekeys_d % n_f_u).astype(jnp.int64), n_f)
        labels = propagate_labels(inc, p_e, f_e, n_f=n_f)
        tick("propagate")
        canon = canonical_ranks(inc, labels)
        tick("canonical_ranks")
    if timers:
        print(f"cluster phases: {walls} (n_pairs={inc.n_pairs}, "
              f"cooccur={n_fill if inc.n_pairs else 0})", file=sys.stderr)
    if flat:
        return canon
    return [canon[inc.code_offsets[c]:inc.code_offsets[c + 1]]
            for c in range(inc.n_codes)]
