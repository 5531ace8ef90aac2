"""Shard-resident k-mer x barcode incidence (the code tables, distributed).

The round-3 sharded pipeline deduplicated pair keys shard-side but then
gathered the FULL pair set to host and built both CSR halves on ONE device
(``engine.py`` -> ``gather_sorted_compact`` -> ``_csr_from_pairs``): at
BASELINE config #5 (7e9 pairs x 8 B) that is 56 GB on host and a
single-device sort larger than one card's memory.  This module keeps the
pair set device-sharded END TO END:

* ``build_sharded_incidence`` — ONE all_to_all redistributes the dedup
  owners' sorted runs (balanced low-bit shards) into CODE-RANGE-aligned
  slices: shard s owns codes [b_s, b_{s+1}) (``code_range_bounds``), so its
  ascending run IS a contiguous slice of the global forward CSR and a pair's
  global position is ``pair_offsets[s] + local rank`` — distributed
  canonical positions, the same discipline as the count table's value
  ranges.  Per-shard memory stays ~n_pairs/n; the host sees only (n,)
  counts.
* ``ShardedIncidence.build_inverted`` — the kmer-major half: each shard
  re-keys its pairs as ``kmer * n_codes + code`` CARRYING the global forward
  position, routes them to kmer-range owners (one all_to_all), and the owner
  sorts — the distributed transpose that replaces the single-device
  kmer-major sort of ``_csr_from_pairs``.
* ``ShardedIncidence.shift_join_arrays`` — the device-resident construction
  of the shift-join sweep arrays (cluster/sparse_dist._ShardedShiftJoin
  consumed host numpy before): per shard, segments (codes-per-kmer lists)
  sort by length DESCENDING (the window-prefix property the sweep schedule
  needs) via one multi-key lax.sort, and the host receives only a (n, D+1)
  segment-length histogram to compute window schedules from.

Reference semantics: SURVEY.md §3.1 #6 (codeHashes/hashCodes paired ragged
Arrays), re-designed for a device mesh; equality with the single-device
``table/incidence.py`` build is enforced by tests on the virtual mesh.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..hashspec import U64MAX
from ..table import sorted_table as st
from . import sharded_sorted as SS

__all__ = ["ShardedIncidence", "ShardedLabels", "build_sharded_incidence",
           "canon_labels_sharded", "split_sharded"]

_U64MAX = np.uint64(U64MAX)


def _pow2(n: int) -> int:
    return 1 << max(int(n - 1), 0).bit_length()


def _host(mesh: Mesh, x) -> np.ndarray:
    """Host copy of a (possibly non-addressable) sharded array."""
    if not getattr(x, "is_fully_addressable", True):
        rep = NamedSharding(mesh, P())
        x = jax.jit(lambda a: a, out_shardings=rep)(x)
    return np.asarray(x)


def build_sharded_incidence(dt, n_kmers: int, n_codes: int
                            ) -> "ShardedIncidence":
    """Redistribute a finished low-bit-sharded pair table (the dedup owners'
    sorted runs) into code-range-aligned forward-CSR slices with ONE
    all_to_all round: each shard splits its run by code bounds and ships the
    pieces; the receiver sorts its receipts once (n_pairs/n volume).  The
    per-shard runs then concatenate into the GLOBAL code-major sorted pair
    set, and a pair's canonical global position is pair_offsets[s] + local
    rank.  Low-bit shards hold a uniform hash-sample of ALL codes, so
    per-dest load is ~fill/n with code-range skew only; overflow is counted
    exactly and raises (never silent)."""
    mesh, n = dt.mesh, dt.n_shards
    if dt.buf_n:
        raise ValueError("finish the table first (buffered entries present)")
    bounds = SS.code_range_bounds(n_codes, n)
    splitters = jnp.asarray(bounds[1:-1].astype(np.uint64)
                            * np.uint64(max(n_kmers, 1)))
    # slice the route input to the fill bound: sort volume tracks the data
    if dt.pending_nreal is not None:
        p = dt.pending_nreal
        if not getattr(p, "is_fully_addressable", True):
            rep = NamedSharding(mesh, P())
            p = jax.jit(lambda x: jnp.max(x), out_shardings=rep)(p)
        dt.fill_bound = int(np.asarray(p).max())
        dt.pending_nreal = None
    b1 = min(_pow2(max(dt.fill_bound, 1)), dt.capacity)
    keys_in = dt.hashes[:, :b1]
    sh_d = NamedSharding(mesh, P("d"))

    def route_with(cap):
        @functools.partial(jax.shard_map, mesh=mesh, in_specs=(P("d"),),
                           out_specs=(P("d"), P("d"), P("d")),
                           check_vma=False)
        def route(keys_sh):
            keys = keys_sh[0]
            valid = keys != _U64MAX
            dest = jnp.where(valid,
                             jnp.searchsorted(splitters, keys, side="right"
                                              ).astype(jnp.int32), n)
            ds, ks = jax.lax.sort((dest, keys), dimension=0, num_keys=1)
            kp = jnp.concatenate([ks, jnp.full((cap,), _U64MAX, jnp.uint64)])
            starts = jnp.searchsorted(ds, jnp.arange(n + 1, dtype=jnp.int32)
                                      ).astype(jnp.int32)
            lanes = []
            dropped = jnp.uint32(0)
            idx = jnp.arange(cap, dtype=jnp.int32)
            for r in range(n):
                seg_len = starts[r + 1] - starts[r]
                lane = jax.lax.dynamic_slice(kp, (starts[r],), (cap,))
                lanes.append(jnp.where(idx < seg_len, lane, _U64MAX))
                dropped += jnp.maximum(seg_len - cap, 0).astype(jnp.uint32)
            send = jnp.stack(lanes)
            if n > 1:
                send = jax.lax.all_to_all(send, "d", split_axis=0,
                                          concat_axis=0, tiled=True)
            flat = jnp.sort(send.reshape(-1))
            n_real = jnp.sum(flat != _U64MAX).astype(jnp.int64)
            return flat[None], n_real[None], dropped[None]

        runs, per, drops = jax.jit(route,
                                   out_shardings=(sh_d, sh_d, sh_d))(keys_in)
        if not per.is_fully_addressable:  # multi-process: replicate scalars
            rep = NamedSharding(mesh, P())
            per, drops = jax.jit(lambda a, b: (a, b),
                                 out_shardings=(rep, rep))(per, drops)
        per_h, drops_h = jax.device_get((per, drops))
        if int(np.asarray(drops_h).sum()):
            raise SS.LaneOverflowError(
                "incidence redistribution dropped pairs (code-range lane "
                "overflow — heavy barcode skew)", auto_cap=cap)
        return runs, np.asarray(per_h, np.int64)

    # lane-overflow auto-recovery: expected-load lanes,
    # doubled and re-routed on skew (exact accounting, capped retries; the
    # route input is unchanged so a retry is pure recompute)
    cap = b1 if n == 1 else min(b1, 2 * b1 // n + 4096)
    for attempt in range(4):
        try:
            runs, per_h = route_with(cap)
            break
        except SS.LaneOverflowError:
            if cap >= b1 or attempt == 3:
                raise
            cap = min(b1, 2 * cap)
    # trim the runs to the max real width (pow2-bucketed shapes)
    Ppad = _pow2(max(int(per_h.max(initial=0)), 8))
    if Ppad < runs.shape[1]:
        runs = jax.jit(lambda x: x[:, :Ppad], out_shardings=sh_d)(runs)
    return ShardedIncidence(mesh, runs, per_h, n_kmers, n_codes)


class ShardedIncidence:
    """Code-range-sharded forward pair set + lazily built kmer-major half.

    ``keys`` (n, Ppad) u64 device-sharded: shard s holds the ascending
    code-major pair keys (``code * n_kmers + kmer``) of its code range with
    U64MAX pads; ``pair_offsets[s]`` is the global forward-CSR position of
    its first pair.  The host never holds O(n_pairs)."""

    def __init__(self, mesh: Mesh, keys, pair_counts: np.ndarray,
                 n_kmers: int, n_codes: int,
                 code_bounds: Optional[np.ndarray] = None):
        self.mesh = mesh
        self.n = mesh.devices.size
        self.keys = keys
        self.pair_counts = np.asarray(pair_counts, np.int64)
        self.pair_offsets = np.concatenate(
            [[0], np.cumsum(self.pair_counts)]).astype(np.int64)
        self.n_pairs = int(self.pair_counts.sum())
        self.n_kmers = n_kmers
        self.n_codes = n_codes
        # shard s owns codes [code_bounds[s], code_bounds[s+1]); uniform by
        # default, custom for derived incidences whose code ranges follow
        # the parent's shard partition (split_sharded)
        self.code_bounds = (np.asarray(code_bounds, np.int64)
                            if code_bounds is not None
                            else SS.code_range_bounds(n_codes, self.n))
        # lazily built kmer-major half (build_inverted)
        self.inv_keys = None   # (n, Pi) u64: kmer * n_codes + code
        self.inv_pos = None    # (n, Pi) int64: global fwd position
        self.kmer_bounds = None
        self._code_offsets = None

    @property
    def code_offsets(self) -> np.ndarray:
        """Lazy host (n_codes + 1,) forward-CSR offsets — the inc-like
        surface cluster finalization consumes (O(n_codes), never pairs)."""
        if self._code_offsets is None:
            self._code_offsets = self.code_offsets_host()
        return self._code_offsets

    # -- host views (explicit commands only; never on the cluster path) ----

    def gathered_pairs(self) -> np.ndarray:
        """Global sorted unique pair keys (code-major) — a pad-stripping
        concat, no re-sort (shards own ascending code ranges)."""
        keys = self.keys
        if not keys.is_fully_addressable:
            rep = NamedSharding(self.mesh, P())
            keys = jax.jit(lambda a: a, out_shardings=rep)(keys)
        h = np.asarray(keys).reshape(-1)
        return h[h != U64MAX]

    def to_host(self):
        """Materialize the host double-CSR Incidence (save/report surface)."""
        from ..table.incidence import incidence_from_sorted_pairs
        return incidence_from_sorted_pairs(
            self.gathered_pairs(), n_kmers=self.n_kmers, n_codes=self.n_codes)

    def code_offsets_host(self) -> np.ndarray:
        """(n_codes + 1,) int64 global forward-CSR code offsets — O(n_codes)
        host, computed shard-side (each shard searches its own run)."""
        n, nk = self.n, max(self.n_kmers, 1)
        ncpad = int(max(np.diff(self.code_bounds).max(initial=0), 1)) + 1
        starts = jax.device_put(
            jnp.asarray(self.code_bounds[:-1]), NamedSharding(self.mesh,
                                                              P("d")))

        @functools.partial(jax.shard_map, mesh=self.mesh,
                           in_specs=(P("d"), P("d")), out_specs=P("d"),
                           check_vma=False)
        def offs(keys, start):
            bounds = (start[0] + jnp.arange(ncpad, dtype=jnp.int64)
                      ).astype(jnp.uint64) * jnp.uint64(nk)
            return jnp.searchsorted(keys[0], bounds).astype(jnp.int64)[None]

        per = _host(self.mesh, jax.jit(offs)(self.keys, starts))
        out = np.zeros(self.n_codes + 1, np.int64)
        for s in range(n):
            c0, c1 = int(self.code_bounds[s]), int(self.code_bounds[s + 1])
            out[c0:c1 + 1] = per[s, :c1 - c0 + 1] + self.pair_offsets[s]
        out[self.n_codes] = self.n_pairs
        return out

    # -- the kmer-major half (distributed transpose) ------------------------

    def build_inverted(self) -> None:
        """Route (kmer-major key, global fwd position) pairs to kmer-range
        owners and sort there — ONE all_to_all, O(n_pairs/n) per shard."""
        if self.inv_keys is not None:
            return
        mesh, n = self.mesh, self.n
        nk, nc = max(self.n_kmers, 1), max(self.n_codes, 1)
        self.kmer_bounds = SS.code_range_bounds(self.n_kmers, n)
        ksplit = jnp.asarray(self.kmer_bounds[1:-1].astype(np.uint64)
                             * np.uint64(nc))
        Ppad = self.keys.shape[1]
        poff = jax.device_put(jnp.asarray(self.pair_offsets[:-1]),
                              NamedSharding(mesh, P("d")))

        def transpose_with(cap):
            return self._transpose_step(mesh, n, nk, nc, ksplit, cap, poff)

        # per-dest expected load ~Ppad/n (kmer ranks are uniform over the
        # retained set; pairs per kmer are count-band bounded, so range sums
        # average out); 2x + slack — skew doubles the lane and re-routes
        # (exact accounting, capped retries)
        cap = Ppad if n == 1 else min(Ppad, 2 * Ppad // n + 4096)
        for attempt in range(4):
            try:
                self.inv_keys, self.inv_pos = transpose_with(cap)
                return
            except SS.LaneOverflowError:
                if cap >= Ppad or attempt == 3:
                    raise
                cap = min(Ppad, 2 * cap)

    def _transpose_step(self, mesh, n, nk, nc, ksplit, cap, poff):
        @functools.partial(jax.shard_map, mesh=mesh,
                           in_specs=(P("d"), P("d")),
                           out_specs=(P("d"), P("d"), P("d")),
                           check_vma=False)
        def transpose(keys_sh, poff_sh):
            keys = keys_sh[0]
            valid = keys != _U64MAX
            code = (keys // jnp.uint64(nk))
            kmer = (keys % jnp.uint64(nk))
            pos = poff_sh[0] + jnp.arange(keys.shape[0], dtype=jnp.int64)
            key2 = jnp.where(valid, kmer * jnp.uint64(nc) + code, _U64MAX)
            posm = jnp.where(valid, pos, jnp.int64(-1))
            dest = jnp.where(valid,
                             jnp.searchsorted(ksplit, key2, side="right"
                                              ).astype(jnp.int32), n)
            ds, k2s, ps = jax.lax.sort((dest, key2, posm), dimension=0,
                                       num_keys=1)
            # contiguous per-dest segments -> (n, cap) lanes by static slices
            k2p = jnp.concatenate([k2s, jnp.full((cap,), _U64MAX, jnp.uint64)])
            psp = jnp.concatenate([ps, jnp.full((cap,), -1, jnp.int64)])
            starts = jnp.searchsorted(ds, jnp.arange(n + 1, dtype=jnp.int32)
                                      ).astype(jnp.int32)
            lanes_k, lanes_p = [], []
            dropped = jnp.uint32(0)
            idx = jnp.arange(cap, dtype=jnp.int32)
            for r in range(n):
                seg_len = starts[r + 1] - starts[r]
                lk = jax.lax.dynamic_slice(k2p, (starts[r],), (cap,))
                lp = jax.lax.dynamic_slice(psp, (starts[r],), (cap,))
                lanes_k.append(jnp.where(idx < seg_len, lk, _U64MAX))
                lanes_p.append(jnp.where(idx < seg_len, lp, -1))
                dropped += jnp.maximum(seg_len - cap, 0).astype(jnp.uint32)
            sk = jnp.stack(lanes_k)
            sp = jnp.stack(lanes_p)
            if n > 1:
                sk = jax.lax.all_to_all(sk, "d", split_axis=0, concat_axis=0,
                                        tiled=True)
                sp = jax.lax.all_to_all(sp, "d", split_axis=0, concat_axis=0,
                                        tiled=True)
            rk = sk.reshape(-1)
            rp = sp.reshape(-1)
            k2r, pr = jax.lax.sort((rk, rp), dimension=0, num_keys=1)
            return k2r[None], pr[None], dropped[None]

        sh_d = NamedSharding(mesh, P("d"))
        inv_k, inv_p, drops = jax.jit(
            transpose, out_shardings=(sh_d, sh_d, sh_d))(self.keys, poff)
        if int(_host(mesh, drops).sum()):
            raise SS.LaneOverflowError(
                "incidence transpose dropped pairs (kmer-range lane "
                "overflow — heavy kmer skew)", auto_cap=cap)
        return inv_k, inv_p

    # -- device-resident shift-join construction ---------------------------

    def shift_join_arrays(self, max_window: int):
        """Per-shard sweep arrays for the shift join, entirely on device:
        (codes_d (n, Wtot+W) int32, seg_d (n, Wtot+W) int32, pos_d
        (n, Wtot+W) int64, hist (n, D+1) host, W, Ds).

        Segments (one per kmer) sort by length DESCENDING within each shard
        — the prefix property the sweep windows rely on (positions in
        segments still live at shift distance d form a prefix) — via one
        multi-key lax.sort on (maxlen - len, key2) carrying positions.  The
        host receives only the per-shard segment-length position histogram
        (hist[s, l] = positions in segments of length l) from which window
        schedules and co-occurrence capacity derive."""
        self.build_inverted()
        mesh, n = self.mesh, self.n
        nc = max(self.n_codes, 1)
        Pi = self.inv_keys.shape[1]

        @functools.partial(jax.shard_map, mesh=mesh,
                           in_specs=(P("d"),), out_specs=P("d"),
                           check_vma=False)
        def maxlen_of(keys_sh):
            k2 = keys_sh[0]
            valid = k2 != _U64MAX
            kmer = jnp.where(valid, k2 // jnp.uint64(nc), jnp.uint64(2) ** 63)
            is_new = jnp.concatenate([jnp.ones((1,), bool),
                                      kmer[1:] != kmer[:-1]])
            i = jnp.arange(k2.shape[0], dtype=jnp.int64)
            first = jax.lax.cummax(jnp.where(is_new, i, -1))
            # last position of each segment: reverse cummin of next-start
            nxt = jnp.concatenate([jnp.where(is_new, i, jnp.int64(2) ** 62)[1:],
                                   jnp.full((1,), jnp.int64(2) ** 62)])
            last = jax.lax.cummin(nxt, reverse=True) - 1
            ln = jnp.where(valid, last - first + 1, 0)
            return jnp.max(ln).astype(jnp.int64)[None]

        D = int(_host(mesh, maxlen_of(self.inv_keys)).max(initial=0))
        if D <= 0:
            return None
        W = min(_pow2(max(Pi, 1)), max(_pow2(max_window), _pow2(4 * D)))

        @functools.partial(jax.shard_map, mesh=mesh,
                           in_specs=(P("d"), P("d")),
                           out_specs=(P("d"), P("d"), P("d"), P("d")),
                           check_vma=False)
        def reorder(keys_sh, pos_sh):
            k2 = keys_sh[0]
            pos = pos_sh[0]
            valid = k2 != _U64MAX
            kmer = jnp.where(valid, k2 // jnp.uint64(nc), jnp.uint64(2) ** 63)
            is_new = jnp.concatenate([jnp.ones((1,), bool),
                                      kmer[1:] != kmer[:-1]])
            i = jnp.arange(k2.shape[0], dtype=jnp.int64)
            first = jax.lax.cummax(jnp.where(is_new, i, -1))
            nxt = jnp.concatenate([jnp.where(is_new, i, jnp.int64(2) ** 62)[1:],
                                   jnp.full((1,), jnp.int64(2) ** 62)])
            last = jax.lax.cummin(nxt, reverse=True) - 1
            ln = jnp.where(valid, last - first + 1, 0)
            lenkey = jnp.where(valid, jnp.int64(D) - ln, jnp.int64(2) ** 62)
            lk, k2s, ps = jax.lax.sort((lenkey, k2, pos), dimension=0,
                                       num_keys=2)
            v2 = k2s != _U64MAX
            km2 = jnp.where(v2, k2s // jnp.uint64(nc), jnp.uint64(2) ** 63)
            new2 = jnp.concatenate([jnp.ones((1,), bool),
                                    km2[1:] != km2[:-1]])
            seg = jnp.where(v2, jnp.cumsum(new2.astype(jnp.int32)) - 1, -1)
            codes = jnp.where(v2, (k2s % jnp.uint64(nc)).astype(jnp.int32), 0)
            ln2 = (jnp.int64(D) - lk).astype(jnp.int64)
            hist = jnp.zeros((D + 1,), jnp.int64).at[
                jnp.clip(jnp.where(v2, ln2, 0), 0, D)].add(
                v2.astype(jnp.int64))
            pad_i = jnp.zeros((W,), jnp.int32)
            pad_l = jnp.zeros((W,), jnp.int64)
            return (jnp.concatenate([codes, pad_i])[None],
                    jnp.concatenate([seg, pad_i - 1])[None],
                    jnp.concatenate([ps, pad_l])[None],
                    hist[None])

        codes_d, seg_d, pos_d, hist = jax.jit(reorder)(self.inv_keys,
                                                       self.inv_pos)
        hist_h = _host(mesh, hist)  # (n, D+1) tiny
        Ds = [int(np.nonzero(hist_h[s])[0].max(initial=0))
              for s in range(n)]
        return codes_d, seg_d, pos_d, hist_h, W, Ds


class ShardedLabels:
    """Canonical cluster labels, device-sharded position-aligned with a
    ShardedIncidence's forward slices: ``canon`` (n, Ppad) int32 (pads hold
    junk past each shard's pair count).  The host flat view materializes
    lazily (report/split are host OUTPUT commands); ``--codeClusters`` itself
    never allocates O(n_pairs) on host."""

    def __init__(self, mesh: Mesh, canon, pair_counts: np.ndarray,
                 n_molecules: int):
        self.mesh = mesh
        self.canon = canon
        self.pair_counts = np.asarray(pair_counts, np.int64)
        self.n_pairs = int(self.pair_counts.sum())
        self.n_molecules = n_molecules
        # split+report both reduce the same (code, label) runs; cache the
        # per-incidence results so the pipeline pays ONE O(n_pairs/n) sort
        # per reduction instead of one per caller
        self._mol_inc = None        # the ShardedIncidence the caches are for
        self._mol_per = None        # mol_counts_per_shard result
        self._mol_stats = None      # molecule_stats result

    def to_host(self) -> np.ndarray:
        """Flat (n_pairs,) int32 labels in global forward-CSR order."""
        c = _host(self.mesh, self.canon)
        return np.concatenate(
            [c[s, :self.pair_counts[s]] for s in range(c.shape[0])]
        ).astype(np.int32) if self.n_pairs else np.zeros(0, np.int32)

    def molecule_stats(self, inc_sh: "ShardedIncidence"
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-molecule (code, label, size) rows, globally ascending by
        (code, canonical label) — the ``--clusterReport``/``--clusterSplit``
        aggregation computed SHARD-SIDE: each shard sorts its
        (code * K + label) keys, finds the distinct-run boundaries, and
        emits (key, run length) pairs; only O(molecules) ever crosses to
        host (codes never cross shards and shards own ascending code
        ranges, so the per-shard runs concatenate into the global order).
        The host path materializes the full CSR + flat labels instead —
        O(n_pairs) host RAM, the config-#5 wall."""
        if self._mol_stats is not None and self._mol_inc is inc_sh:
            return self._mol_stats
        mesh, n = self.mesh, self.canon.shape[0]
        nk = max(inc_sh.n_kmers, 1)
        Ppad = inc_sh.keys.shape[1]
        K = jnp.int64(Ppad + 1)
        big = jnp.int64(2) ** 62

        def combined_of(keys, canon):
            valid = keys != _U64MAX
            code = (keys // jnp.uint64(nk)).astype(jnp.int64)
            return jnp.where(valid, code * K + canon.astype(jnp.int64),
                             big + jnp.arange(Ppad, dtype=jnp.int64))

        per = self.mol_counts_per_shard(inc_sh)
        Upad = _pow2(max(int(per.max(initial=0)), 8))

        @functools.partial(jax.shard_map, mesh=mesh,
                           in_specs=(P("d"), P("d")),
                           out_specs=(P("d"), P("d")),
                           check_vma=False)
        def stats(keys_sh, canon_sh):
            s = jnp.sort(combined_of(keys_sh[0], canon_sh[0]))
            valid = s < big
            nv = jnp.sum(valid).astype(jnp.int64)
            i = jnp.arange(Ppad, dtype=jnp.int64)
            is_new = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]])
            bpos = jnp.sort(jnp.where(is_new & valid, i, nv))
            nxt = jnp.concatenate([bpos[1:], nv[None]])
            cnt = (nxt - bpos).astype(jnp.int64)   # pads: nv - nv = 0
            uv = s[jnp.clip(bpos, 0, Ppad - 1)]
            return uv[:Upad][None], cnt[:Upad][None]

        uniq, cnt = (_host(mesh, x) for x in
                     jax.jit(stats)(inc_sh.keys, self.canon))
        keys = np.concatenate([uniq[s, :per[s]] for s in range(n)]
                              ).astype(np.int64) if n else np.zeros(0, np.int64)
        sizes = np.concatenate([cnt[s, :per[s]] for s in range(n)])
        self._mol_inc = inc_sh
        self._mol_stats = (keys // int(K), keys % int(K), sizes)
        return self._mol_stats

    def mol_counts_per_shard(self, inc_sh: "ShardedIncidence") -> np.ndarray:
        """(n,) molecules owned by each shard (codes never cross shards)."""
        if self._mol_per is not None and self._mol_inc is inc_sh:
            return self._mol_per
        mesh = self.mesh
        nk = max(inc_sh.n_kmers, 1)
        Ppad = inc_sh.keys.shape[1]
        K = jnp.int64(Ppad + 1)
        big = jnp.int64(2) ** 62

        @functools.partial(jax.shard_map, mesh=mesh,
                           in_specs=(P("d"), P("d")), out_specs=P("d"),
                           check_vma=False)
        def n_mol(keys_sh, canon_sh):
            keys = keys_sh[0]
            valid = keys != _U64MAX
            code = (keys // jnp.uint64(nk)).astype(jnp.int64)
            comb = jnp.where(valid,
                             code * K + canon_sh[0].astype(jnp.int64),
                             big + jnp.arange(Ppad, dtype=jnp.int64))
            s = jnp.sort(comb)
            is_new = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]])
            return jnp.sum(is_new & (s < big)).astype(jnp.int64)[None]

        per = np.asarray(_host(mesh, jax.jit(n_mol)(inc_sh.keys,
                                                    self.canon)), np.int64)
        if self._mol_inc is not inc_sh:
            self._mol_stats = None  # stats cache belongs to the old inc
        self._mol_inc, self._mol_per = inc_sh, per
        return per


def split_sharded(inc_sh: "ShardedIncidence", labels_sh: "ShardedLabels"
                  ) -> "ShardedIncidence":
    """(code, cluster) -> new molecule codes, SHARD-SIDE (the
    ``--clusterSplit`` rewrite of SURVEY.md §3.1 #9 at config-#5 scale):
    each shard re-keys its pairs as ``molecule_id * n_kmers + kmer`` and
    re-sorts LOCALLY — molecule ids are per-shard dense ranks of the
    (code, label) keys plus the shard's molecule offset, which IS the
    global (code, label)-ascending numbering (codes never cross shards and
    shard code ranges ascend), exactly the oracle's ``split_codes``
    ordering.  The result is a ShardedIncidence over the molecule code
    axis (non-uniform code bounds = the molecule offsets); nothing
    O(n_pairs) lands on host."""
    mesh, n = inc_sh.mesh, inc_sh.n
    nk_u = jnp.uint64(max(inc_sh.n_kmers, 1))
    Ppad = inc_sh.keys.shape[1]
    K = jnp.int64(Ppad + 1)
    big = jnp.int64(2) ** 62
    per = labels_sh.mol_counts_per_shard(inc_sh)
    moff = np.concatenate([[0], np.cumsum(per)]).astype(np.int64)
    moff_d = jax.device_put(jnp.asarray(moff[:-1]),
                            NamedSharding(mesh, P("d")))

    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(P("d"), P("d"), P("d")), out_specs=P("d"),
                       check_vma=False)
    def rekey(keys_sh, canon_sh, moff_sh):
        keys = keys_sh[0]
        valid = keys != _U64MAX
        code = (keys // nk_u).astype(jnp.int64)
        comb = jnp.where(valid, code * K + canon_sh[0].astype(jnp.int64),
                         big + jnp.arange(Ppad, dtype=jnp.int64))
        s = jnp.sort(comb)
        is_new = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]])
        dense = jnp.cumsum(is_new.astype(jnp.int64)) - 1
        idx = jnp.minimum(jnp.searchsorted(s, comb, method="sort"), Ppad - 1)
        rank = dense[idx]                    # local molecule rank
        newcode = (moff_sh[0] + rank).astype(jnp.uint64)
        nkey = jnp.where(valid, newcode * nk_u + (keys % nk_u), _U64MAX)
        return jnp.sort(nkey)[None]

    new_keys = jax.jit(rekey)(inc_sh.keys, labels_sh.canon, moff_d)
    return ShardedIncidence(mesh, new_keys, inc_sh.pair_counts,
                            inc_sh.n_kmers, int(moff[-1]), code_bounds=moff)


def canon_labels_sharded(inc_sh: "ShardedIncidence", lab,
                         sharded_lab: bool = False) -> ShardedLabels:
    """Canonical per-barcode cluster ids from global min-position labels,
    computed shard-side (codes never cross shards, so per-shard dense ranks
    ARE global): local label = global min position minus the code's first
    global position; canonical id = dense rank of the label among the code's
    distinct labels (first-appearing-k-mer numbering, the oracle's).  Also
    counts distinct (code, label) pairs per shard — the molecule count —
    merged with a psum.

    ``lab`` is either the REPLICATED (n_pairs,) label vector (the default
    propagation path) or — with ``sharded_lab=True`` — a per-shard (n, Ppad)
    array position-aligned with ``inc_sh.keys`` (the block-propagation path,
    where a replicated vector would not fit: labels arrive block by block
    and are written shard-resident, never materializing O(n_pairs) anywhere
    unsharded)."""
    mesh, n = inc_sh.mesh, inc_sh.n
    nk = max(inc_sh.n_kmers, 1)
    Ppad = inc_sh.keys.shape[1]
    n_p = max(inc_sh.n_pairs, 1)
    poff = jax.device_put(jnp.asarray(inc_sh.pair_offsets[:-1]),
                          NamedSharding(mesh, P("d")))
    K = jnp.int64(Ppad + 1)
    big = jnp.int64(2) ** 62
    lab_spec = P("d") if sharded_lab else P()

    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(P("d"), lab_spec, P("d")),
                       out_specs=(P("d"), P()),
                       check_vma=False)
    def body(keys_sh, lab, poff_sh):
        keys = keys_sh[0]
        valid = keys != _U64MAX
        i = jnp.arange(Ppad, dtype=jnp.int64)
        pos = poff_sh[0] + i
        if sharded_lab:
            glab = lab[0].astype(jnp.int64)
        else:
            glab = lab[jnp.clip(pos, 0, n_p - 1)].astype(jnp.int64)
        code = keys // jnp.uint64(nk)
        is_new = jnp.concatenate([jnp.ones((1,), bool),
                                  code[1:] != code[:-1]])
        first = jax.lax.cummax(jnp.where(is_new & valid, i, -1))
        local = glab - (poff_sh[0] + first)   # local min k-mer index
        combined = jnp.where(valid, first * K + local, big + i)
        base = jnp.where(valid, first * K, big + i)
        # dense_rank(combined) - dense_rank(base) over combined's distinct
        # values (sparse._dense_rank_delta, inlined: per-shard arrays)
        s = jnp.sort(combined)
        new2 = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]])
        dense = jnp.cumsum(new2.astype(jnp.int64)) - 1
        q = jnp.concatenate([combined, base])
        idx = jnp.minimum(jnp.searchsorted(s, q, method="sort"),
                          s.shape[0] - 1)
        d = dense[idx]
        canon = jnp.where(valid, (d[:Ppad] - d[Ppad:]).astype(jnp.int32), 0)
        # distinct (code, label) pairs on this shard = molecule count share
        n_mol = jnp.sum(new2 & (s < big)).astype(jnp.int64)
        return canon[None], jax.lax.psum(n_mol, "d")

    canon, n_mol = jax.jit(body)(inc_sh.keys, lab, poff)
    return ShardedLabels(mesh, canon, inc_sh.pair_counts,
                         int(_host(mesh, n_mol)))
