"""Single-host pipeline engine: the stateful core behind the CLI.

Mirrors the reference's command-driven global state (``hash10x.c:~main`` — commands
execute sequentially against one shared table/code-table state, SURVEY.md §3.1 #1,
§4.1/§4.2 call stacks), re-expressed as an object whose methods are the commands:

    Engine.count(fqb)        ~ --readFQB       (count pass)
    Engine.histogram()       ~ --hashDist
    Engine.info()            ~ --hashInfo
    Engine.filter(lo, hi)    ~ count-band "good k-mer" selection
    Engine.incidence(fqb)    ~ code-table build (second pass over reads)
    Engine.cluster(...)      ~ --codeClusters
    Engine.split()           ~ --clusterSplit
    Engine.report(out)       ~ --clusterReport
    Engine.save/load(path)   ~ --writeHash/--readHash (checkpoint/resume, §6)

Device work (sketching, count table, clustering) runs in fixed-shape jit batches;
reads are grouped so one barcode never straddles a batch, which makes per-batch
(hash, barcode) dedup exact — count semantics are *barcode counts* (``count_mode=
"barcodes"``, the k-mer x barcode table of BASELINE.json) or raw occurrences
(``count_mode="occurrences"``, config #1's pure count table).
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .hashspec import HashSpec, U64MAX
from .core import seqhash_jnp
from .core.encode import unpack_2bit_jnp
from .table import sorted_table as st
from .table.incidence import (Incidence, build_incidence, combined_key_bits,
                              finalize_combined_pairs,
                              incidence_from_sorted_pairs, pair_keys_jit)
from .cluster import cooccur
from .io.fqb import Fqb
from .utils.timing import StageTimer

__all__ = ["Engine", "EngineConfig", "coverage_peaks"]


@jax.jit
def _split_fused(code_kmers, labels, offsets_pad, K_u, nk_u, n_real_u):
    """One-program ``--clusterSplit`` core over pow2-padded pair arrays.

    code_kmers/labels: (Np,) int32, pads past ``n_real_u``; offsets_pad:
    internal code boundaries (pad = Np, dropped by the scatter).  Returns
    (sorted split pair keys new_code * n_kmers + kmer with U64MAX pads,
    sorted distinct (code * K + label) values padded, sorted boundary
    positions padded, molecule count).  Dense ranks come from carried-
    position double sorts — no gathers, no host round trips."""
    Np = code_kmers.shape[0]
    pos = jnp.arange(Np, dtype=jnp.int32)
    valid = pos.astype(jnp.int64) < n_real_u
    marks = jnp.zeros(Np, jnp.int32).at[offsets_pad].add(1, mode="drop")
    code_of_p = jnp.cumsum(marks)
    comb = jnp.where(valid, code_of_p.astype(jnp.uint64) * K_u
                     + jnp.maximum(labels, 0).astype(jnp.uint64),
                     jnp.uint64(U64MAX))
    s, spos = jax.lax.sort((comb, pos), dimension=0, num_keys=1)
    is_new = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]]) \
        & (s != jnp.uint64(U64MAX))
    # int32 like spos: XLA's GPU rewrite of this permutation sort into a
    # scatter fails its HLO verifier when key and payload widths differ
    dense = jnp.cumsum(is_new.astype(jnp.int32)) - 1
    _, new_code = jax.lax.sort((spos, dense), dimension=0, num_keys=1)
    n_mol = jnp.sum(is_new)
    uniq_sorted = jnp.sort(jnp.where(is_new, s, jnp.uint64(U64MAX)))
    bpos = jnp.sort(jnp.where(is_new, jnp.arange(Np, dtype=jnp.int64),
                              jnp.int64(1) << 62))
    pair2 = jnp.sort(jnp.where(
        valid, new_code.astype(jnp.uint64) * nk_u
        + code_kmers.astype(jnp.uint64), jnp.uint64(U64MAX)))
    return pair2, uniq_sorted, bpos, n_mol


@jax.jit
def _split_fused_pairs(pairs, labels, K_u, nk_u, n_real_u):
    """``_split_fused`` fed from the device-resident incidence pair keys
    (engine ``_pairs_dev``): code-of-pair and kmer ids decode from the keys
    themselves — no code_kmers upload, no offsets scatter."""
    Np = pairs.shape[0]
    pos = jnp.arange(Np, dtype=jnp.int32)
    valid = pos.astype(jnp.int64) < n_real_u
    pk = jnp.where(valid, pairs % nk_u, 0)
    pc = jnp.where(valid, pairs // nk_u, 0)
    comb = jnp.where(valid, pc * K_u
                     + jnp.maximum(labels, 0).astype(jnp.uint64),
                     jnp.uint64(U64MAX))
    s, spos = jax.lax.sort((comb, pos), dimension=0, num_keys=1)
    is_new = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]]) \
        & (s != jnp.uint64(U64MAX))
    # int32 like spos: XLA's GPU rewrite of this permutation sort into a
    # scatter fails its HLO verifier when key and payload widths differ
    dense = jnp.cumsum(is_new.astype(jnp.int32)) - 1
    _, new_code = jax.lax.sort((spos, dense), dimension=0, num_keys=1)
    n_mol = jnp.sum(is_new)
    uniq_sorted = jnp.sort(jnp.where(is_new, s, jnp.uint64(U64MAX)))
    bpos = jnp.sort(jnp.where(is_new, jnp.arange(Np, dtype=jnp.int64),
                              jnp.int64(1) << 62))
    pair2 = jnp.sort(jnp.where(
        valid, new_code.astype(jnp.uint64) * nk_u + pk, jnp.uint64(U64MAX)))
    return pair2, uniq_sorted, bpos, n_mol


def coverage_peaks(hist: np.ndarray, min_frac: float = 0.05):
    """Local maxima of the (lightly smoothed) count histogram — the coverage
    peaks the reference prints to guide band selection (error / het / hom /
    repeat — SURVEY.md §3.1 #7).  Returns [(count, height)] by count."""
    h = hist.astype(np.float64)
    if len(h) < 4:
        return []
    sm = h.copy()
    sm[1:-1] = (h[:-2] + 2 * h[1:-1] + h[2:]) / 4.0
    peaks = []
    hi = sm[1:].max() if len(sm) > 1 else 0
    for c in range(2, len(sm) - 1):
        if sm[c] >= sm[c - 1] and sm[c] > sm[c + 1] and sm[c] >= min_frac * hi:
            peaks.append((c, int(hist[c])))
    return peaks


@dataclass
class EngineConfig:
    spec: HashSpec = field(default_factory=HashSpec)
    mode: str = "minimizer"          # kmer | minimizer | modimizer | syncmer
    modulus: int = 0                  # modimizer modulus (0 => w)
    syncmer_s: int = 0                # syncmer s-mer size (mode == "syncmer")
    table_bits: int = 22          # initial capacity 2^bits entries (auto-grows)
    batch_reads: int = 4096
    count_mode: str = "barcodes"     # barcodes | occurrences
    min_count: int = 2
    max_count: int = 64
    cluster_mode: str = "friend"     # friend (scalable) | pair (O(K^2) contract)
    min_share: int = 2               # pair mode: per-kmer-pair other-barcode support
    min_friend_share: int = 8        # friend mode: barcode-share threshold
    max_friends: int = 0             # 0 = uncapped (scatter-propagation path)
    emission_cap_factor: int = 4     # sketch compaction slots = factor/2 *
                                     # expected emissions per batch; also
                                     # turns the batch pre-reduction caps on;
                                     # 0 = full width everywhere; overflow
                                     # counted exactly and raises
    flush_batches: int = 16          # append-buffer capacity in batches of
                                     # pre-reduced emissions: each flush costs
                                     # one full merge sort of (table + buffer)
                                     # plus one host sync (capacity adoption),
                                     # so a larger buffer makes flushes
                                     # proportionally rarer; memory is
                                     # ~12 B/slot x flush_batches x batch slots
    n_shards: int = 1                # >1: count pass runs sharded over a device
                                     # mesh (dist/sharded_sorted); downstream
                                     # commands consume the gathered table
    lane_capacity: int = 0           # sharded paths: send-lane slots per
                                     # destination shard (0 = auto: expected
                                     # per-dest load + slack).  Auto sizing
                                     # keeps flush volume ∝ 1/n_shards but a
                                     # pathologically skewed lane (one hash/
                                     # barcode dominating a batch) can
                                     # overflow and raise mid-run; this knob
                                     # trades memory for that safety margin
    cluster_label_blocks: int = 0    # >0: distributed clustering propagates
                                     # labels in barcode-aligned blocks of ~n
                                     # pairs (config-#5 memory path)
    error_fix_min_reads: int = 0     # >0 (barcodes mode): error_fix rescues
                                     # error-band k-mers whose raw occurrence
                                     # count across the lane's reads is >= n
                                     # (sequencing errors are read-unique;
                                     # real low-coverage k-mers recur within
                                     # their molecule's reads) — the
                                     # barcode-context reading of SURVEY.md
                                     # §3.1 #12; 0 = drop-only


class Engine:
    def __init__(self, cfg: EngineConfig, log=sys.stderr):
        self.cfg = cfg
        self.table: Optional[st.SortedTable] = None
        # sharded count-pass state (n_shards > 1): the table stays
        # device-sharded through filter -> incidence; host copies materialize
        # only on explicit commands (save/write_counts/crib)
        self._dt = None     # ShardedSortedTable
        self._ret_sh = None  # (rows (n,Rpad), counts (n,Rpad), off (n,), n)
        self._retained_host: Optional[np.ndarray] = None
        self._retained_counts_host: Optional[np.ndarray] = None
        self._inc_host: Optional[Incidence] = None
        self._inc_sh = None  # dist.sharded_inc.ShardedIncidence (n_shards>1)
        # flat int32 labels aligned with inc.code_kmers (one per (code, kmer)
        # pair); sharded runs keep them device-sharded (_labels_sh) and the
        # host flat view materializes lazily; `clusters` is a lazy view
        self._labels_host: Optional[np.ndarray] = None
        self._labels_sh = None  # dist.sharded_inc.ShardedLabels
        self._split_inc_host: Optional[Incidence] = None
        self._split_inc_sh = None  # ShardedIncidence over molecule codes
        # device twins of the sorted pair-key sets (plain path): incidence
        # keys feed split without re-uploading, split keys build the split
        # CSR lazily — each avoided bounce is a pair-volume host transfer
        self._pairs_dev = None        # (u64 keys pow2-padded, n_real)
        self._split_pairs_dev = None  # (u64 keys, n_kmers, n_mol, n_pairs)
        self.split_origin: Optional[np.ndarray] = None
        # (sorted distinct code*K+label, sizes, K) — split computes it as a
        # byproduct; report reuses it instead of re-reducing the pair volume
        self._mol_cache = None
        self.n_reads_counted = 0
        self._read_len = 0
        self._filled_bound = 0
        # async exact-fill scalar for the MAIN count table only (see
        # _flush_any; other tables thread their own pending locally)
        self._pending_nreal = None
        self._cap_overflow = jnp.zeros((), jnp.uint32)
        self._step_cache = {}
        self._chunk_cache = {}
        # cheap host-side counters (no device syncs) for the bench
        self.stats = {"dispatches": 0, "flushes": 0}
        self.timer = StageTimer(log)

    def reset(self) -> None:
        """Clear analysis state (table, incidence, clusters) but keep compiled
        steps and cached device-resident read chunks — a re-count of the same
        lane then skips the host->device ingest entirely."""
        self.table = None
        self._dt = None
        self._ret_sh = None
        self._retained_host = None
        self._retained_counts_host = None
        self._inc_host = None
        self._inc_sh = None
        self._labels_host = None
        self._labels_sh = None
        self._split_inc_host = None
        self._split_inc_sh = None
        self._pairs_dev = None
        self._split_pairs_dev = None
        self.split_origin = None
        self._mol_cache = None
        self.n_reads_counted = 0
        self._filled_bound = 0
        self._pending_nreal = None
        self._cap_overflow = jnp.zeros((), jnp.uint32)
        self.stats = {"dispatches": 0, "flushes": 0}

    # -- incidence (host view is lazy; sharded runs keep it device-sharded) --------

    @property
    def inc(self) -> Optional[Incidence]:
        """Host double-CSR incidence.  Sharded runs keep the pair set
        device-sharded (``_inc_sh``, dist/sharded_inc.py); accessing this
        property materializes the host view ONCE — explicit host commands
        (save/report/split) only; the sharded cluster path never touches
        it."""
        if self._inc_host is None and self._inc_sh is not None:
            self._inc_host = self._inc_sh.to_host()
        return self._inc_host

    @inc.setter
    def inc(self, v) -> None:
        self._inc_host = v
        self._pairs_dev = None  # device twin tracks engine.incidence() only

    def _inc_any(self):
        """Whichever incidence exists, preferring the device-sharded one
        (both expose n_pairs / n_codes / n_kmers / code_offsets)."""
        return self._inc_sh if self._inc_sh is not None else self._inc_host

    @property
    def split_inc(self) -> Optional[Incidence]:
        """Host split incidence (molecule-code axis).  Sharded splits keep
        it device-sharded (``_split_inc_sh``), plain splits keep the sorted
        split pair keys on device (``_split_pairs_dev``); this view
        materializes ONCE on explicit host commands (save/tests) —
        ``--clusterSplit`` itself never allocates O(n_pairs) on host."""
        if self._split_inc_host is None and self._split_inc_sh is not None:
            self._split_inc_host = self._split_inc_sh.to_host()
        if self._split_inc_host is None and self._split_pairs_dev is not None:
            pair2, nk, n_mol, n_pairs = self._split_pairs_dev
            self._split_inc_host = incidence_from_sorted_pairs(
                pair2, n_kmers=nk, n_codes=n_mol, n_real=n_pairs)
        return self._split_inc_host

    @split_inc.setter
    def split_inc(self, v) -> None:
        """A host assignment REPLACES any sharded/device split state."""
        self._split_inc_host = v
        self._split_inc_sh = None
        self._split_pairs_dev = None

    @property
    def cluster_labels(self) -> Optional[np.ndarray]:
        """Flat int32 labels (global forward-CSR order).  Sharded cluster
        runs keep labels device-sharded; the host view materializes ONCE on
        output commands (report/split/write_clusters/save)."""
        if self._labels_host is None and self._labels_sh is not None:
            self._labels_host = self._labels_sh.to_host()
        return self._labels_host

    @cluster_labels.setter
    def cluster_labels(self, v) -> None:
        from .dist.sharded_inc import ShardedLabels
        if isinstance(v, ShardedLabels):
            self._labels_sh, self._labels_host = v, None
        else:
            self._labels_sh, self._labels_host = None, v

    # -- retained set (host view is lazy; sharded runs keep it on device) ----------

    @property
    def retained_hashes(self) -> Optional[np.ndarray]:
        """Count-band retained hashes, ascending.  On the sharded path the
        retained set lives device-sharded (``_ret_sh``); accessing this
        property gathers it to host ONCE (explicit commands only — the
        sharded incidence path never touches it)."""
        if self._retained_host is None and self._ret_sh is not None:
            self._gather_retained()
        return self._retained_host

    @retained_hashes.setter
    def retained_hashes(self, v) -> None:
        self._retained_host = v

    @property
    def retained_counts(self) -> Optional[np.ndarray]:
        if self._retained_counts_host is None and self._ret_sh is not None:
            self._gather_retained()
        return self._retained_counts_host

    @retained_counts.setter
    def retained_counts(self, v) -> None:
        self._retained_counts_host = v

    def _gather_retained(self) -> None:
        """Host copies of the sharded retained set (shards own contiguous
        ascending value ranges, so the gather is a pad-stripping concat)."""
        rows, counts_rows, off, n = self._ret_sh
        from jax.sharding import NamedSharding, PartitionSpec as P
        if not rows.is_fully_addressable:
            rep = NamedSharding(self._dt.mesh, P())
            rows, counts_rows = jax.jit(lambda a, b: (a, b),
                                        out_shardings=(rep, rep))(rows,
                                                                  counts_rows)
        h = np.asarray(rows).reshape(-1)
        c = np.asarray(counts_rows).reshape(-1)
        keep = h != U64MAX
        self._retained_host = h[keep]
        self._retained_counts_host = c[keep]

    # -- batching ------------------------------------------------------------------

    # reads per host->device transfer chunk (multiple batches are then carved
    # out ON DEVICE): a per-batch device_put would pay one host round trip
    # per batch; bulk chunks amortize it ~64x
    _CHUNK_BATCHES = 64
    # device bytes of read chunks kept resident for reuse across passes
    _CHUNK_CACHE_BYTES = 2 << 30

    @staticmethod
    @functools.partial(jax.jit, static_argnums=(3,))
    def _carve(chunk_packed, chunk_lengths, chunk_bcs, bsz: int, off, m):
        """Slice one fixed-shape batch out of a device-resident chunk and mask
        the tail rows (rows >= m belong to the next batch's barcode)."""
        W = chunk_packed.shape[1]
        pk = jax.lax.dynamic_slice(chunk_packed, (jnp.int32(off), jnp.int32(0)),
                                   (bsz, W))
        ln = jax.lax.dynamic_slice(chunk_lengths, (jnp.int32(off),), (bsz,))
        bc = jax.lax.dynamic_slice(chunk_bcs, (jnp.int32(off),), (bsz,))
        valid = jnp.arange(bsz, dtype=jnp.int32) < jnp.int32(m)
        return pk, jnp.where(valid, ln, 0), jnp.where(valid, bc, -1)

    @staticmethod
    @functools.partial(jax.jit, static_argnums=(1,))
    def _carve_nmask(chunk_nmask, bsz: int, off, m):
        Wm = chunk_nmask.shape[1]
        nm = jax.lax.dynamic_slice(chunk_nmask, (jnp.int32(off), jnp.int32(0)),
                                   (bsz, Wm))
        valid = jnp.arange(bsz, dtype=jnp.int32)[:, None] < jnp.int32(m)
        return jnp.where(valid, nm, 0)

    def _spans(self, fqb: Fqb, bsz: int = 0):
        """Barcode-sorted lane arrays + batch spans (a, b, group_id or None),
        boundaries aligned so one barcode never straddles a batch; a barcode
        with more reads than a batch streams alone as a tagged group."""
        bsz = bsz or self.cfg.batch_reads
        order = np.argsort(fqb.barcode_ids, kind="stable")
        packed_all = fqb.packed[order]
        lengths_all = fqb.lengths[order]
        bc_all = fqb.barcode_ids[order]
        nmask_all = fqb.nmask[order] if fqb.nmask is not None else None
        n = len(bc_all)
        spans = []
        i = 0
        gid = 0
        while i < n:
            j = min(i + bsz, n)
            if j < n:
                # retreat to the start of the straddling barcode
                jb = j
                while jb > i and bc_all[jb - 1] == bc_all[j] and bc_all[j] != -1:
                    jb -= 1
                if jb > i:
                    j = jb
                elif bc_all[j] != -1 and bc_all[i] == bc_all[j]:
                    # oversized barcode: stream it alone as a tagged group
                    e = i
                    while e < n and bc_all[e] == bc_all[i]:
                        e += 1
                    gid += 1
                    for a in range(i, e, bsz):
                        spans.append((a, min(a + bsz, e), gid))
                    i = e
                    continue
            spans.append((i, j, None))
            i = j
        return packed_all, lengths_all, bc_all, nmask_all, spans

    def _host_batches(self, fqb: Fqb):
        """Host-side fixed-size batches (multi-host path: every process computes
        the identical global batch schedule and contributes its local slice
        via ``make_array_from_process_local_data``)."""
        bsz = self.cfg.batch_reads
        packed_all, lengths_all, bc_all, nmask_all, spans = self._spans(fqb)
        W = packed_all.shape[1]
        for a, b, g in spans:
            m = b - a
            packed = np.zeros((bsz, W), np.uint32)
            lengths = np.zeros(bsz, np.int32)
            bcs = np.full(bsz, -1, np.int32)
            packed[:m] = packed_all[a:b]
            lengths[:m] = lengths_all[a:b]
            bcs[:m] = bc_all[a:b]
            nmask = None
            if nmask_all is not None and nmask_all[a:b].any():
                nmask = np.zeros((bsz, nmask_all.shape[1]), np.uint32)
                nmask[:m] = nmask_all[a:b]
            n_valid = int((lengths_all[a:b] > 0).sum())
            yield packed, nmask, lengths, bcs, (g, n_valid)

    def _local_shard_batches(self, fqb: Fqb):
        """Per-process input shards (SURVEY.md §3.2 DP row: "per-host input
        shards of the fqb stream").  Each process holds ITS OWN reads — shard
        files must be barcode-DISJOINT (verified by an allgather of barcode
        keys) — and contributes row block pid of every global batch, so
        batches stay barcode-aligned per process and owner-shard dedup stays
        exact.  Yields LOCAL blocks of ``batch_reads // process_count`` rows:
        (packed, nmask_or_None, lengths, GLOBAL barcode ids, (gid,
        n_valid)); the per-batch step variant (has N bases) is a global OR
        so every process picks the same jit variant (SPMD).
        Sets ``self._global_n_barcodes``."""
        from jax.experimental import multihost_utils as mu
        pc = jax.process_count()
        bsz = self.cfg.batch_reads
        if bsz % pc:
            raise ValueError("batch_reads must be divisible by the process count")
        per = bsz // pc

        # read_len must agree across processes (packed width is global shape)
        rls = np.asarray(mu.process_allgather(
            np.array([fqb.read_len], np.int64), tiled=False)).reshape(-1)
        if not (rls == rls[0]).all():
            raise ValueError(f"shard files disagree on read_len: {rls.tolist()}")

        # allgather every shard's barcode keys: verifies the files are
        # barcode-disjoint and provides the global key-rank id mapping below
        counts = np.asarray(mu.process_allgather(
            np.array([fqb.n_barcodes], np.int64), tiled=False)).reshape(-1)
        self._global_n_barcodes = int(counts.sum())
        maxb = max(int(counts.max()), 1)
        pad_keys = np.zeros(maxb, np.uint64)
        pad_keys[:fqb.n_barcodes] = fqb.barcode_keys.astype(np.uint64)
        all_keys = np.asarray(mu.process_allgather(pad_keys, tiled=False)
                              ).reshape(len(counts), maxb)
        flat_keys = np.concatenate(
            [all_keys[p, :counts[p]] for p in range(len(counts))])
        sorted_keys = np.sort(flat_keys)
        if len(flat_keys) and (sorted_keys[1:] == sorted_keys[:-1]).any():
            raise ValueError(
                "per-process fqb shards share barcodes; shard files must be "
                "barcode-disjoint (split the lane by barcode)")
        # global dense id = rank of the key in the GLOBAL sorted key set —
        # identical to the ids a single process would assign to the full lane,
        # however the lane was split
        local2global = np.searchsorted(
            sorted_keys, fqb.barcode_keys.astype(np.uint64)).astype(np.int32)
        if len(local2global) == 0:   # no barcodes: loc is all -1 below
            local2global = np.zeros(1, np.int32)

        packed_all, lengths_all, bc_all, nmask_all, spans = \
            self._spans(fqb, bsz=per)
        W = packed_all.shape[1]

        # Split local spans into normal spans and oversized-barcode groups.
        # Barcodes mode needs group ISOLATION (per-batch owner-side dedup
        # cannot dedup across a group's batches, so the engine streams groups
        # through a side table): a group's batches become process-EXCLUSIVE
        # global steps — the other processes contribute empty blocks — so the
        # side table sees only the oversized barcode's reads.  Occurrence
        # mode needs none of this; groups fold into the normal stream.
        # Counting is batch-order invariant (the LSM merge sums), so the
        # schedule change cannot alter results.
        if self.cfg.count_mode == "barcodes":
            normal = [(a, e) for a, e, g in spans if g is None]
            groups: List[List] = []
            last_g = None
            for a, e, g in spans:
                if g is None:
                    continue
                if groups and last_g == g:
                    groups[-1].append((a, e))
                else:
                    groups.append([(a, e)])
                last_g = g
        else:
            normal = [(a, e) for a, e, g in spans]
            groups = []

        pid = jax.process_index()
        shape_l = np.array([len(normal), len(groups)], np.int64)
        shapes = np.asarray(mu.process_allgather(shape_l, tiled=False)
                            ).reshape(-1, 2)
        n_norm_g = int(shapes[:, 0].max(initial=0))
        max_gr = int(shapes[:, 1].max(initial=0))
        sizes_l = np.zeros(max(max_gr, 1), np.int64)
        sizes_l[:len(groups)] = [len(g) for g in groups]
        all_sizes = np.asarray(mu.process_allgather(sizes_l, tiled=False)
                               ).reshape(len(shapes), -1)

        # global schedule: all normal batches, then each process's groups in
        # (process, group) order — identical on every process (SPMD)
        sched = [("n", b) for b in range(n_norm_g)]
        gctr = 0
        for p in range(len(shapes)):
            for gi in range(int(shapes[p, 1])):
                gctr += 1
                for j in range(int(all_sizes[p, gi])):
                    sched.append(("g", p, gi, j, gctr))

        def local_span(item):
            """This process's span for a scheduled batch, or None."""
            if item[0] == "n":
                return normal[item[1]] if item[1] < len(normal) else None
            _, p, gi, j, _ = item
            return groups[gi][j] if p == pid else None

        # per-batch global OR for the SPMD variant choice, one allgather
        hn = np.zeros(len(sched), bool)
        if nmask_all is not None:
            for b, item in enumerate(sched):
                sp_ = local_span(item)
                if sp_ is not None:
                    hn[b] = nmask_all[sp_[0]:sp_[1]].any()
        hn = np.asarray(mu.process_allgather(hn, tiled=False)).any(axis=0)

        nw = nmask_all.shape[1] if nmask_all is not None \
            else (fqb.read_len + 31) // 32
        for b, item in enumerate(sched):
            packed = np.zeros((per, W), np.uint32)
            lengths = np.zeros(per, np.int32)
            bcs = np.full(per, -1, np.int32)
            nmask = np.zeros((per, nw), np.uint32) if hn[b] else None
            n_valid = 0
            sp_ = local_span(item)
            if sp_ is not None:
                a, e = sp_
                m = e - a
                packed[:m] = packed_all[a:e]
                lengths[:m] = lengths_all[a:e]
                loc = bc_all[a:e]
                bcs[:m] = np.where(loc >= 0,
                                   local2global[np.maximum(loc, 0)], -1)
                if nmask is not None and nmask_all is not None:
                    nmask[:m] = nmask_all[a:e]
                n_valid = int((lengths_all[a:e] > 0).sum())
            gid = item[4] if item[0] == "g" else None
            yield packed, nmask, lengths, bcs, (gid, n_valid)

    def _chunks(self, fqb: Fqb):
        """Yield device-resident transfer chunks with their batch spans.

        Reads transfer in ~``_CHUNK_BATCHES``-batch chunks; fixed-shape batches
        are carved out ON DEVICE, so the steady-state loop performs no
        per-batch host->device transfer.  Yields
        ``(dp, dl, dc, dnm, [(off, m, gid, n_valid, has_n), ...])``
        where dp/dl/dc are the chunk's packed/lengths/barcode arrays (padded by
        one batch of masked rows), dnm its N-mask (or None), and each span is
        one batch: offset into the chunk, m valid rows, oversized-barcode group
        id (None normally), n_valid reads with length > 0, has_n whether the
        span has N bases — all host-computed so consumers never sync.

        Chunks are cached on device (keyed by the Fqb object) up to
        ``_CHUNK_CACHE_BYTES``, so a second pass over the same lane — the
        incidence build always is one — skips the host->device ingest
        entirely."""
        bsz = self.cfg.batch_reads
        cache_key = (id(fqb), len(fqb), bsz)
        cached = self._chunk_cache.get(cache_key)
        if cached is not None:
            yield from cached[1]
            return
        packed_all, lengths_all, bc_all, nmask_all, spans = self._spans(fqb)
        W = packed_all.shape[1]

        # group spans into transfer chunks of ~_CHUNK_BATCHES batches
        chunk_reads = bsz * self._CHUNK_BATCHES
        chunks = []  # (ca, cb, [spans])
        cur = []
        ca = 0
        for s in spans:
            if cur and s[1] - ca > chunk_reads:
                chunks.append((ca, cur[-1][1], cur))
                cur = []
                ca = s[0]
            cur.append(s)
        if cur:
            chunks.append((ca, cur[-1][1], cur))

        built = []
        built_bytes = 0
        for ca, cb, chunk_spans in chunks:
            # physical chunk rows: power-of-two batch count + one batch of
            # padding, so (a) a fixed-size slice at any span start is in-bounds
            # and (b) chunk shapes fall into <= log2(_CHUNK_BATCHES) size
            # classes — each distinct shape retraces the scan steps; padded
            # rows are length 0 / barcode -1
            nb = max(1, -(-(cb - ca) // bsz))
            rows = (1 << (nb - 1).bit_length()) * bsz + bsz
            cp = np.zeros((rows, W), np.uint32)
            cl = np.zeros(rows, np.int32)
            cc = np.full(rows, -1, np.int32)
            cp[:cb - ca] = packed_all[ca:cb]
            cl[:cb - ca] = lengths_all[ca:cb]
            cc[:cb - ca] = bc_all[ca:cb]
            dp = jax.device_put(cp)
            dl = jax.device_put(cl)
            dc = jax.device_put(cc)
            dnm = None
            if nmask_all is not None and nmask_all[ca:cb].any():
                cm = np.zeros((rows, nmask_all.shape[1]), np.uint32)
                cm[:cb - ca] = nmask_all[ca:cb]
                dnm = jax.device_put(cm)
            span_meta = []
            for a, b, g in chunk_spans:
                n_valid = int((lengths_all[a:b] > 0).sum())
                has_n = bool(nmask_all is not None and nmask_all[a:b].any())
                span_meta.append((a - ca, b - a, g, n_valid, has_n))
            entry = (dp, dl, dc, dnm, span_meta)
            built.append(entry)
            built_bytes += dp.nbytes + dl.nbytes + dc.nbytes + \
                (dnm.nbytes if dnm is not None else 0)
            yield entry
        if built_bytes <= self._CHUNK_CACHE_BYTES:
            # pin the Fqb so id() cannot be recycled while the cache lives
            self._chunk_cache[cache_key] = (fqb, built)

    def _sketch_packed(self, packed, nmask, lengths):
        """The count passes' sketch of one 2-bit packed batch
        (``seqhash_jnp.sketch_emitted``): (flat (B*R,) u64 with U64MAX pads,
        read (B*R,) int32, exact overflow count), the batch's emissions
        packed into ``R = _compact_rows`` slots per read."""
        cfg = self.cfg
        return seqhash_jnp.sketch_emitted(
            cfg.spec, unpack_2bit_jnp(packed, self._read_len, nmask), lengths,
            mode=cfg.mode, m=cfg.modulus, syncmer_s=cfg.syncmer_s,
            compact_to=self._compact_rows(self._read_len - cfg.spec.k + 1))

    def _sketch_flat(self, packed, nmask, lengths, bcs):
        """Sketch one 2-bit packed batch -> flat (hashes u64 (M,), bc int32
        (M,)) with U64MAX pads; overflow adds to the lane's overflow
        counter."""
        flat_h, read, over = self._sketch_packed(packed, nmask, lengths)
        self._cap_overflow = self._cap_overflow + over
        return flat_h, jnp.asarray(bcs)[read]

    def _dedup_slots(self, B: int, P: int, n_flat: int, factor: int = 0) -> int:
        """Static slot count for per-batch pre-reduction: the number of
        *distinct* keys a batch may produce.  ``B`` reads x ``P`` window
        positions each, ``n_flat`` actual flat width (smaller than B*P when
        the sketch packed the batch's emissions).  For minimizers the
        expected emission count is B*2P/(w+1); distinct keys are fewer
        still, so ``emission_cap_factor``
        x expected is generous headroom — overflow is counted exactly and
        raises (never silent).  Other modes get full width (no bound
        assumed)."""
        cf = factor or self.cfg.emission_cap_factor
        spec = self.cfg.spec
        if cf and self.cfg.mode == "minimizer" and spec.w > 1:
            expected = B * (2 * P // (spec.w + 1) + 1)
            return min(n_flat, ((cf * expected + 1023) // 1024) * 1024)
        return n_flat

    def _batch_slots(self, B: int, P: int, n_flat: int) -> int:
        """Per-batch buffered-entry count (minimizer mode): a batch only
        needs to hold its REAL emissions, whose TOTAL concentrates tightly
        around the B*2P/(w+1) mean over thousands of reads (per-read counts
        are independent), so mean*5/4 + 4096 is far beyond a typical batch —
        buffered pads directly size the flush merge sorts.  A homopolymer
        read emits at nearly every position (~100 emissions past the mean
        at 150 bp), so in occurrences mode a batch in which more than a few
        percent of the reads are homopolymers overflows.  The same bound
        covers barcodes mode, where it binds later: distinct (hash, barcode)
        pairs <= real emissions, and a homopolymer adds one pair.  Overflow
        raises exactly, never truncates silently."""
        spec = self.cfg.spec
        if (not self.cfg.emission_cap_factor
                or self.cfg.mode != "minimizer" or spec.w <= 1):
            return self._dedup_slots(B, P, n_flat)
        expected = B * (2 * P // (spec.w + 1) + 1)
        slots = expected + expected // 4 + 4096
        return min(n_flat, ((slots + 1023) // 1024) * 1024)

    def _compact_rows(self, P: int) -> int:
        """Emission slots per read of the count passes' sketch (0 = all P):
        ``seqhash_jnp.compact_width``, scaled by ``emission_cap_factor``
        (0 turns every cap off, this one included)."""
        cfg = self.cfg
        return seqhash_jnp.compact_width(cfg.spec, P, cfg.mode, cfg.modulus,
                                         cfg.syncmer_s,
                                         cfg.emission_cap_factor)

    # -- table plumbing (sorted-run table with host-scheduled flush/growth) --------

    def _ensure_table(self, emission_width: int) -> None:
        """Create the count table sized so flushes are RARE: the buffer holds
        ``cfg.flush_batches`` batches of appends (each flush costs one host
        sync for capacity adoption — see st.flush_grow — plus a full merge
        sort, so amortizing over many batches matters).  Capacity then follows
        the data; table_bits is only the starting point, not a tuning knob."""
        if self.table is None:
            cap = 1 << self.cfg.table_bits
            want = max(1, self.cfg.flush_batches) * emission_width
            buf_cap = max(cap, 1 << max(want - 1, 1).bit_length())
            self.table = st.make_sorted_table(cap, buf_cap)

    @staticmethod
    def _flush_any(t: "st.SortedTable", bound: int, pending):
        """Flush ``t`` without EVER blocking the pipeline: the sliced flush
        (st.flush_sliced) merges only pow2(fill) table slots with pow2(buf_n)
        buffer slots — sort volume tracks the data, not the capacity — grows
        capacity by pad-concat when needed (no spill possible), and returns
        the exact new fill as a DEVICE scalar.  We fetch it asynchronously
        and consume it at the NEXT flush (the table only changes at flushes,
        so a one-flush-stale exact count IS the current fill); until it
        lands, bound advances loosely by buf_n — no blocking per-flush host
        sync (st.flush_grow) in the loop.

        ``pending`` is the PREVIOUS flush's async exact-fill scalar for THIS
        table (or None) and the new one is returned alongside — per-table
        state threaded explicitly, because the engine runs several tables
        (main count table, incidence pair table, occurrence side pass) and a
        shared scalar would hand one table's fill to another as its bound
        (smaller-than-true bounds make flush_sliced's b1 slice drop real
        keys).  Returns (table, new_loose_bound, new_pending)."""
        if pending is not None:
            # exact fill after the previous flush — ready by now (later
            # dispatches were enqueued behind it), so this is ~one readback
            bound = int(np.asarray(pending))
        buffered = t.buf_n
        t, n_real_d = st.flush_sliced(t, bound)
        if n_real_d is not None:
            try:
                n_real_d.copy_to_host_async()
            except AttributeError:  # older jax.Array without the method
                pass
        return t, bound + buffered, n_real_d

    def _pre_append(self, n: int) -> None:
        """Make room for n more buffered entries (see _flush_any: sliced
        sync-free flush with an async exact-fill refresh).  If a single
        dispatch appends more than the whole buffer (a jnp-fallback step
        variant can have ~2x the kernel variant's slots), the buffer GROWS —
        _buf_write's dynamic_update_slice clamps offsets and would silently
        overwrite earlier appends otherwise (never-silent contract)."""
        t = self.table
        if t.buf_n + n > t.buf.shape[0]:
            self.table, self._filled_bound, self._pending_nreal = \
                self._flush_any(t, self._filled_bound, self._pending_nreal)
            self.stats["flushes"] += 1
            t = self.table
        if n > t.buf.shape[0]:
            self.table = st.grow_buf(t, n)

    def _append(self, flat_h: jnp.ndarray, weights=None) -> None:
        n = flat_h.shape[0]
        self._pre_append(n)
        if weights is None:
            self.table = st.append(self.table, flat_h)
        else:
            self.table = st.append_pairs(self.table, flat_h, weights)

    def _flushed(self) -> st.SortedTable:
        if self.table is None and self._dt is not None:
            self._gather_table()  # explicit host materialization (sharded)
        if self.table is None:
            self._ensure_table(1)
        self.table, self._filled_bound = st.flush_grow(self.table,
                                                       return_count=True)
        self._pending_nreal = None  # exact refresh supersedes any pending
        return self.table

    # -- commands ------------------------------------------------------------------

    def _finish_group(self, gtab: "st.SortedTable") -> None:
        """Flush an oversized-barcode dedup table into the main count table:
        its compacted keys are the barcode's distinct hashes, each appended
        once (padded to a power of two so append shapes stay cacheable)."""
        gtab = st.flush_grow(gtab)
        keys, _ = st.compact(gtab)
        if len(keys) == 0:
            return
        padded = np.full(1 << (len(keys) - 1).bit_length(), U64MAX, np.uint64)
        padded[:len(keys)] = keys
        self._ensure_table(len(padded))
        self._append(jnp.asarray(padded))

    def _batch_keys(self, flat_h, flat_bc):
        """Per-batch reduction of flat emissions to buffered (keys, weights).

        barcodes mode: (hash, barcode) pre-reduction on device — (distinct key,
        n-distinct-barcodes) pairs; required for barcode-count semantics, and
        the buffer then holds ~n_distinct entries instead of ~n_emissions so
        LSM flushes are ~4x rarer.  occurrences mode: pad REMOVAL only (one
        flat sort; real keys order before the U64MAX pads, which are ~5/6 of
        the flat width at w=11) — this shrinks the flush merge sorts' volume
        by the pad ratio for the cost of one device sort per batch.  Overflow
        (more distinct-or-not
        real keys than slots) is counted exactly and raises — never silent."""
        P_true = self._read_len - self.cfg.spec.k + 1
        slots = self._batch_slots(self.cfg.batch_reads, P_true,
                                  flat_h.shape[0])
        if self.cfg.count_mode == "barcodes":
            return st.dedup_pairs_weighted(flat_h, flat_bc, slots)
        srt = jnp.sort(flat_h)
        over = jnp.sum(srt[slots:] != jnp.uint64(U64MAX)).astype(jnp.uint32)
        return srt[:slots], None, over

    def _fused_count_scan(self, chunk_rows: int, nmask_w: int, S: int):
        """S batches per dispatch: lax.scan carves each batch out of the
        device-resident chunk, sketches, pre-reduces, and writes the append
        buffer — ONE dispatch for S batches, so the per-dispatch host cost
        is paid once per S batches and XLA can pipeline iterations.
        Padding batches (m=0) emit only U64MAX keys — harmless to the flush.
        ``nmask_w`` = N-mask word width (0 = batch has no N bases)."""
        cfg = self.cfg
        key = ("count_scan", chunk_rows, nmask_w, S, cfg.count_mode,
               cfg.batch_reads, self._read_len, cfg.mode, cfg.modulus,
               cfg.syncmer_s, cfg.emission_cap_factor)
        fn = self._step_cache.get(key)
        if fn is not None:
            return fn
        spec = cfg.spec
        bsz = cfg.batch_reads
        read_len = self._read_len
        P_true = read_len - spec.k + 1
        C = self._compact_rows(P_true)
        slots = self._batch_slots(bsz, P_true, bsz * (C or P_true))

        def make_body(dp, dl, dc, dnm, buf_n):
            def body(carry, xs):
                buf, bufw, over = carry
                off, m, i = xs
                pk = jax.lax.dynamic_slice(
                    dp, (off, jnp.int32(0)), (bsz, dp.shape[1]))
                ln = jax.lax.dynamic_slice(dl, (off,), (bsz,))
                bc = jax.lax.dynamic_slice(dc, (off,), (bsz,))
                valid = jnp.arange(bsz, dtype=jnp.int32) < m
                ln = jnp.where(valid, ln, 0)
                bc = jnp.where(valid, bc, -1)
                nm = None
                if dnm is not None:
                    nm = jax.lax.dynamic_slice(
                        dnm, (off, jnp.int32(0)), (bsz, dnm.shape[1]))
                    nm = jnp.where(valid[:, None], nm, 0)
                with jax.named_scope("sketch"):
                    flat_h, read, ov = self._sketch_packed(pk, nm, ln)
                flat_bc = bc[read]
                keys, wts, o = self._batch_keys(flat_h, flat_bc)
                wpos = buf_n + i * jnp.int32(slots)
                if wts is None:
                    buf, bufw = st._buf_write.__wrapped__(buf, bufw, keys,
                                                          wpos)
                else:
                    buf, bufw = st._buf_write_pairs.__wrapped__(
                        buf, bufw, keys, wts, wpos)
                return (buf, bufw, over + ov + o), None
            return body

        if nmask_w:
            def step(buf, bufw, dp, dl, dc, dnm, offs, ms, buf_n, over):
                body = make_body(dp, dl, dc, dnm, buf_n)
                (buf, bufw, over), _ = jax.lax.scan(
                    body, (buf, bufw, over),
                    (offs, ms, jnp.arange(S, dtype=jnp.int32)))
                return buf, bufw, over
        else:
            def step(buf, bufw, dp, dl, dc, offs, ms, buf_n, over):
                body = make_body(dp, dl, dc, None, buf_n)
                (buf, bufw, over), _ = jax.lax.scan(
                    body, (buf, bufw, over),
                    (offs, ms, jnp.arange(S, dtype=jnp.int32)))
                return buf, bufw, over

        fn = jax.jit(step, donate_argnums=(0, 1))
        fn.n_appended = S * slots
        fn.slots = slots
        self._step_cache[key] = fn
        return fn

    def _run_fast_spans(self, dp, dl, dc, dnm, run) -> None:
        """Dispatch one variant-uniform run of fast-path spans as scan groups
        of up to ``flush_batches`` batches each."""
        has_n = run["variant"]
        spans = run["spans"]
        S = max(1, self.cfg.flush_batches)
        nmask_w = dnm.shape[1] if (has_n and dnm is not None) else 0
        for i in range(0, len(spans), S):
            grp = spans[i:i + S]
            # scan length buckets to powers of two: a 3-span tail runs a
            # 4-iteration scan, not 16 padded iterations (pad batches cost
            # full sorts)
            S_use = 1 << max(len(grp) - 1, 0).bit_length()
            step = self._fused_count_scan(dp.shape[0], nmask_w, S_use)
            offs = np.zeros(S_use, np.int32)
            ms = np.zeros(S_use, np.int32)
            for j, (off, m) in enumerate(grp):
                offs[j], ms[j] = off, m
            self._ensure_table(step.slots)
            # room for the full S batches (pad batches write U64MAX rows past
            # the advance point; the next dispatch overwrites them — program
            # order makes that safe), but advance only by the REAL batches
            self._pre_append(step.n_appended)
            t = self.table
            args = (t.buf, t.bufw, dp, dl, dc)
            if nmask_w:
                args = args + (dnm,)
            self.stats["dispatches"] += 1
            buf, bufw, over = step(*args, jnp.asarray(offs), jnp.asarray(ms),
                                   jnp.int32(t.buf_n), self._cap_overflow)
            self.table = st.SortedTable(t.hashes, t.counts, buf, bufw,
                                        t.buf_n + len(grp) * step.slots,
                                        t.spilled)
            self._cap_overflow = over

    def count(self, fqb: Fqb, local_shard: bool = False) -> None:
        """Count pass: stream reads through the sketch into the count table.

        The steady state is fully asynchronous: scan-fused dispatches of
        ``flush_batches`` batches each appending into the device-resident
        buffer, host-scheduled LSM flushes, and occupancy growth decisions
        from a host-side upper bound — no device readback per batch.
        Oversized barcodes (more reads than a batch) arrive as tagged batch
        groups; in barcodes mode their hashes dedup across the group through
        a side sorted-table before entering the main table, so counts stay
        exact (real lanes contain pathological barcodes).

        ``local_shard=True`` (multi-process only): ``fqb`` is THIS process's
        input shard of the lane (barcode-disjoint shard files) rather than the
        full lane — the per-host-input-shards DP row of SURVEY.md §3.2."""
        if self.cfg.n_shards > 1:
            return self._count_sharded(fqb, local_shard)
        if local_shard:
            raise ValueError("local_shard input requires --shards over a "
                             "multi-process mesh")
        self._read_len = fqb.read_len
        self._cap_overflow = jnp.zeros((), jnp.uint32)
        gtab = None
        cfg = self.cfg
        bsz = cfg.batch_reads

        for dp, dl, dc, dnm, span_meta in self._chunks(fqb):
            # group consecutive fast-path spans by jit variant; oversized-
            # barcode groups (barcodes mode) break runs and stream via the
            # side dedup table
            run = None
            cur_gid = None
            for off, m, g, n_valid, has_n in span_meta:
                self.n_reads_counted += n_valid
                if g is not None and cfg.count_mode == "barcodes":
                    if run is not None:
                        self._run_fast_spans(dp, dl, dc, dnm, run)
                        run = None
                    if g != cur_gid and gtab is not None:
                        self._finish_group(gtab)
                        gtab = None
                    cur_gid = g
                    pk, ln, bc = self._carve(dp, dl, dc, bsz, off, m)
                    nm = self._carve_nmask(dnm, bsz, off, m) if has_n else None
                    flat_h, flat_bc = self._sketch_flat(pk, nm, ln, bc)
                    keys, wts, over = self._batch_keys(flat_h, flat_bc)
                    self._cap_overflow = self._cap_overflow + over
                    self._ensure_table(keys.shape[0])
                    if gtab is None:
                        w = int(keys.shape[0])
                        gtab = st.make_sorted_table(2 * w, 2 * w)
                    if gtab.buf_n + keys.shape[0] > gtab.buf.shape[0]:
                        gtab = st.flush_grow(gtab)
                    gtab = st.append_pairs(gtab, keys, wts)
                    continue
                if gtab is not None:
                    self._finish_group(gtab)
                    gtab = None
                    cur_gid = None
                variant = has_n
                if run is not None and run["variant"] != variant:
                    self._run_fast_spans(dp, dl, dc, dnm, run)
                    run = None
                if run is None:
                    run = {"variant": variant, "spans": []}
                run["spans"].append((off, m))
            if run is not None:
                self._run_fast_spans(dp, dl, dc, dnm, run)
        if gtab is not None:
            self._finish_group(gtab)
        self._finalize_count()
        if self.timer.enabled:
            t = self.table
            nf, sp = (int(x) for x in
                      jax.device_get((t.n_filled, t.spilled)))
            self.timer.stage(f"count: {self.n_reads_counted} reads, "
                             f"{nf} kmers, spilled {sp}")

    def _finalize_count(self) -> None:
        """End-of-count flush + overflow check with ONE device sync: the
        final merge is enqueued, then overflow counter and exact fill count
        come back in a single ``device_get``."""
        self._ensure_table(1)
        t = self.table
        if t.buf_n == 0:
            if int(np.asarray(self._cap_overflow)):
                self._raise_cap_overflow()
            return
        if self._pending_nreal is not None:
            self._filled_bound = int(np.asarray(self._pending_nreal))
            self._pending_nreal = None
        # fill-proportional final merge (same slicing rule as st.flush_sliced:
        # the bound is exact or a safe overestimate, so all real keys are in
        # the first b1 slots; pads beyond contribute nothing)
        b1 = min(st._pow2ceil(max(self._filled_bound, 1)), t.capacity)
        b2 = min(st._pow2ceil(max(t.buf_n, 1)), t.buf.shape[0])
        h, w, n_real_d = st._merge_full(t.hashes[:b1], t.counts[:b1],
                                        t.buf[:b2], t.bufw[:b2])
        ov, n_real = (int(x) for x in
                      jax.device_get((self._cap_overflow, n_real_d)))
        if ov:
            self._raise_cap_overflow()
        new_cap = t.capacity
        while n_real > 0.6 * new_cap:
            new_cap *= 2
        nh, nw = st._take_cap(h, w, new_cap)
        fb, fw = st._fresh_buf(t.buf, t.bufw)
        self.table = st.SortedTable(nh, nw, fb, fw, 0, t.spilled)
        self._filled_bound = n_real
        self._pending_nreal = None

    def _raise_cap_overflow(self):
        raise RuntimeError(
            "a batch overflowed its slots: more emissions than the sketch "
            f"packs (emission_cap_factor={self.cfg.emission_cap_factor} / 2 "
            "x the expected count), or more distinct keys than the batch "
            "pre-reduction holds; raise emission_cap_factor, or set it to 0 "
            "to turn every cap off")

    def _raise_pair_overflow(self):
        raise RuntimeError(
            "an incidence batch overflowed its slots: more emissions than "
            "the sketch packs, or more distinct pair keys than the batch "
            "pre-reduction holds; raise emission_cap_factor, or set it to 0 "
            "to turn every cap off")

    def _multi_feed(self, fqb: Fqb, mesh, local_shard: bool):
        """Multi-process batch feed: (to_global, local_rows, batch iterator)
        — ``to_global`` lifts one batch's local rows into a global array
        (per-batch side paths), ``local_rows`` extracts them for the stacked
        scan-fused dispatcher (``_stacked_dispatcher``).

        local_shard=False: every process loaded the FULL lane; all compute the
        identical global schedule and contribute rows [pid*per, (pid+1)*per) of
        each global batch.  local_shard=True: every process loaded only ITS
        barcode-disjoint input shard; each contributes its own per-row block
        (``_local_shard_batches``)."""
        from jax.sharding import NamedSharding, PartitionSpec as P
        sh = NamedSharding(mesh, P("d"))
        pc, pid = jax.process_count(), jax.process_index()
        if self.cfg.batch_reads % pc:
            raise ValueError("batch_reads must be divisible by the "
                             "process count")
        per = self.cfg.batch_reads // pc
        if local_shard:
            def to_global(arr):
                return jax.make_array_from_process_local_data(
                    sh, np.ascontiguousarray(arr))
            return to_global, (lambda arr: arr), \
                self._local_shard_batches(fqb)

        def local_rows(arr):
            return arr[pid * per:(pid + 1) * per]

        def to_global(arr):
            return jax.make_array_from_process_local_data(
                sh, np.ascontiguousarray(local_rows(arr)))
        return to_global, local_rows, self._host_batches(fqb)

    def _stacked_dispatcher(self, step, mesh, local_rows):
        """Multi-process scan fusion: returns ``dispatch_block(dt, block)``
        where ``block = {"variant": has_n, "items": [(packed,
        nmask, lengths, bcs), ...]}`` — the block's batches stack
        DEVICE-MAJOR into one global array per operand (each device's slice
        holds its rows of all S batches, batch-ascending) built with a single
        ``make_array_from_process_local_data``, and one ``step.scan_stacked``
        dispatch covers all of them, instead of one global-array
        construction + one jit dispatch per batch; blocks bucket to
        power-of-two lengths so
        compiles stay few, and pad batches are zero rows (length 0,
        barcode -1 — they emit nothing)."""
        from jax.sharding import NamedSharding, PartitionSpec as P
        perdev = self.cfg.batch_reads // mesh.devices.size
        shd = NamedSharding(mesh, P("d"))

        def dispatch_block(dt, block):
            items = block["items"]
            has_n = block["variant"]
            S_use = 1 << max(len(items) - 1, 0).bit_length()
            ex = local_rows(items[0][0])
            per_l, W = ex.shape
            ldc = per_l // perdev  # this process's device count

            def stacked(idx, pad, dtype, width=0):
                shape = (S_use, per_l, width) if width else (S_use, per_l)
                out = np.full(shape, pad, dtype)
                for i, it in enumerate(items):
                    out[i] = local_rows(it[idx])
                # (S, ldc, perdev, ...) -> (ldc, S, perdev, ...): each
                # device's rows contiguous, batches ascending within
                out = out.reshape((S_use, ldc, perdev) + out.shape[2:])
                out = np.moveaxis(out, 0, 1)
                return jax.make_array_from_process_local_data(
                    shd, np.ascontiguousarray(out.reshape(
                        (ldc * S_use * perdev,) + out.shape[3:])))

            gp = stacked(0, 0, np.uint32, W)
            gl = stacked(2, 0, np.int32)
            gc = stacked(3, -1, np.int32)
            gnm = stacked(1, 0, np.uint32, items[0][1].shape[1]) \
                if has_n else None
            return step.scan_stacked(dt, gp, gl, gc, gnm, S_use,
                                     len(items))

        return dispatch_block

    def _count_sharded(self, fqb: Fqb, local_shard: bool = False) -> None:
        """Sharded count with lane-overflow auto-recovery: expected-load lane
        sizing trades worst-case pads for a loud data-dependent RuntimeError
        on pathological skew (sharded_sorted.lane_cap TRADEOFF note).  At
        config-#5 scale an hours-in abort is unacceptable, so on overflow
        the pass RECOUNTS with doubled lanes (drops are
        detected at finish — per-batch detection would cost a sync per
        batch — so the failed table may be missing keys and cannot be
        patched incrementally).  Exact overflow accounting is unchanged;
        retries are capped; the grown ``lane_capacity`` sticks for later
        commands (incidence meets the same skew)."""
        from .dist.sharded_sorted import LaneOverflowError
        n0 = self.n_reads_counted
        cfg = self.cfg
        for attempt in range(4):
            try:
                return self._count_sharded_once(fqb, local_shard)
            except LaneOverflowError as e:
                if attempt == 3:
                    raise
                self.n_reads_counted = n0
                cfg.lane_capacity = 2 * (cfg.lane_capacity or e.auto_cap
                                         or 8192)
                self.timer.stage(
                    f"count[sharded]: lane overflow ({e}); retrying with "
                    f"--laneCapacity {cfg.lane_capacity}")

    def _count_sharded_once(self, fqb: Fqb, local_shard: bool = False) -> None:
        """Sharded count pass (SURVEY.md §3.2): DP read batches over the mesh,
        all_to_all emission routing to hash-owner shards, shard-parallel sorted
        flushes; the gathered global table feeds the unchanged downstream
        commands.

        Multi-process (``jax.process_count() > 1``, bootstrapped by the CLI's
        --hosts / H10X_* env via dist.multihost): the mesh spans all global
        devices, every process computes the identical batch schedule, and each
        contributes its rows of every global batch with
        ``make_array_from_process_local_data`` — the DP row of SURVEY.md §3.2."""
        from .dist import sharded as D
        from .dist import sharded_sorted as DS
        cfg = self.cfg
        if cfg.batch_reads % cfg.n_shards:
            raise ValueError("batch_reads must be divisible by n_shards")
        self._read_len = fqb.read_len
        multi = jax.process_count() > 1
        if multi:
            from .dist import multihost
            mesh = multihost.global_mesh(cfg.n_shards)
        else:
            mesh = D.make_mesh(cfg.n_shards)
        cap = max((1 << cfg.table_bits) // cfg.n_shards, 1 << 14)
        # cache the step closure: its jit wrappers hold the compiled-program
        # cache, and a fresh closure per count() re-traces every variant
        skey = ("dt_step", mesh, cfg.mode, cfg.modulus,
                fqb.read_len, cfg.count_mode, cfg.emission_cap_factor,
                cfg.syncmer_s, cfg.lane_capacity, cfg.spec)
        step = self._step_cache.get(skey)
        if step is None:
            step = DS.make_sorted_count_step(
                cfg.spec, mesh, mode=cfg.mode, modulus=cfg.modulus,
                packed_read_len=fqb.read_len, count_mode=cfg.count_mode,
                emission_cap_factor=cfg.emission_cap_factor,
                syncmer_s=cfg.syncmer_s, lane_capacity=cfg.lane_capacity)
            self._step_cache[skey] = step
        # per-shard buffer holds ~flush_batches batches of owner-side
        # pre-reduced appends (same sizing rule as the plain engine table:
        # the buffer paces the fill-proportional sliced flushes)
        width = step.recv_width(cfg.batch_reads, fqb.read_len)
        S = max(1, cfg.flush_batches)
        buf_cap = 1 << max(int(2 * S * width - 1).bit_length(), 14)
        dt = DS.ShardedSortedTable(mesh, cap, buf_cap, spec=cfg.spec)
        if multi:
            # oversized barcodes stream through a SIDE sharded table exactly
            # like the single-process branch below: group batches contain
            # ONLY the oversized barcode's reads (the batch schedule isolates
            # them — including under --readFQBShard, where other processes
            # contribute empty blocks to that group's global batches), so
            # occurrence-mode side counting + a distinct-keys merge at group
            # end is exact
            to_global, local_rows, batches = \
                self._multi_feed(fqb, mesh, local_shard)
            n_new = 0
            gside = side_step = None
            cur_gid = None
            # scan-fuse consecutive same-variant normal batches: each block
            # becomes ONE device-major stacked global array + ONE dispatch
            # (step.scan_stacked) instead of a make_array + jit per batch —
            # the multi-process port of the plain path's scan fusion
            pend = None
            dispatch_block = self._stacked_dispatcher(step, mesh, local_rows)
            for packed, nmask, lengths, bcs, meta in batches:
                gid, n_valid = meta
                n_new += n_valid
                if gid is not None and cfg.count_mode == "barcodes":
                    if pend is not None:
                        dt = dispatch_block(dt, pend)
                        pend = None
                    if side_step is None:
                        side_step = self._side_step(mesh, fqb.read_len)
                    if gid != cur_gid and gside is not None:
                        dt = self._merge_group_sharded(
                            dt, side_step.finish(gside))
                        gside = None
                    cur_gid = gid
                    if gside is None:
                        swidth = side_step.recv_width(cfg.batch_reads,
                                                      fqb.read_len)
                        gside = DS.ShardedSortedTable(
                            mesh, cap,
                            1 << max(int(2 * S * swidth - 1).bit_length(),
                                     14), spec=cfg.spec)
                    gside = side_step(
                        gside, to_global(packed), to_global(lengths),
                        to_global(bcs),
                        nmask=to_global(nmask) if nmask is not None else None)
                    continue
                if gside is not None:
                    dt = self._merge_group_sharded(dt, side_step.finish(gside))
                    gside = None
                    cur_gid = None
                variant = nmask is not None
                if pend is not None and (pend["variant"] != variant
                                         or len(pend["items"]) >= S):
                    dt = dispatch_block(dt, pend)
                    pend = None
                if pend is None:
                    pend = {"variant": variant, "items": []}
                pend["items"].append((packed, nmask, lengths, bcs))
            if pend is not None:
                dt = dispatch_block(dt, pend)
            if gside is not None:
                dt = self._merge_group_sharded(dt, side_step.finish(gside))
            if local_shard:
                from jax.experimental import multihost_utils as mu
                n_new = int(np.asarray(mu.process_allgather(
                    np.array([n_new], np.int64), tiled=False)).sum())
            self.n_reads_counted += n_new
        else:
            # single-process: scan-fused dispatches of flush_batches batches
            # each, carved on device from the (cached) bulk chunks — the same
            # discipline as the plain path (one dispatch and one pre-reduced
            # append per S batches).  Oversized barcodes (more reads
            # than a batch, barcodes mode) still stream per-batch through a
            # SIDE sharded table (occurrence semantics, same value-range
            # splitters): per-batch owner-side dedup cannot dedup ACROSS the
            # group's batches; at group end its distinct keys merge
            # shard-locally into the main table with weight 1 — bit-equal to
            # the single-device group path
            gside = side_step = None
            cur_gid = None
            bsz = cfg.batch_reads

            def dispatch_run(dt, dp, dl, dc, dnm, run):
                has_n = run["variant"]
                spans = run["spans"]
                SS = max(1, cfg.flush_batches)
                for i in range(0, len(spans), SS):
                    grp = spans[i:i + SS]
                    S_use = 1 << max(len(grp) - 1, 0).bit_length()
                    offs = np.zeros(S_use, np.int32)
                    ms = np.zeros(S_use, np.int32)
                    for j, (off, m) in enumerate(grp):
                        offs[j], ms[j] = off, m
                    dt = step.scan_spans(dt, dp, dl, dc,
                                         dnm if has_n else None, offs, ms,
                                         bsz)
                return dt

            for dp, dl, dc, dnm, span_meta in self._chunks(fqb):
                run = None
                for off, m, g, n_valid, has_n in span_meta:
                    self.n_reads_counted += n_valid
                    if g is not None and cfg.count_mode == "barcodes":
                        if run is not None:
                            dt = dispatch_run(dt, dp, dl, dc, dnm, run)
                            run = None
                        if side_step is None:
                            side_step = self._side_step(mesh, fqb.read_len)
                        if g != cur_gid and gside is not None:
                            dt = self._merge_group_sharded(
                                dt, side_step.finish(gside))
                            gside = None
                        cur_gid = g
                        if gside is None:
                            swidth = side_step.recv_width(cfg.batch_reads,
                                                          fqb.read_len)
                            gside = DS.ShardedSortedTable(
                                mesh, cap,
                                1 << max(int(2 * S * swidth - 1).bit_length(),
                                         14), spec=cfg.spec)
                        pk, ln, bc = self._carve(dp, dl, dc, bsz, off, m)
                        nm = (self._carve_nmask(dnm, bsz, off, m)
                              if has_n else None)
                        gside = side_step(gside, pk, ln, bc, nmask=nm)
                        continue
                    if gside is not None:
                        dt = self._merge_group_sharded(
                            dt, side_step.finish(gside))
                        gside = None
                        cur_gid = None
                    variant = has_n
                    if run is not None and run["variant"] != variant:
                        dt = dispatch_run(dt, dp, dl, dc, dnm, run)
                        run = None
                    if run is None:
                        run = {"variant": variant, "spans": []}
                    run["spans"].append((off, m))
                if run is not None:
                    dt = dispatch_run(dt, dp, dl, dc, dnm, run)
            if gside is not None:
                dt = self._merge_group_sharded(dt, side_step.finish(gside))
        dt = step.finish(dt)
        drops = DS.host_sum(dt, dt.route_drops)
        if drops:
            raise DS.LaneOverflowError(
                f"sharded count dropped {drops} emissions (lane/cap "
                "overflow)",
                auto_cap=cfg.lane_capacity
                or step.auto_lane_cap(cfg.batch_reads, fqb.read_len))
        if DS.host_sum(dt, dt.spilled):
            raise RuntimeError("sharded table spilled; raise --tableBits")
        # the table STAYS device-sharded: filter and incidence consume it in
        # place; host materialization happens only on explicit commands
        # (save/write_counts)
        self._dt = dt
        if self.timer.enabled:  # collective metadata: uniform across processes
            n_filled = DS.host_sum(
                dt, (dt.hashes != jnp.uint64(U64MAX)).astype(jnp.int64))
            self.timer.stage(f"count[sharded x{cfg.n_shards}]: "
                             f"{self.n_reads_counted} reads, {n_filled} kmers")

    def _merge_group_sharded(self, dt, gside):
        """Merge an oversized-barcode side table's DISTINCT keys (weight 1
        each — the barcode's distinct hashes) into the main sharded table,
        shard-locally: both tables share the value-range splitters, so key
        ranges line up and no routing is needed."""
        import functools
        from jax.sharding import PartitionSpec as P
        from .dist import sharded_sorted as DS
        if DS.host_sum(gside, gside.route_drops):
            raise DS.LaneOverflowError(
                "oversized-barcode side table dropped emissions "
                "(lane overflow)")
        if DS.host_sum(gside, gside.spilled):
            raise RuntimeError("oversized-barcode side table spilled; raise "
                               "--tableBits")
        u64max = jnp.uint64(U64MAX)

        @functools.partial(jax.shard_map, mesh=dt.mesh,
                           in_specs=(P("d"), P("d"), P("d")),
                           out_specs=(P("d"), P("d"), P("d")))
        def mg(mh, mc, sh_):
            ones = (sh_[0] != u64max).astype(jnp.uint32)
            h, c, sp = st._merge_impl.__wrapped__(mh[0], mc[0], sh_[0], ones)
            return h[None], c[None], sp[None]

        dt.hashes, dt.counts, sp = jax.jit(mg, donate_argnums=(0, 1))(
            dt.hashes, dt.counts, gside.hashes)
        dt.spilled = dt.spilled + sp
        # the merge changed the fill outside the flush discipline: any async
        # exact-fill in flight is now smaller than true (would make the next
        # sliced flush drop keys) — advance the bound and drop the pending
        dt.fill_bound = min(dt.fill_bound + gside.fill_bound, dt.capacity)
        dt.pending_nreal = None
        return dt

    def _side_step(self, mesh, read_len: int):
        """Cached occurrence-mode sharded step for oversized-barcode side
        tables (same value-range splitters as the main step)."""
        from .dist import sharded_sorted as DS
        cfg = self.cfg
        key = ("dt_side_step", mesh, cfg.mode, cfg.modulus,
               read_len, cfg.emission_cap_factor, cfg.syncmer_s,
               cfg.lane_capacity, cfg.spec)
        stp = self._step_cache.get(key)
        if stp is None:
            stp = DS.make_sorted_count_step(
                cfg.spec, mesh, mode=cfg.mode, modulus=cfg.modulus,
                packed_read_len=read_len,
                count_mode="occurrences",
                emission_cap_factor=cfg.emission_cap_factor,
                syncmer_s=cfg.syncmer_s, lane_capacity=cfg.lane_capacity)
            self._step_cache[key] = stp
        return stp

    def host_materialize(self) -> None:
        """Run every collective a host-materializing command needs, on ALL
        processes.  Multi-process CLIs write files on the coordinator only,
        but the sharded-state gathers are COLLECTIVES every process must
        enter — a coordinator-only gather deadlocks the mesh."""
        self._flushed()
        if self._inc_sh is not None:
            _ = self.inc  # replicate-gather is a collective too
        if self._labels_sh is not None:
            _ = self.cluster_labels

    def _gather_table(self) -> None:
        """Materialize the sharded table into the single-device table —
        only explicit host-materializing commands (save/write_counts/
        error_fix) pay this; filter/incidence/histogram stay sharded."""
        from .dist import sharded_sorted as DS
        if self._ret_sh is not None and self._retained_host is None:
            self._gather_retained()  # before the sharded state is dropped
        gh, gc = DS.gather_sorted_compact(self._dt)
        self._dt = None
        self._ret_sh = None
        need = 1 << max(int(len(gh)).bit_length(), 14)
        self._ensure_table(1)
        if self.table.capacity < need:
            self.table = st.grow(self.table, need)
        self.table = st.merge_counts(self._flushed(), gh, gc)
        self._filled_bound = int(np.asarray(self.table.n_filled))

    def histogram(self, max_count: int = 256) -> np.ndarray:
        if self._dt is not None and self.table is None:
            from .dist import sharded_sorted as DS
            return DS.sorted_histogram(self._dt, max_count)
        t = self._flushed()
        return np.asarray(st.count_histogram(t.hashes, t.counts, max_count))

    def info(self, out=sys.stdout) -> None:
        hist = self.histogram()
        total = int(hist.sum())
        if self._dt is not None and self.table is None:
            from .dist import sharded_sorted as DS
            dt = self._dt
            slots = dt.n_shards * dt.capacity
            nk = DS.host_sum(
                dt, (dt.hashes != jnp.uint64(U64MAX)).astype(jnp.int64))
            ov = DS.host_sum(dt, dt.spilled)
            out.write(f"table slots {slots} kmers {nk} overflow {ov}\n")
        else:
            t = self.table
            out.write(f"table slots {t.capacity} "
                      f"kmers {int(np.asarray(t.n_filled))} "
                      f"overflow {int(np.asarray(t.spilled))}\n")
        nz = np.nonzero(hist)[0]
        if len(nz):
            out.write(f"count range [{nz.min()}, {nz.max()}] distinct kmers {total}\n")
        for c, h in coverage_peaks(hist):
            out.write(f"peak count {c} kmers {h}\n")

    def write_histogram(self, out=sys.stdout, max_count: int = 256) -> None:
        hist = self.histogram(max_count)
        for c in np.nonzero(hist)[0]:
            out.write(f"{c}\t{int(hist[c])}\n")

    def _occurrence_counts(self, fqb: Fqb):
        """Sorted (hashes, raw occurrence counts) of the lane under the
        current sketch params — a second streaming pass that reuses the
        device-resident chunk cache and compiled steps (the step cache keys
        include count_mode), leaving the engine's analysis state untouched."""
        saved = (self.table, self._dt, self._ret_sh, self._filled_bound,
                 self._pending_nreal, self._cap_overflow,
                 self.n_reads_counted)
        cm = self.cfg.count_mode
        self.table = None
        self._dt = None
        self._ret_sh = None
        self._filled_bound = 0
        self._pending_nreal = None
        self._cap_overflow = jnp.zeros((), jnp.uint32)
        try:
            self.cfg.count_mode = "occurrences"
            self.count(fqb)
            occ_h, occ_c = st.compact(self._flushed())
        finally:
            self.cfg.count_mode = cm
            (self.table, self._dt, self._ret_sh, self._filled_bound,
             self._pending_nreal, self._cap_overflow,
             self.n_reads_counted) = saved
        return occ_h, occ_c

    def error_fix(self, max_count: int = 1, fqb: Optional[Fqb] = None,
                  min_reads: int = 0) -> None:
        """Error-band correction (SURVEY.md §3.1 #12, [L] confidence).

        Base semantic (reconstructed-minimal): drop k-mers with count <=
        max_count.  The table stores only hash values, which the
        multiplicative mix makes non-invertible, so neighbor-based base
        repair is impossible for the reference too.

        Barcode-context rescue (the "using barcode context" reading of the
        survey row; ``min_reads > 0`` + reads, barcodes count mode): an
        error-band k-mer there is one seen in a single GEM barcode.  A
        sequencing-error k-mer is almost always also READ-unique, while a
        real low-coverage/het k-mer recurs across its molecule's reads — so
        a second pass counts raw occurrences, and error-band k-mers with
        >= min_reads occurrences are rescued (kept).  Deterministic,
        order-free, device-resident; the rescue predicate is swappable the
        moment the reference's actual rule is readable."""
        min_reads = min_reads or self.cfg.error_fix_min_reads
        t = self._flushed()
        before = int(np.asarray(t.n_filled))
        rescued = 0
        if min_reads > 0 and fqb is not None \
                and self.cfg.count_mode == "barcodes":
            occ_h, occ_c = self._occurrence_counts(fqb)
            self.table, rescued = st.prune_rescue(
                self._flushed(), occ_h, occ_c, max_count, min_reads)
        else:
            if min_reads > 0:
                # the user asked for rescue but it cannot run — say so
                # loudly rather than silently degrading to drop-only
                why = ("no reads are loaded (rescue needs a second pass "
                       "over the lane; --errorFixReads after --readHash "
                       "alone cannot run it)" if fqb is None else
                       f"count_mode={self.cfg.count_mode!r} has no "
                       "barcode-band semantics to rescue against")
                raise RuntimeError(
                    f"errorFix rescue (min_reads={min_reads}) cannot be "
                    f"honored: {why}; rerun with reads loaded in barcodes "
                    "mode, or drop --errorFixReads for drop-only pruning")
            self.table = st.prune(t, max_count + 1)
        after = int(np.asarray(self.table.n_filled))
        self._filled_bound = after
        self._pending_nreal = None
        self.timer.stage(
            f"errorFix: dropped {before - after} kmers with count <= "
            f"{max_count}" + (f", rescued {rescued} with >= {min_reads} "
                              "occurrences" if rescued else ""))

    def filter(self, min_count: int = 0, max_count: int = 0) -> None:
        """Keep "good" k-mers whose count lies in the band (SURVEY.md §3.1 #5).

        Sharded runs filter SHARD-SIDE: the retained set stays device-sharded
        (contiguous ascending value ranges, so local rank + shard offset IS
        the canonical global k-mer id) and feeds the sharded incidence with no
        gather; the host view materializes lazily on explicit commands."""
        lo = min_count or self.cfg.min_count
        hi = max_count or self.cfg.max_count
        if self._dt is not None and self.table is None:
            return self._filter_sharded(lo, hi)
        self.retained_hashes, self.retained_counts = st.compact(self._flushed(), lo, hi)
        self.timer.stage(f"filter [{lo},{hi}]: {len(self.retained_hashes)} kmers kept")

    def _filter_sharded(self, lo: int, hi: int) -> None:
        import functools
        from jax.sharding import NamedSharding, PartitionSpec as P
        dt = self._dt
        mesh = dt.mesh
        lo_u, hi_u = jnp.uint32(lo), jnp.uint32(hi)
        u64max = jnp.uint64(U64MAX)

        def keep_of(h, c):
            return (h != u64max) & (c >= lo_u) & (c <= hi_u)

        @functools.partial(jax.shard_map, mesh=mesh,
                           in_specs=(P("d"), P("d")), out_specs=P("d"))
        def nsurv(h, c):
            return jnp.sum(keep_of(h[0], c[0])).astype(jnp.int64)[None]

        per = np.asarray(jax.jit(nsurv, out_shardings=NamedSharding(
            mesh, P()))(dt.hashes, dt.counts))
        # per-shard slices pad to one power-of-two width (few compiles);
        # survivors <= capacity so Rpad <= capacity
        Rpad = 1 << max(int(per.max(initial=0)) - 1, 1).bit_length()
        Rpad = max(min(Rpad, dt.capacity), 1)

        @functools.partial(jax.shard_map, mesh=mesh,
                           in_specs=(P("d"), P("d")),
                           out_specs=(P("d"), P("d")))
        def filt(h, c):
            keep = keep_of(h[0], c[0])
            hh = jnp.where(keep, h[0], u64max)
            cc = jnp.where(keep, c[0], 0)
            hh, cc = jax.lax.sort((hh, cc), dimension=0, num_keys=1)
            return hh[:Rpad][None], cc[:Rpad][None]

        rows, crows = jax.jit(filt)(dt.hashes, dt.counts)
        off = np.concatenate([[0], np.cumsum(per)])[:-1].astype(np.int64)
        self._ret_sh = (rows, crows, off, int(per.sum()))
        self._retained_host = None
        self._retained_counts_host = None
        self.timer.stage(f"filter[sharded x{dt.n_shards}] [{lo},{hi}]: "
                         f"{int(per.sum())} kmers kept")

    def _fused_pair_scan(self, chunk_rows: int, nmask_w: int, S: int,
                         pad_n: int, hb: int = 0):
        """S incidence batches per dispatch (see ``_fused_count_scan``):
        lax.scan carves, unpacks, sketches, keys emissions, dedups, and writes the
        append buffer.  The retained set arrives as a U64MAX-padded
        power-of-two argument so retained sizes bucket into few compiles.

        With ``hb > 0`` (combined-key lanes, ``combined_key_bits``) batches
        key as (barcode << hb) | hash — NO per-batch retained join at all;
        the rank mapping happens once on the merged distinct keys
        (``finalize_combined_pairs``).  The per-batch join (even in its
        sort-based form) was the dominant term of the warm incidence wall."""
        cfg = self.cfg
        key = ("pair_scan", chunk_rows, nmask_w, S, pad_n, hb,
               cfg.batch_reads, self._read_len, cfg.mode, cfg.modulus,
               cfg.syncmer_s, cfg.emission_cap_factor)
        fn = self._step_cache.get(key)
        if fn is not None:
            return fn
        spec = cfg.spec
        bsz = cfg.batch_reads
        read_len = self._read_len
        P_true = read_len - spec.k + 1
        C = self._compact_rows(P_true)
        # tight sizing: distinct pair keys per batch <= real emissions, the
        # same concentration bound as _batch_slots (4x headroom would inflate
        # every pair-table flush sort ~4x)
        slots = self._batch_slots(bsz, P_true, bsz * (C or P_true))

        def make_body(dp, dl, dc, dnm, retained, nk_u, buf_n):
            def body(carry, xs):
                buf, bufw, over = carry
                off, m, i = xs
                pk = jax.lax.dynamic_slice(
                    dp, (off, jnp.int32(0)), (bsz, dp.shape[1]))
                ln = jax.lax.dynamic_slice(dl, (off,), (bsz,))
                bc = jax.lax.dynamic_slice(dc, (off,), (bsz,))
                valid = jnp.arange(bsz, dtype=jnp.int32) < m
                ln = jnp.where(valid, ln, 0)
                bc = jnp.where(valid, bc, -1)
                nm = None
                if dnm is not None:
                    nm = jax.lax.dynamic_slice(
                        dnm, (off, jnp.int32(0)), (bsz, dnm.shape[1]))
                    nm = jnp.where(valid[:, None], nm, 0)
                with jax.named_scope("sketch"):
                    flat_h, read, ov = self._sketch_packed(pk, nm, ln)
                flat_bc = bc[read]
                if hb:
                    ok = (flat_h != jnp.uint64(U64MAX)) & (flat_bc >= 0)
                    raw = jnp.where(
                        ok, (flat_bc.astype(jnp.uint64) << jnp.uint64(hb))
                        | flat_h, jnp.uint64(U64MAX))
                else:
                    raw = pair_keys_jit(retained, flat_h, flat_bc, nk_u)
                keys, _, o = st.dedup_weighted(raw, slots)
                wpos = buf_n + i * jnp.int32(slots)
                buf, bufw = st._buf_write.__wrapped__(buf, bufw, keys, wpos)
                return (buf, bufw, over + ov + o), None
            return body

        if nmask_w:
            def step(buf, bufw, retained, nk_u, dp, dl, dc, dnm, offs, ms,
                     buf_n, over):
                body = make_body(dp, dl, dc, dnm, retained, nk_u, buf_n)
                (buf, bufw, over), _ = jax.lax.scan(
                    body, (buf, bufw, over),
                    (offs, ms, jnp.arange(S, dtype=jnp.int32)))
                return buf, bufw, over
        else:
            def step(buf, bufw, retained, nk_u, dp, dl, dc, offs, ms,
                     buf_n, over):
                body = make_body(dp, dl, dc, None, retained, nk_u, buf_n)
                (buf, bufw, over), _ = jax.lax.scan(
                    body, (buf, bufw, over),
                    (offs, ms, jnp.arange(S, dtype=jnp.int32)))
                return buf, bufw, over

        fn = jax.jit(step, donate_argnums=(0, 1))
        fn.n_appended = S * slots
        fn.slots = slots
        self._step_cache[key] = fn
        return fn

    def incidence(self, fqb: Fqb, local_shard: bool = False) -> None:
        """Second pass: build the deduplicated k-mer x barcode incidence.

        Device-resident end to end, scan-fused dispatches of
        ``flush_batches`` batches each: unpack, sketch, retained-rank lookup
        into u64 pair keys, dedup, and append — keys then dedup through the
        same LSM sorted-run machinery as the count pass, and CSR assembly is
        vectorized searchsorted on device (``incidence_from_sorted_pairs``).
        With ``n_shards > 1`` the pass distributes over the mesh
        (``_incidence_sharded``)."""
        if self._retained_host is None and self._ret_sh is None:
            self.filter()
        self._inc_sh = None  # a rebuild replaces any earlier sharded pair set
        if self.cfg.n_shards > 1:
            return self._incidence_sharded(fqb, local_shard)
        if local_shard:
            raise ValueError("local_shard input requires --shards over a "
                             "multi-process mesh")
        self._read_len = fqb.read_len
        self._cap_overflow = jnp.zeros((), jnp.uint32)
        n_kmers = len(self.retained_hashes)
        pad_n = 1 << max(int(n_kmers - 1).bit_length(), 10) if n_kmers else 1024
        padded = np.full(pad_n, U64MAX, np.uint64)
        padded[:n_kmers] = self.retained_hashes
        retained_d = jax.device_put(padded)
        nk_u = jnp.uint64(max(n_kmers, 1))
        # combined-key lanes skip the per-batch retained join entirely
        # (incidence.combined_key_bits; the fallback hb=0 joins per batch)
        hb = combined_key_bits(self.cfg.spec.k, fqb.n_barcodes)
        t_inc0 = time.monotonic()
        pt = None
        pt_bound = 0
        pt_pending = None  # pair table's OWN async fill (never the count table's)
        S = max(1, self.cfg.flush_batches)
        # group tags are irrelevant here: the pair table dedups globally
        for dp, dl, dc, dnm, span_meta in self._chunks(fqb):
            runs = []
            for off, m, g, n_valid, has_n in span_meta:
                if runs and runs[-1]["variant"] == has_n:
                    runs[-1]["spans"].append((off, m))
                else:
                    runs.append({"variant": has_n, "spans": [(off, m)]})
            for run in runs:
                has_n = run["variant"]
                nmask_w = dnm.shape[1] if (has_n and dnm is not None) else 0
                for i in range(0, len(run["spans"]), S):
                    grp = run["spans"][i:i + S]
                    S_use = 1 << max(len(grp) - 1, 0).bit_length()
                    step = self._fused_pair_scan(dp.shape[0], nmask_w, S_use,
                                                 pad_n, hb)
                    offs = np.zeros(S_use, np.int32)
                    ms = np.zeros(S_use, np.int32)
                    for j, (off, m) in enumerate(grp):
                        offs[j], ms[j] = off, m
                    if pt is None:
                        cap = max(1 << self.cfg.table_bits,
                                  1 << (2 * step.slots - 1).bit_length())
                        pt = st.make_sorted_table(
                            cap, max(cap, step.n_appended))
                    if pt.buf_n + step.n_appended > pt.buf.shape[0]:
                        pt, pt_bound, pt_pending = self._flush_any(
                            pt, pt_bound, pt_pending)
                        self.stats["flushes"] += 1
                    if step.n_appended > pt.buf.shape[0]:
                        pt = st.grow_buf(pt, step.n_appended)
                    args = (pt.buf, pt.bufw, retained_d, nk_u, dp, dl, dc)
                    if nmask_w:
                        args = args + (dnm,)
                    self.stats["dispatches"] += 1
                    buf, bufw, over = step(*args, jnp.asarray(offs),
                                           jnp.asarray(ms),
                                           jnp.int32(pt.buf_n),
                                           self._cap_overflow)
                    pt = st.SortedTable(pt.hashes, pt.counts, buf, bufw,
                                        pt.buf_n + len(grp) * step.slots,
                                        pt.spilled)
                    self._cap_overflow = over
        timers = os.environ.get("H10X_PHASE_TIMERS") == "1"
        if timers:
            jax.block_until_ready(pt.buf if pt is not None else retained_d)
            t_scan = time.monotonic()
        if pt is None:
            if int(np.asarray(self._cap_overflow)):
                self._raise_pair_overflow()
            pair_keys, n_real = np.zeros(0, np.uint64), 0
        else:
            # final merge + overflow check in ONE device sync; the sorted
            # distinct keys STAY on device for the CSR build (no host bounce)
            h, _, n_real_d = st._merge_full(pt.hashes, pt.counts, pt.buf,
                                            pt.bufw)
            if hb:
                # one-shot rank join + band filter over the merged keys
                h, n_real_d = finalize_combined_pairs(h, retained_d, nk_u, hb)
            ov, n_real = (int(x) for x in
                          jax.device_get((self._cap_overflow, n_real_d)))
            if ov:
                self._raise_pair_overflow()
            pair_keys = h
        if timers:
            t_fin = time.monotonic()
        self.inc = incidence_from_sorted_pairs(
            pair_keys, n_kmers=n_kmers, n_codes=fqb.n_barcodes,
            n_real=max(n_real, 0))
        # keep the sorted pair keys device-resident for split (pow2 slice of
        # the real count; the raw width is the pair table's capacity)
        if n_real > 0 and not isinstance(pair_keys, np.ndarray):
            wp = min(1 << max(int(n_real - 1).bit_length(), 4),
                     int(pair_keys.shape[0]))
            self._pairs_dev = (pair_keys[:wp], n_real)
        else:
            self._pairs_dev = None
        if timers:
            cap = 0 if pt is None else int(pt.hashes.shape[0])
            print(f"incidence phases: scan={t_scan - t_inc0:.3f}s "
                  f"merge+finalize={t_fin - t_scan:.3f}s "
                  f"csr+host={time.monotonic() - t_fin:.3f}s "
                  f"(cap={cap}, distinct={n_real if not hb else 'post-join '}"
                  f"{n_real}, hb={hb})", file=sys.stderr)
        self.timer.stage(f"incidence: {self.inc.n_pairs} pairs, "
                         f"{self.inc.n_codes} codes x {self.inc.n_kmers} kmers")

    def _incidence_sharded(self, fqb: Fqb, local_shard: bool = False) -> None:
        """Lane-overflow auto-recovery wrapper (see _count_sharded): on a
        skewed lane the pass re-runs with doubled lanes instead of aborting
        hours into a config-#5 lane."""
        from .dist.sharded_sorted import LaneOverflowError
        cfg = self.cfg
        for attempt in range(4):
            try:
                return self._incidence_sharded_once(fqb, local_shard)
            except LaneOverflowError as e:
                if attempt == 3:
                    raise
                cfg.lane_capacity = 2 * (cfg.lane_capacity or e.auto_cap
                                         or 8192)
                self.timer.stage(
                    f"incidence[sharded]: lane overflow ({e}); retrying "
                    f"with --laneCapacity {cfg.lane_capacity}")

    def _incidence_sharded_once(self, fqb: Fqb,
                                local_shard: bool = False) -> None:
        """Mesh-distributed incidence build (SURVEY.md §3.2 table-sharding row
        applied to the code-table pass): DP read batches sketch per device;
        raw (hash, barcode) emissions route to the hash's range-owner shard,
        which holds only ITS slice of the retained set (no replication) and
        maps hash -> canonical global rank; pair keys then route by low bits
        to dedup owners whose LSM flushes dedup — memory and sort work per
        shard is 1/n of the pair volume.  The gathered sorted pair set is
        identical to the single-device pass (tests)."""
        from .dist import sharded as D
        from .dist import sharded_sorted as DS
        cfg = self.cfg
        if cfg.batch_reads % cfg.n_shards:
            raise ValueError("batch_reads must be divisible by n_shards")
        self._read_len = fqb.read_len
        multi = jax.process_count() > 1
        if multi:
            from .dist import multihost
            mesh = multihost.global_mesh(cfg.n_shards)
        else:
            mesh = D.make_mesh(cfg.n_shards)
        if self._ret_sh is not None:
            # zero-gather: the shard-side filtered retained rows feed the
            # incidence directly (same value-range partition as the count
            # table, so local rank + shard offset is the canonical global id)
            rows, _, off, n_kmers = self._ret_sh
            retained_kw = {"pair_retained_sharded": (rows, off, n_kmers)}
        else:
            n_kmers = len(self.retained_hashes)
            retained_kw = {"pair_retained": self.retained_hashes}
        step = DS.make_sorted_count_step(
            cfg.spec, mesh, mode=cfg.mode, modulus=cfg.modulus,
            packed_read_len=fqb.read_len,
            count_mode="occurrences",
            emission_cap_factor=cfg.emission_cap_factor,
            syncmer_s=cfg.syncmer_s, lane_capacity=cfg.lane_capacity,
            **retained_kw)
        width = step.recv_width(cfg.batch_reads, fqb.read_len)
        cap = max((1 << cfg.table_bits) // cfg.n_shards, 1 << 14)
        S = max(1, cfg.flush_batches)
        buf_cap = 1 << max(int(2 * S * width - 1).bit_length(), 14)
        dt = DS.ShardedSortedTable(mesh, cap, buf_cap,
                                   spec=cfg.spec, routing="low")
        if multi:
            # scan-fused stacked blocks, like the count pass (group tags are
            # irrelevant here: the pair table dedups globally, so EVERY
            # consecutive same-variant run fuses)
            _, local_rows, batches = self._multi_feed(fqb, mesh, local_shard)
            dispatch_block = self._stacked_dispatcher(step, mesh, local_rows)
            pend = None
            for packed, nmask, lengths, bcs, meta in batches:
                variant = nmask is not None
                if pend is not None and (pend["variant"] != variant
                                         or len(pend["items"]) >= S):
                    dt = dispatch_block(dt, pend)
                    pend = None
                if pend is None:
                    pend = {"variant": variant, "items": []}
                pend["items"].append((packed, nmask, lengths, bcs))
            if pend is not None:
                dt = dispatch_block(dt, pend)
        else:
            # scan-fused dispatches from the cached device chunks (group
            # tags are irrelevant: the pair table dedups globally)
            bsz = cfg.batch_reads
            for dp, dl, dc, dnm, span_meta in self._chunks(fqb):
                runs = []
                for off, m, g, n_valid, has_n in span_meta:
                    v = has_n
                    if runs and runs[-1]["variant"] == v:
                        runs[-1]["spans"].append((off, m))
                    else:
                        runs.append({"variant": v, "spans": [(off, m)]})
                for run in runs:
                    has_n = run["variant"]
                    spans = run["spans"]
                    for i in range(0, len(spans), S):
                        grp = spans[i:i + S]
                        S_use = 1 << max(len(grp) - 1, 0).bit_length()
                        offs = np.zeros(S_use, np.int32)
                        ms = np.zeros(S_use, np.int32)
                        for j, (off, m) in enumerate(grp):
                            offs[j], ms[j] = off, m
                        dt = step.scan_spans(dt, dp, dl, dc,
                                             dnm if has_n else None,
                                             offs, ms, bsz)
        dt = step.finish(dt)
        drops = DS.host_sum(dt, dt.route_drops)
        if drops:
            raise DS.LaneOverflowError(
                f"sharded incidence dropped {drops} pair keys (lane/cap "
                "overflow)",
                auto_cap=cfg.lane_capacity
                or step.auto_lane_cap(cfg.batch_reads, fqb.read_len))
        if DS.host_sum(dt, dt.spilled):
            raise RuntimeError("sharded pair table spilled; raise --tableBits")
        # the pair set STAYS device-sharded: one all_to_all redistributes the
        # dedup owners' runs into code-range CSR slices; the host view (and
        # the kmer-major half) materialize lazily on explicit host commands
        # only
        from .dist import sharded_inc as SI
        n_codes = self._global_n_barcodes if local_shard else fqb.n_barcodes
        self._inc_sh = SI.build_sharded_incidence(
            dt, n_kmers=n_kmers, n_codes=n_codes)
        self._inc_host = None
        self.timer.stage(
            f"incidence[sharded x{cfg.n_shards}]: {self._inc_sh.n_pairs} "
            f"pairs, {n_codes} codes x {n_kmers} kmers")

    def cluster(self, min_share: int = 0) -> None:
        """Per-barcode molecule clustering (``--codeClusters``).

        With ``n_shards > 1`` (and the default uncapped friend mode) the
        sparse pipeline distributes over the mesh: routed co-occurrence
        shards, device-local edges, pmin-merged label propagation
        (cluster/sparse_dist.py) — identical labels to the single-device
        path."""
        inc_any = self._inc_any()
        if inc_any is None:
            raise RuntimeError("cluster requires incidence (run incidence first)")
        self._mol_cache = None  # labels are about to change
        cfg = self.cfg
        # the distributed path engages on n_shards > 1 OR whenever a
        # device-sharded incidence already exists (e.g. a 1-shard sharded
        # pipeline driven on a single chip): clustering over a
        # ShardedIncidence through the host path would materialize the host
        # CSR, defeating the device-resident contract
        if ((cfg.n_shards > 1 or self._inc_sh is not None)
                and cfg.cluster_mode == "friend" and cfg.max_friends == 0):
            from .cluster.sparse_dist import cluster_codes_sparse_dist
            from .dist import sharded as D
            if jax.process_count() > 1:
                from .dist import multihost
                mesh = multihost.global_mesh(cfg.n_shards)
            elif self._inc_sh is not None:
                mesh = self._inc_sh.mesh
            else:
                mesh = D.make_mesh(cfg.n_shards)
            # auto-engage barcode-block propagation when the replicated
            # label vector would be large (config-#5 scale; SCALING.md)
            blocks = cfg.cluster_label_blocks
            if not blocks and inc_any.n_pairs > (1 << 28):
                blocks = 1 << 26
            # a ShardedIncidence passes through device-resident: the sweep
            # arrays build on device and no O(n_pairs) host gather happens
            self.cluster_labels = cluster_codes_sparse_dist(
                inc_any, mesh, min_friend_share=cfg.min_friend_share,
                label_block_pairs=blocks, flat=True)
        else:
            self.cluster_labels = cooccur.cluster_codes(
                self.inc, min_share=min_share or cfg.min_share,
                mode=cfg.cluster_mode,
                min_friend_share=cfg.min_friend_share,
                max_friends=cfg.max_friends, flat=True)
        # molecule count = distinct (code, label) pairs — computed
        # shard-side for sharded labels (psum-merged; the host flat view
        # stays unmaterialized through --codeClusters), vectorized on device
        # otherwise (a per-code max loop was O(n_codes) host work)
        if self._labels_sh is not None:
            n_cl = self._labels_sh.n_molecules
        elif inc_any.n_pairs:
            # labels are canonical per-code ranks (0..n_c-1), so the molecule
            # count is sum over codes of (max label + 1) — one host reduceat,
            # no device round trip of the pair volume
            flat = self.cluster_labels
            offs = inc_any.code_offsets
            nz = np.flatnonzero(np.diff(offs) > 0)
            n_cl = int((np.maximum.reduceat(flat, offs[:-1][nz])
                        .astype(np.int64) + 1).sum()) if len(nz) else 0
        else:
            n_cl = 0
        self.timer.stage(f"cluster: {n_cl} molecules over "
                         f"{inc_any.n_codes} codes")

    @property
    def clusters(self) -> Optional[List[np.ndarray]]:
        """Per-code label views (compat surface; storage is the flat array)."""
        if self.cluster_labels is None:
            return None
        if self.inc is None or self.inc.n_pairs == 0:
            return [np.zeros(0, np.int32)] * (self.inc.n_codes if self.inc else 0)
        offs = self.inc.code_offsets
        flat = self.cluster_labels
        return [flat[offs[c]:offs[c + 1]] for c in range(self.inc.n_codes)]

    def _cluster_flat(self) -> np.ndarray:
        """Cluster labels as one flat array aligned with inc.code_kmers."""
        if self.inc.n_pairs == 0:
            return np.zeros(0, np.int32)
        return self.cluster_labels

    def _code_of_pair(self) -> np.ndarray:
        inc = self.inc
        return np.repeat(np.arange(inc.n_codes, dtype=np.int64),
                         np.diff(inc.code_offsets))

    def split(self) -> None:
        """Remap (code, cluster) -> new codes (``--clusterSplit``).

        ONE fused device program (``_split_fused``): boundary-scatter
        code-of-pair, (code, label) dense ranks via carried-position double
        sorts (no gathers), and the split pair set — already distinct, so no
        dedup pass — handed to the CSR build still on device, with no host
        round trip of the pair volume and no random gathers.  New
        code ids are the dense ranks of distinct (code, label) pairs in
        (code, label)-ascending order, exactly the oracle's ``split_codes``
        numbering.  Sharded runs split SHARD-SIDE (``split_sharded``): each
        shard re-keys and re-sorts its own pair slice; only the O(molecules)
        origin table crosses to host."""
        if self._labels_host is None and self._labels_sh is None:
            raise RuntimeError("split requires clusters")
        if self._labels_sh is not None and self._inc_sh is not None:
            # sharded state present -> always take the shard-side path (the
            # aggregation is byte-identical; dispatching on whether a host
            # view HAPPENED to materialize would make the O(n_pairs) host
            # cost depend on call order)
            return self._split_sharded()
        inc = self.inc
        flat = self._cluster_flat()
        if inc.n_pairs == 0:
            self.split_inc = Incidence(inc.n_kmers, 0, np.zeros(1, np.int64),
                                       np.zeros(0, np.int32),
                                       np.zeros(inc.n_kmers + 1, np.int64),
                                       np.zeros(0, np.int32))
            self.split_origin = np.zeros((0, 2), np.int32)
            self.timer.stage("split: 0 molecule codes")
            return
        n_pairs = inc.n_pairs
        K = int(flat.max()) + 1
        pd = self._pairs_dev
        if pd is not None and pd[1] == n_pairs:
            # incidence keys are still device-resident: decode code/kmer ids
            # from the keys in-program — only the labels are uploaded
            pairs_d, _ = pd
            Np = int(pairs_d.shape[0])
            lab_pad = np.zeros(Np, np.int32)
            lab_pad[:n_pairs] = flat
            pair2, uniq_sorted, bpos, n_mol_d = _split_fused_pairs(
                pairs_d, jnp.asarray(lab_pad), jnp.uint64(K),
                jnp.uint64(inc.n_kmers), jnp.int64(n_pairs))
        else:
            Np = 1 << max(int(n_pairs - 1).bit_length(), 10)
            pad32 = np.zeros(Np - n_pairs, np.int32)
            offs_in = inc.code_offsets[1:-1]
            offs_pad = np.full(1 << max(int(inc.n_codes - 1).bit_length(), 4),
                               Np, np.int64)  # Np = out of bounds -> dropped
            offs_pad[:len(offs_in)] = np.minimum(offs_in, Np)
            pair2, uniq_sorted, bpos, n_mol_d = _split_fused(
                jnp.asarray(np.concatenate([inc.code_kmers, pad32])),
                jnp.asarray(np.concatenate([flat, pad32])),
                jnp.asarray(offs_pad), jnp.uint64(K), jnp.uint64(inc.n_kmers),
                jnp.int64(n_pairs))
        n_mol = int(n_mol_d)
        # device-slice to a pow2 bucket before the pull (the padded width is
        # the PAIR volume; molecules are ~20x fewer)
        wm = min(1 << max(int(n_mol - 1).bit_length(), 4), Np)
        uniq = np.asarray(uniq_sorted[:wm])[:n_mol]
        sizes = np.diff(np.append(np.asarray(bpos[:wm])[:n_mol], n_pairs))
        self._mol_cache = (uniq, sizes, K)
        # the split CSR stays device-resident; the host view materializes
        # lazily on access (save/tests) — ``--clusterSplit`` itself moves
        # only O(molecules) to host
        self._split_inc_host = None
        self._split_inc_sh = None
        self._split_pairs_dev = (pair2, inc.n_kmers, n_mol, n_pairs)
        self.split_origin = np.stack(
            [(uniq // K).astype(np.int32), (uniq % K).astype(np.int32)], axis=1)
        self.timer.stage(f"split: {n_mol} molecule codes")

    def _split_sharded(self) -> None:
        """``--clusterSplit`` over device-sharded labels: the split pair set
        stays shard-resident (``dist.sharded_inc.split_sharded``); the host
        receives only the (molecules, 2) origin table."""
        from .dist.sharded_inc import split_sharded
        codes_m, labels_m, _ = self._labels_sh.molecule_stats(self._inc_sh)
        self._split_inc_sh = split_sharded(self._inc_sh, self._labels_sh)
        self._split_inc_host = None
        self._split_pairs_dev = None
        self.split_origin = np.stack([codes_m.astype(np.int32),
                                      labels_m.astype(np.int32)], axis=1)
        self.timer.stage(f"split: {len(codes_m)} molecule codes")

    def write_counts(self, out=sys.stdout) -> None:
        """Dump the full (hash, count) table as text, hash-ascending — the
        diffable surface for oracle differential tests against the reference
        binary (SURVEY.md §5 item 1)."""
        h, c = st.compact(self._flushed())
        for hv, cv in zip(h.tolist(), c.tolist()):
            out.write(f"{hv:x}\t{cv}\n")

    def write_clusters(self, out=sys.stdout) -> None:
        """Dump cluster assignments: one line per (code, kmer hash, cluster).
        Columns are precomputed vectorized; only the final text join touches
        Python per line."""
        if self.cluster_labels is None:
            raise RuntimeError("write_clusters requires clusters")
        rh = self.retained_hashes
        codes = self._code_of_pair()
        hashes = rh[self.inc.code_kmers]
        labels = self._cluster_flat()
        out.write("".join(
            f"{c}\t{h:x}\t{l}\n" for c, h, l in
            zip(codes.tolist(), hashes.tolist(), labels.tolist())))

    def report(self, out=sys.stdout) -> None:
        """Cluster report (``--clusterReport``): diffable text.  All counts are
        computed vectorized over the flat label array (the per-code Python loop
        was O(n_codes) numpy calls — minutes at 1M codes).  Sharded runs
        aggregate SHARD-SIDE (``_report_sharded``): the host sees only
        O(n_codes + molecules), never the pair set — config-#5 lanes can
        report without materializing the host CSR."""
        if self._labels_host is None and self._labels_sh is None:
            raise RuntimeError("report requires clusters")
        if self._labels_sh is not None and self._inc_sh is not None:
            # see split(): sharded state alone decides the path
            return self._report_sharded(out)
        inc = self.inc
        n_kmers_per_code = np.diff(inc.code_offsets)
        if inc.n_pairs and self._mol_cache is not None:
            # split already reduced the pair volume to molecule stats
            uniq, cluster_sizes, K = self._mol_cache
            cl_code = (uniq // K).astype(np.int64)
            n_clusters = np.bincount(cl_code, minlength=inc.n_codes)
        elif inc.n_pairs:
            flat = self._cluster_flat().astype(np.int64)
            code_of_p = self._code_of_pair()
            K = int(flat.max()) + 1
            combined = code_of_p * K + flat
            from .utils.dense import device_unique
            uniq, cluster_sizes = device_unique(combined, return_counts=True)
            self._mol_cache = (uniq, cluster_sizes, K)
            cl_code = uniq // K
            n_clusters = np.bincount(cl_code, minlength=inc.n_codes)
        else:
            uniq = np.zeros(0, np.int64)
            cluster_sizes = np.zeros(0, np.int64)
            cl_code = np.zeros(0, np.int64)
            n_clusters = np.zeros(inc.n_codes, np.int64)
        self._write_report_lines(out, inc.n_codes, n_kmers_per_code,
                                 n_clusters, cluster_sizes)

    def _report_sharded(self, out) -> None:
        """Report over device-sharded labels: per-code cluster sizes come
        from ``ShardedLabels.molecule_stats`` (O(molecules) host), per-code
        k-mer counts from the lazy O(n_codes) code offsets — byte-identical
        to the host path (tests), with no O(n_pairs) host allocation."""
        inc_sh = self._inc_sh
        codes_m, _, sizes_m = self._labels_sh.molecule_stats(inc_sh)
        n_kmers_per_code = np.diff(inc_sh.code_offsets)
        n_clusters = np.bincount(codes_m, minlength=inc_sh.n_codes) \
            if len(codes_m) else np.zeros(inc_sh.n_codes, np.int64)
        self._write_report_lines(out, inc_sh.n_codes, n_kmers_per_code,
                                 n_clusters, sizes_m)

    @staticmethod
    def _write_report_lines(out, n_codes, n_kmers_per_code, n_clusters,
                            cluster_sizes) -> None:
        cl_starts = np.concatenate([[0], np.cumsum(n_clusters)]).tolist()
        sizes_list = cluster_sizes.tolist()
        nk_list = n_kmers_per_code.tolist()
        ncl_list = (n_clusters.tolist() if len(n_clusters)
                    else [0] * n_codes)
        # stream in bounded chunks: the whole report is O(n_codes) text and
        # must never sit in memory twice at 1M+ codes
        CHUNK = 1 << 16
        for c0 in range(0, n_codes, CHUNK):
            c1 = min(c0 + CHUNK, n_codes)
            out.write("".join(
                f"code {c} nKmers {nk_list[c]} nClusters {ncl_list[c]} sizes "
                f"{','.join(map(str, sizes_list[cl_starts[c]:cl_starts[c + 1]]))}\n"
                for c in range(c0, c1)))

    # -- checkpoint / resume (the .hash file analog, SURVEY.md §3.1 #11) -----------

    def save(self, path) -> None:
        """Persist the FULL analysis state: count table, retained band (hashes +
        counts), incidence CSR, cluster labels, and split state — so the
        reference's ``--readHash → --clusterReport`` resume workflow (SURVEY.md
        §4.2) works with no reads on disk."""
        meta = {"spec": json.loads(self.cfg.spec.to_json()), "mode": self.cfg.mode,
                "count_mode": self.cfg.count_mode, "n_reads": self.n_reads_counted,
                "version": 2}
        h, c = st.compact(self._flushed())
        parts = {"hashes": h, "counts": c}
        if self.retained_hashes is not None:
            parts["retained"] = self.retained_hashes
            parts["retained_counts"] = (
                self.retained_counts if self.retained_counts is not None
                else np.zeros(0, np.uint32))
        if self.inc is not None:
            parts.update(inc_code_offsets=self.inc.code_offsets,
                         inc_code_kmers=self.inc.code_kmers,
                         inc_kmer_offsets=self.inc.kmer_offsets,
                         inc_kmer_codes=self.inc.kmer_codes)
            meta["inc_shape"] = [self.inc.n_kmers, self.inc.n_codes]
        if self.cluster_labels is not None:
            # labels align with inc.code_kmers (flat, code order)
            parts["cluster_labels"] = (
                self.cluster_labels if self.inc.n_pairs
                else np.zeros(0, np.int32))
        if self.split_inc is not None:
            parts.update(split_code_offsets=self.split_inc.code_offsets,
                         split_code_kmers=self.split_inc.code_kmers,
                         split_kmer_offsets=self.split_inc.kmer_offsets,
                         split_kmer_codes=self.split_inc.kmer_codes,
                         split_origin=self.split_origin)
            meta["split_shape"] = [self.split_inc.n_kmers, self.split_inc.n_codes]
        np.savez(path, meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
                 **parts)

    def load(self, path) -> None:
        """Restore a checkpoint, REPLACING current state (the reference's
        readHash loads a table, it does not sum onto live counts; use
        ``st.merge_counts`` explicitly for merging)."""
        z = np.load(path if str(path).endswith(".npz") else str(path) + ".npz")
        meta = json.loads(bytes(z["meta"]).decode())
        spec = HashSpec(**meta["spec"])
        if spec != self.cfg.spec:
            raise ValueError(f"hash file spec {spec} != engine spec {self.cfg.spec} "
                             "(tables are only comparable with identical k/w/seed)")
        n_in = len(z["hashes"])
        cap = max(1 << self.cfg.table_bits, 1 << max(n_in - 1, 1).bit_length())
        # REPLACE means replace: clear sharded-lane state too, or the lazy
        # retained_hashes property / incidence()'s _ret_sh check would
        # resurrect the pre-load lane's sharded retained set (stale data)
        self.table = None
        self._dt = None
        self._ret_sh = None
        self._inc_sh = None
        self._pending_nreal = None
        self._cap_overflow = jnp.zeros((), jnp.uint32)
        self._ensure_table(1)
        if self.table.capacity < cap:
            self.table = st.grow(self.table, cap)
        self.table = st.merge_counts(self._flushed(), z["hashes"], z["counts"])
        self._filled_bound = int(np.asarray(self.table.n_filled))
        if int(np.asarray(self.table.spilled)):
            raise RuntimeError("table spilled on load; raise --tableBits")
        self.n_reads_counted = meta["n_reads"]
        self.retained_hashes = z["retained"] if "retained" in z else None
        self.retained_counts = (
            z["retained_counts"] if "retained_counts" in z
            and len(z["retained_counts"]) else None)
        self.inc = None
        self.cluster_labels = None
        self.split_inc = None
        self.split_origin = None
        self._mol_cache = None
        if "inc_code_offsets" in z:
            nk, nc = meta["inc_shape"]
            self.inc = Incidence(nk, nc, z["inc_code_offsets"],
                                 z["inc_code_kmers"], z["inc_kmer_offsets"],
                                 z["inc_kmer_codes"])
        if "cluster_labels" in z and self.inc is not None:
            self.cluster_labels = z["cluster_labels"]
        if "split_code_offsets" in z:
            nk, nc = meta["split_shape"]
            self.split_inc = Incidence(nk, nc, z["split_code_offsets"],
                                       z["split_code_kmers"],
                                       z["split_kmer_offsets"],
                                       z["split_kmer_codes"])
            self.split_origin = z["split_origin"]
        self.timer.stage(f"load: {len(z['hashes'])} kmers"
                         + (f", {self.inc.n_pairs} pairs" if self.inc else "")
                         + (", clusters" if self.cluster_labels is not None
                            else ""))
