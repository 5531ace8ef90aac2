"""k-mer x barcode incidence (the code tables) in CSR form.

The device equivalent of the reference's paired ragged Arrays
(``codeHashes[c]`` forward / ``hashCodes[h]`` inverted — ``hash10x.c``, SURVEY.md
§3.1 #6): one deduplicated (k-mer, barcode) pair set held twice in CSR layout, once
sorted by barcode and once by k-mer.  Pairs are 0/1 incidence — this IS the "dense
k-mer x barcode count table" of BASELINE.json.

k-mer ids are canonical sorted-hash ranks over the retained (count-band filtered)
hash set, so the structure is deterministic under any read/batch/shard order
(SURVEY.md §3.3 compatibility ruling, §8.3 "deterministic parallel clustering").

Build path is device-resident end to end: pair keys (code * n_kmers + kmer, u64)
deduplicate through the LSM sorted-run machinery (``sorted_table.py`` — sort +
boundary-dedup, the same discipline as the count pass), and both CSR offset
arrays come from vectorized ``searchsorted`` over the sorted key set; only the
final arrays land on host.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..hashspec import U64MAX

__all__ = ["Incidence", "build_incidence", "incidence_from_sorted_pairs",
           "pair_keys_jit", "retained_lookup", "rank_join",
           "combined_key_bits", "finalize_combined_pairs"]

# numpy scalar, NOT jnp: a module-level jnp array would initialize the
# backend at import; np scalars lower as literals
_U64MAX = np.uint64(U64MAX)


@dataclass
class Incidence:
    n_kmers: int
    n_codes: int
    # forward CSR (codeHashes): pairs sorted by (code, kmer)
    code_offsets: np.ndarray   # (n_codes + 1,) int64
    code_kmers: np.ndarray     # (P,) int32
    # inverted CSR (hashCodes): pairs sorted by (kmer, code)
    kmer_offsets: np.ndarray   # (n_kmers + 1,) int64
    kmer_codes: np.ndarray     # (P,) int32
    # forward-CSR position of each inverted-CSR entry — falls out of the
    # inverted sort as a carried payload; None for hand-built instances
    # (cluster/sparse._forward_positions recomputes it then)
    inv2fwd: "np.ndarray | None" = None  # (P,) int32

    @property
    def n_pairs(self) -> int:
        return int(self.code_kmers.shape[0])

    def kmers_of(self, code: int) -> np.ndarray:
        return self.code_kmers[self.code_offsets[code]:self.code_offsets[code + 1]]

    def codes_of(self, kmer: int) -> np.ndarray:
        return self.kmer_codes[self.kmer_offsets[kmer]:self.kmer_offsets[kmer + 1]]


def retained_lookup(retained_hashes: np.ndarray, hashes: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Map hash values to canonical k-mer ids (rank in the sorted retained set).

    Returns (ids (…,) int32 with -1 for absent, found mask)."""
    if len(retained_hashes) == 0:
        z = np.full(hashes.shape, -1, np.int32)
        return z, np.zeros(hashes.shape, bool)
    idx = np.searchsorted(retained_hashes, hashes)
    idx_c = np.minimum(idx, len(retained_hashes) - 1)
    found = (hashes != U64MAX) & (idx < len(retained_hashes)) & \
            (retained_hashes[idx_c] == hashes)
    return np.where(found, idx_c, -1).astype(np.int32), found


def rank_join(table, queries):
    """(idx, found) for each query against a sorted u64 ``table``: idx = index
    of the largest table entry <= query (clamped to 0), found = that entry
    equals the query.  U64MAX table pads are fine (queries equal to U64MAX
    report found against them — callers mask).  Pure ``lax.sort``, chosen
    over the binary-search form (``jnp.searchsorted`` default: ~log2(T)
    random gather passes per call); which is faster on the H100 is not
    measured yet (ROADMAP Y3)."""
    T = table.shape[0]
    Q = queries.shape[0]
    key = jnp.concatenate([table, queries])
    tag = jnp.concatenate([jnp.zeros(T, jnp.int32), jnp.ones(Q, jnp.int32)])
    pos = jnp.concatenate([jnp.zeros(T, jnp.int32),
                           jnp.arange(Q, dtype=jnp.int32)])
    sk, stag, spos = jax.lax.sort((key, tag, pos), dimension=0, num_keys=2)
    is_t = stag == 0
    # equal keys sort table-first (tag 0 < 1), so the inclusive count of
    # table entries at a query position is searchsorted(..., side="right")
    rank = jnp.cumsum(is_t.astype(jnp.int32)) - 1
    # table keys ascend, so the running max of table keys seen IS table[rank]
    lastk = jax.lax.cummax(jnp.where(is_t, sk, jnp.uint64(0)))
    found = (lastk == sk) & (rank >= 0)
    idx = jnp.maximum(rank, 0)
    # back to query order: sort by (tag, pos) — queries land in the tail
    _, _, fi, qi = jax.lax.sort(
        (stag, spos, found.astype(jnp.int32), idx), dimension=0, num_keys=2)
    return qi[T:], fi[T:].astype(bool)


@jax.jit
def pair_keys_jit(retained_hashes, flat_h, flat_bc, n_kmers_u):
    """Device pair-key emission: (hash, barcode) -> code * n_kmers + kmer_id,
    U64MAX for absent hashes / invalid barcodes (the sorted-table pad, so keys
    feed straight into the LSM dedup).  This is the per-batch fallback for
    lanes whose (barcode, hash) pair does not fit one u64
    (:func:`combined_key_bits`); fitting lanes skip the per-batch join
    entirely and map ranks once at the end (:func:`finalize_combined_pairs`)."""
    idx_c, found = rank_join(retained_hashes, flat_h)
    ok = found & (flat_h != _U64MAX) & (flat_bc >= 0)
    key = (flat_bc.astype(jnp.uint64) * n_kmers_u + idx_c.astype(jnp.uint64))
    return jnp.where(ok, key, _U64MAX)


def combined_key_bits(k: int, n_codes: int) -> int:
    """Bits to shift the barcode id by so (barcode << hb) | hash fits one u64
    with U64MAX reserved as the pad, or 0 when it cannot.

    The canonical seqhash value spans 2k bits (hashspec: (x*factor1 mod 2^64)
    >> (64-2k)), so hb = 2k; every real combined key is then
    < n_codes << hb <= 2^64 - 1."""
    hb = 2 * k
    if hb >= 64:
        return 0
    if max(n_codes, 1) > (1 << (64 - hb)) - 1:
        return 0
    return hb


@functools.partial(jax.jit, static_argnames=("hb",))
def finalize_combined_pairs(keys, retained_hashes, n_kmers_u, hb: int):
    """One-shot rank mapping for combined (barcode << hb | hash) pair keys:
    join every key's hash against the sorted retained set, drop the
    out-of-band ones, and re-key survivors as code * n_kmers + rank.

    ``keys`` are the LSM pair table's merged sorted distinct keys (U64MAX
    pads).  rank(hash) is monotone in hash, so survivors stay (code, rank)-
    sorted and the final sort only squeezes out the dropped keys.  Returns
    (sorted canonical pair keys with U64MAX pads, real count)."""
    h = keys & jnp.uint64((1 << hb) - 1)
    bc = keys >> jnp.uint64(hb)
    idx, found = rank_join(retained_hashes, h)
    ok = found & (keys != _U64MAX)
    newk = jnp.sort(jnp.where(ok, bc * n_kmers_u + idx.astype(jnp.uint64),
                              _U64MAX))
    return newk, jnp.sum(newk != _U64MAX)


@functools.partial(jax.jit, static_argnames=("nbc", "nbk"))
def _csr_from_pairs(pairs, nk_u, nc_u, nbc: int, nbk: int):
    """Sorted unique pair keys (code-major, U64MAX pads) -> both CSR halves.

    Shapes are power-of-two bucketed (``pairs`` pre-padded by the caller;
    bound grids built on device from ``nbc``/``nbk`` pow2 lengths and the
    runtime nk/nc scalars), so lanes share compiles — a static-(n_kmers,
    n_codes) form would compile PER LANE.  Offset joins use the sort-based
    searchsorted: the default binary search is ~log2(N) random gather
    passes per query and the kmer grid alone is n_kmers+1 queries (not
    re-measured on the H100, ROADMAP Y3)."""
    valid = pairs != _U64MAX
    pc = jnp.where(valid, pairs // nk_u, nc_u).astype(jnp.int32)
    pk = jnp.where(valid, pairs % nk_u, 0).astype(jnp.int32)
    # grid pads carry the max bound (nc*nk / nk*nc): their offsets land at
    # n_pairs and the host slices them away
    cb = jnp.minimum(jnp.arange(nbc, dtype=jnp.uint64), nc_u) * nk_u
    code_offsets = jnp.searchsorted(pairs, cb, method="sort").astype(jnp.int64)
    # kmer-major order: one more device sort (pads stay U64MAX), carrying
    # the forward position as payload — inv2fwd falls out for free instead
    # of a dense-rank pass and two pair-volume transfers in the cluster
    # phase
    k2 = jnp.where(valid, pk.astype(jnp.uint64) * nc_u + pc.astype(jnp.uint64),
                   _U64MAX)
    keys2, inv2fwd = jax.lax.sort(
        (k2, jnp.arange(pairs.shape[0], dtype=jnp.int32)),
        dimension=0, num_keys=1)
    kb = jnp.minimum(jnp.arange(nbk, dtype=jnp.uint64), nk_u) * nc_u
    kmer_offsets = jnp.searchsorted(keys2, kb, method="sort").astype(jnp.int64)
    kmer_codes = jnp.where(keys2 != _U64MAX, keys2 % nc_u, 0).astype(jnp.int32)
    return pk, code_offsets, kmer_offsets, kmer_codes, inv2fwd


def _pow2(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 0)


def incidence_from_sorted_pairs(pairs, n_kmers: int, n_codes: int,
                                n_real: int = -1) -> Incidence:
    """Sorted unique (code-major) u64 pair keys -> double-CSR Incidence.

    ``pairs`` may be a host array of exactly the real keys or a DEVICE array
    with U64MAX pads (pass ``n_real``); the device form avoids a host->device
    re-upload of the pair volume.
    """
    if n_real < 0:
        n_real = len(pairs)
    if n_codes == 0 or n_real == 0:
        return Incidence(n_kmers, n_codes,
                         np.zeros(n_codes + 1, np.int64),
                         np.zeros(0, np.int32),
                         np.zeros(n_kmers + 1, np.int64),
                         np.zeros(0, np.int32))
    assert n_codes * n_kmers < U64MAX, "pair key space must fit u64"
    pairs_d = jnp.asarray(pairs, jnp.uint64)
    pad_n = _pow2(pairs_d.shape[0])
    if pad_n > pairs_d.shape[0]:
        pairs_d = jnp.concatenate(
            [pairs_d, jnp.full(pad_n - pairs_d.shape[0], _U64MAX, jnp.uint64)])
    pk, code_offsets, kmer_offsets, kmer_codes, inv2fwd = _csr_from_pairs(
        pairs_d, jnp.uint64(n_kmers), jnp.uint64(n_codes),
        nbc=_pow2(n_codes + 1), nbk=_pow2(n_kmers + 1))
    # device-slice to a pow2 bucket of the real count before the host pull —
    # the padded width tracks the PAIR TABLE's capacity (up to ~3x n_real),
    # and every excess byte crosses to the host
    w = min(_pow2(max(n_real, 1)), int(pk.shape[0]))
    return Incidence(
        n_kmers=n_kmers, n_codes=n_codes,
        code_offsets=np.asarray(code_offsets)[:n_codes + 1],
        code_kmers=np.asarray(pk[:w])[:n_real],
        kmer_offsets=np.asarray(kmer_offsets)[:n_kmers + 1],
        kmer_codes=np.asarray(kmer_codes[:w])[:n_real],
        inv2fwd=np.asarray(inv2fwd[:w])[:n_real],
    )


def build_incidence(kmer_ids: np.ndarray, codes: np.ndarray, n_kmers: int,
                    n_codes: int) -> Incidence:
    """Deduplicate flat (kmer id, barcode id) emissions into double-CSR incidence.

    ``kmer_ids (P,) int32`` (-1 = drop), ``codes (P,) int32`` (-1 = drop).
    One-shot entry point (tests, small lanes); the engine streams batches
    through the LSM pair table instead (``engine.incidence``) — both end in
    :func:`incidence_from_sorted_pairs`.
    """
    keep = (kmer_ids >= 0) & (codes >= 0)
    k = kmer_ids[keep].astype(np.uint64)
    c = codes[keep].astype(np.uint64)
    if n_codes == 0 or len(k) == 0:
        return incidence_from_sorted_pairs(np.zeros(0, np.uint64),
                                           n_kmers, n_codes)
    pair = c * np.uint64(n_kmers) + k                 # (code, kmer) major order
    # device sort + boundary dedup (np.unique dominated the phase at scale);
    # the deduped keys STAY on device (U64MAX pads) — no host round trip of
    # the pair volume
    uniq_d, n_real_d = _dedup_sorted_padded(jnp.asarray(pair))
    return incidence_from_sorted_pairs(uniq_d, n_kmers, n_codes,
                                       n_real=int(n_real_d))


@jax.jit
def _dedup_sorted_padded(pair):
    """Sort + boundary-dedup flat u64 keys; duplicates become U64MAX pads at
    the tail.  Returns (sorted unique keys padded, real count)."""
    s = jnp.sort(pair)
    first = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]])
    u = jnp.sort(jnp.where(first & (s != _U64MAX), s, _U64MAX))
    return u, jnp.sum(u != _U64MAX)
