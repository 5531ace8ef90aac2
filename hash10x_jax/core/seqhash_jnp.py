"""Vectorized (pure-jnp) seqhash over read batches — the device sketch path.

Reproduces ``oracle/seqhash_ref.py`` bit-for-bit on batches of reads (tests enforce
it): static shapes, no data-dependent control flow, exact uint64 arithmetic.

Layout convention: a batch is ``codes (B, L) uint8`` + ``lengths (B,) int32``; every
k-mer position grid is ``(B, P)`` with ``P = L - k + 1``.  Ragged emission is
represented as dense (hash, is_forward, emit_mask) grids; :func:`sketch_emitted`
packs a batch's emissions into ``B x C`` slots (``C << P``) for the count passes.

Reference parity map (reconstructed, SURVEY.md §3.1 #4):
* ``seqhashRCiterator``  -> :func:`kmer_grid`
* ``minimizerIterator``  -> :func:`minimizer_mask`
* ``modIterator``        -> :func:`modimizer_mask`
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..hashspec import HashSpec, U64MAX

__all__ = ["kmer_grid", "minimizer_mask", "modimizer_mask", "sketch",
           "compact_width", "compact_emissions", "sketch_emitted"]

# numpy scalar, NOT jnp: a module-level jnp array would initialize the
# backend at import; np scalars lower as literals
_U64MAX = np.uint64(U64MAX)


def _u64(x) -> jnp.ndarray:
    return jnp.asarray(x, jnp.uint64)


@functools.partial(jax.jit, static_argnums=0)
def kmer_grid(spec: HashSpec, codes: jnp.ndarray, lengths: jnp.ndarray
              ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Canonical hash of every k-mer position of every read.

    Returns ``(hashes (B,P) u64, is_forward (B,P) bool, valid (B,P) bool)``; invalid
    positions (window off the read end or containing a code > 3) carry hash U64MAX.
    """
    k, mask = spec.k, _u64(spec.mask)
    B, L = codes.shape
    P = L - k + 1
    if P < 1:
        raise ValueError(f"read length {L} < k {k}")
    c = codes.astype(jnp.uint64)

    # Forward/RC 2k-bit codes of all windows as k shifted adds (no scan: each of the
    # k terms is a slice of the same array — XLA fuses this into one pass).
    h = jnp.zeros((B, P), jnp.uint64)
    h_rc = jnp.zeros((B, P), jnp.uint64)
    for j in range(k):
        cj = c[:, j:j + P]
        h = h | (cj << jnp.uint64(2 * (k - 1 - j)))
        h_rc = h_rc | ((jnp.uint64(3) - cj) << jnp.uint64(2 * j))
    h = h & mask
    h_rc = h_rc & mask

    # Validity: window inside the read and free of invalid codes.
    bad = (codes > 3).astype(jnp.int32)
    cbad = jnp.cumsum(bad, axis=1)
    win_bad = cbad[:, k - 1:] - jnp.pad(cbad, ((0, 0), (1, 0)))[:, :P]
    pos = jnp.arange(P, dtype=jnp.int32)[None, :]
    valid = (win_bad == 0) & (pos <= (lengths[:, None] - k))

    hf = (h * _u64(spec.factor1)) >> jnp.uint64(spec.shift1)
    hr = (h_rc * _u64(spec.factor1)) >> jnp.uint64(spec.shift1)
    is_forward = hf < hr
    hashes = jnp.where(is_forward, hf, hr)
    hashes = jnp.where(valid, hashes, _U64MAX)
    return hashes, is_forward, valid


@functools.partial(jax.jit, static_argnums=0)
def minimizer_mask(spec: HashSpec, hashes: jnp.ndarray, valid: jnp.ndarray
                   ) -> jnp.ndarray:
    """Leftmost-minimum w-window minimizer emission mask over a (B, P) hash grid.

    Matches ``oracle.seqhash_ref.minimizers`` including the short/broken-run edge
    rules: invalid positions break runs; a run shorter than w emits the leftmost
    minimum of the whole run.
    """
    w = spec.w
    B, P = hashes.shape
    pos = jnp.arange(P, dtype=jnp.int32)[None, :]

    # Run segmentation: run_start[p] = index of first valid position of p's run;
    # run_end[p] = one past the last.  Computed with cummax tricks (no scan).
    is_start = valid & jnp.pad(~valid, ((0, 0), (1, 0)), constant_values=True)[:, :P]
    start_idx = jnp.where(is_start, pos, -1)
    run_start = jax.lax.cummax(start_idx, axis=1)                      # (B,P)
    is_end = valid & jnp.pad(~valid, ((0, 0), (0, 1)), constant_values=True)[:, 1:]
    end_idx = jnp.where(is_end, pos, P + 1)
    run_end = jax.lax.cummin(end_idx, axis=1, reverse=True) + 1        # (B,P)
    run_len = jnp.where(valid, run_end - run_start, 0)

    # Effective window size per position's run, and valid window starts:
    # starts s with  run_start <= s <= max(run_end - w, run_start).
    ww = jnp.minimum(run_len, w)                                       # per-position
    last_start = jnp.maximum(run_end - w, run_start)
    is_win_start = valid & (pos <= last_start)

    # Leftmost argmin over [s, s + ww) via an unrolled scan over window offset.
    best_val = jnp.where(is_win_start, hashes, _U64MAX)
    best_idx = pos
    wmax = min(w, P)
    for j in range(1, wmax):
        cand = jnp.where(pos + j < P, jnp.roll(hashes, -j, axis=1), _U64MAX)
        in_window = (j < ww) & is_win_start
        cand = jnp.where(in_window, cand, _U64MAX)
        take = cand < best_val                                          # strict: leftmost wins
        best_val = jnp.where(take, cand, best_val)
        best_idx = jnp.where(take, pos + j, best_idx)

    # Scatter-mark the winner of every valid window start.
    marks = jnp.zeros((B, P), jnp.int32)
    rows = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None], (B, P))
    marks = marks.at[rows, best_idx].max(is_win_start.astype(jnp.int32))
    return marks.astype(bool) & valid


@functools.partial(jax.jit, static_argnums=(0, 3))
def modimizer_mask(spec: HashSpec, hashes: jnp.ndarray, valid: jnp.ndarray,
                   m: int = 0) -> jnp.ndarray:
    """Emission mask for k-mers with canonical hash ≡ 0 (mod m); m defaults to w."""
    m = m or spec.w
    return valid & (hashes % _u64(m) == 0)


@functools.partial(jax.jit, static_argnums=(0, 3, 4))
def syncmer_mask(spec: HashSpec, codes: jnp.ndarray, lengths: jnp.ndarray,
                 s: int, sub_seed: int = 0) -> jnp.ndarray:
    """Open-syncmer emission mask (oracle: ``seqhash_ref.syncmers``): keep a
    k-mer iff the minimal canonical s-mer hash inside it sits at offset 0
    (leftmost tie-break => keep iff smer[0] <= every other smer)."""
    if not (0 < s < spec.k):
        raise ValueError("syncmer s must satisfy 0 < s < k")
    sub = HashSpec(k=s, w=1, seed=sub_seed or spec.seed)
    sh, _, _ = kmer_grid(sub, codes, lengths)       # (B, L-s+1)
    P = codes.shape[1] - spec.k + 1
    span = spec.k - s + 1
    keep = jnp.ones((codes.shape[0], P), bool)
    base = sh[:, :P]
    for j in range(1, span):
        keep = keep & (sh[:, j:j + P] >= base)
    return keep


def sketch(spec: HashSpec, codes: jnp.ndarray, lengths: jnp.ndarray,
           mode: str = "minimizer", m: int = 0, syncmer_s: int = 0):
    """One-call sketching: returns (hashes, is_forward, emit_mask), all (B, P).

    mode: 'kmer' (every k-mer), 'minimizer', 'modimizer', or 'syncmer'
    (syncmer_s = s-mer size).
    """
    hashes, is_forward, valid = kmer_grid(spec, codes, lengths)
    if mode == "kmer":
        emit = valid
    elif mode == "minimizer":
        emit = minimizer_mask(spec, hashes, valid)
    elif mode == "modimizer":
        emit = modimizer_mask(spec, hashes, valid, m)
    elif mode == "syncmer":
        emit = valid & syncmer_mask(spec, codes, lengths, syncmer_s)
    else:
        raise ValueError(f"unknown sketch mode {mode!r}")
    return hashes, is_forward, emit


def compact_width(spec: HashSpec, P: int, mode: str = "minimizer", m: int = 0,
                  syncmer_s: int = 0, factor: int = 4) -> int:
    """Emission slots per read for :func:`sketch_emitted` (0 = keep all P).

    ``factor``/2 x the expected per-read emission count + 16, rounded to 8
    (minimizer: 2P/(w+1); modimizer: P/m; syncmer: P/(k-s+1)); ``factor``
    0 turns compaction off, and kmer mode emits every position.  The slots
    are shared by the whole batch: single reads may emit far more than the
    mean (a homopolymer has one hash throughout, so under the leftmost
    tie-break every window emits its own first position), but a batch's
    total concentrates around B x the mean, and only a batch whose total
    passes B x this width overflows — counted exactly, and the count passes
    raise on it."""
    if not factor:
        return 0
    if mode == "minimizer" and spec.w > 1:
        expected = 2 * P // (spec.w + 1) + 1
    elif mode == "modimizer":
        expected = P // max(m or spec.w, 1) + 1
    elif mode == "syncmer" and syncmer_s:
        expected = P // (spec.k - syncmer_s + 1) + 1
    else:
        return 0
    c = ((factor * expected // 2 + 16 + 7) // 8) * 8
    return c if c < P else 0


@functools.partial(jax.jit, static_argnums=2)
def compact_emissions(hashes: jnp.ndarray, emit: jnp.ndarray, W: int):
    """Pack a batch's emitted hashes into ``W`` slots, read by read and in
    position order within a read: ``(packed (W,) u64 with U64MAX pads,
    read (W,) int32 = the read each slot holds (0 on pads), overflow ()
    int32 = the exact number of emissions past slot W)``."""
    B, P = hashes.shape
    n_emit = jnp.cumsum(emit, axis=1, dtype=jnp.int32)
    per_read = n_emit[:, -1]
    first = jnp.cumsum(per_read) - per_read          # exclusive prefix sum
    dest = jnp.where(emit, first[:, None] + n_emit - 1, W).reshape(-1)
    rows = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None],
                            (B, P)).reshape(-1)
    packed = jnp.full((W,), _U64MAX, jnp.uint64).at[dest].set(
        hashes.reshape(-1), mode="drop")
    read = jnp.zeros((W,), jnp.int32).at[dest].set(rows, mode="drop")
    return packed, read, jnp.maximum(jnp.sum(per_read) - W, 0)


def sketch_emitted(spec: HashSpec, codes: jnp.ndarray, lengths: jnp.ndarray,
                   mode: str = "minimizer", m: int = 0, syncmer_s: int = 0,
                   compact_to: int = 0):
    """The count passes' sketch of a batch: ``(flat (R,) u64, read (R,)
    int32, overflow u32)`` — the emitted hashes with U64MAX pads, the read
    each entry came from, and the exact count of emissions that did not
    fit.  With ``compact_to`` (``compact_width``) the emissions are packed
    into ``R = B * compact_to`` slots (``compact_emissions``); with 0 every
    position stays, ``R = B * P``, and nothing overflows."""
    h, _, emit = sketch(spec, codes, lengths, mode=mode, m=m,
                        syncmer_s=syncmer_s)
    B, P = h.shape
    if not compact_to:
        read = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None],
                                (B, P))
        return (jnp.where(emit, h, _U64MAX).reshape(-1), read.reshape(-1),
                jnp.uint32(0))
    flat, read, over = compact_emissions(h, emit, B * compact_to)
    return flat, read, over.astype(jnp.uint32)
