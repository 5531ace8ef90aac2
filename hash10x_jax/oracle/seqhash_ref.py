"""Pure-Python scalar transliteration of the seqhash iterators — the golden model.

This module is the framework's oracle: a line-faithful (to the extent the reference is
reconstructable — SURVEY.md §0) scalar model of ``seqhash.c``'s iterators.  The
vectorized path (``core/seqhash_jnp.py``) must equal this module bit-for-bit; tests
enforce it.

Reference call shapes modeled (reconstructed, SURVEY.md §3.1 #4):

* ``seqhashRCiterator / seqhashRCnext``  -> :func:`kmer_hashes`
* ``minimizerIterator / minimizerNext``  -> :func:`minimizers`
* ``modIterator / modNext``              -> :func:`modimizers`
* ``syncmerIterator / syncmerNext``      -> :func:`syncmers` (extension)

Sequences are given as base-code iterables: 0=a 1=c 2=g 3=t; any code outside [0,3]
(e.g. 4 for N) invalidates every k-mer window containing it.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..hashspec import HashSpec, U64MAX

__all__ = ["kmer_hashes", "minimizers", "modimizers", "syncmers"]

_M64 = U64MAX

Emitted = Tuple[int, int, bool]  # (pos, canonical_hash, is_forward)


def kmer_hashes(spec: HashSpec, codes: Sequence[int]) -> List[Emitted]:
    """Canonical hash of every valid k-mer, in position order.

    Rolling state mirrors the reference's ``advanceHashRC``: the forward code shifts
    new bases into the low end; the RC code shifts complements into the high end.
    Windows containing an invalid base are skipped (2-bit packed inputs never contain
    one; text-mode inputs may).
    """
    k = spec.k
    out: List[Emitted] = []
    n = len(codes)
    if n < k:
        return out
    h = 0
    h_rc = 0
    run = 0  # number of consecutive valid bases ending at current position
    for i in range(n):
        b = int(codes[i])  # coerce numpy scalars: this path is exact Python ints
        if 0 <= b <= 3:
            run += 1
            h = ((h << 2) | b) & spec.mask
            h_rc = (h_rc >> 2) | spec.pattern_rc[b]
        else:
            run = 0
            h = 0
            h_rc = 0
            continue
        if run >= k:
            pos = i - k + 1
            hv, fwd = spec.canonical(h, h_rc)
            out.append((pos, hv, fwd))
    return out


def minimizers(spec: HashSpec, codes: Sequence[int]) -> List[Emitted]:
    """Leftmost-minimum w-window minimizers over the canonical hash stream.

    A k-mer position p is emitted iff its hash is the leftmost minimum of at least one
    window of ``spec.w`` consecutive *valid* k-mer positions (windows never span an
    invalid gap).  Emitted once per position, in increasing position order — the
    minimizer *set* the reference's ``minimizerNext`` yields.  Runs of valid k-mers
    shorter than w emit the leftmost-minimum of the whole run (the reference hashes
    whole reads, where len >= k + w - 1 always holds; this edge rule matters only for
    text inputs with Ns near ends).
    """
    w = spec.w
    all_hashes = kmer_hashes(spec, codes)
    if not all_hashes:
        return []
    # Split into runs of consecutive positions (invalid bases break runs).
    runs: List[List[Emitted]] = []
    cur: List[Emitted] = [all_hashes[0]]
    for e in all_hashes[1:]:
        if e[0] == cur[-1][0] + 1:
            cur.append(e)
        else:
            runs.append(cur)
            cur = [e]
    runs.append(cur)

    out: List[Emitted] = []
    for run in runs:
        n = len(run)
        ww = min(w, n)
        emitted = [False] * n
        for start in range(0, n - ww + 1):
            best = start
            for j in range(start + 1, start + ww):
                if run[j][1] < run[best][1]:  # strict < => leftmost tie-break
                    best = j
            emitted[best] = True
        for j in range(n):
            if emitted[j]:
                out.append(run[j])
    return out


def modimizers(spec: HashSpec, codes: Sequence[int], m: int = 0) -> List[Emitted]:
    """k-mers whose canonical hash is ≡ 0 (mod m); m defaults to spec.w.

    Reconstructed ``modIterator`` semantics (SURVEY.md §1: "modimizers — hashes ≡ 0
    mod m") — [M] confidence; parameterized so the modulus rule is swappable.
    """
    m = m or spec.w
    if m <= 0:
        raise ValueError("modimizer modulus must be positive")
    return [e for e in kmer_hashes(spec, codes) if e[1] % m == 0]


def syncmers(spec: HashSpec, codes: Sequence[int], s: int, seed: int = 0) -> List[Emitted]:
    """Open syncmers (extension; not part of hash10x parity — SURVEY.md §1).

    A k-mer is kept iff the minimal canonical s-mer hash (s < k, hashed under an
    s-sized HashSpec with the same seed) among its k-s+1 interior s-mers sits at
    offset 0.  Leftmost tie-break, matching :func:`minimizers`.
    """
    if not (0 < s < spec.k):
        raise ValueError("syncmer s must satisfy 0 < s < k")
    sub = HashSpec(k=s, w=1, seed=seed or spec.seed)
    smers = {pos: hv for pos, hv, _ in kmer_hashes(sub, codes)}
    out: List[Emitted] = []
    for pos, hv, fwd in kmer_hashes(spec, codes):
        span = [smers.get(pos + j, U64MAX) for j in range(spec.k - s + 1)]
        best = min(range(len(span)), key=lambda j: (span[j], j))
        if best == 0:
            out.append((pos, hv, fwd))
    return out
