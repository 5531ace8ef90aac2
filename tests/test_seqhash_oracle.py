"""Properties of the scalar oracle (SURVEY.md §5 item 2).

The oracle is the framework's contract in the absence of a readable reference; these
tests pin down its invariants: rolling == recompute-from-scratch, RC canonicalization,
minimizer-set invariance under reverse complement, exhaustive small-string coverage.
"""

import itertools

import numpy as np
import pytest

from hash10x_jax.hashspec import HashSpec, U64MAX
from hash10x_jax.core.encode import ascii_to_codes, revcomp_codes
from hash10x_jax.oracle import seqhash_ref as O

from conftest import random_codes


def brute_hash(spec, codes, pos):
    """Recompute a k-mer's canonical hash from scratch (no rolling)."""
    k = spec.k
    win = codes[pos:pos + k]
    if any(b > 3 for b in win):
        return None
    h = 0
    for b in win:
        h = ((h << 2) | int(b)) & spec.mask
    h_rc = 0
    for b in reversed(win):
        h_rc = ((h_rc << 2) | (3 - int(b))) & spec.mask
    return spec.canonical(h, h_rc)


@pytest.mark.parametrize("k", [1, 4, 21, 31])
def test_rolling_equals_scratch(rng, k):
    spec = HashSpec(k=k, w=5, seed=17)
    codes = random_codes(rng, 200, p_bad=0.02)
    got = O.kmer_hashes(spec, codes)
    expected = []
    for p in range(len(codes) - k + 1):
        bh = brute_hash(spec, codes, p)
        if bh is not None:
            expected.append((p, bh[0], bh[1]))
    assert got == expected


def test_hash_fits_2k_bits():
    spec = HashSpec(k=21, w=5, seed=7)
    codes = random_codes(np.random.default_rng(1), 500)
    for _, h, _ in O.kmer_hashes(spec, codes):
        assert 0 <= h < (1 << (2 * spec.k))


@pytest.mark.parametrize("k,w", [(4, 3), (7, 5), (21, 11)])
def test_canonical_invariant_under_revcomp(rng, k, w):
    """hash stream of RC(seq) is the reverse of the hash stream of seq."""
    spec = HashSpec(k=k, w=w, seed=17)
    codes = random_codes(rng, 120)
    fwd = [h for _, h, _ in O.kmer_hashes(spec, codes)]
    rev = [h for _, h, _ in O.kmer_hashes(spec, revcomp_codes(codes))]
    assert fwd == rev[::-1]


@pytest.mark.parametrize("k,w", [(4, 3), (7, 5), (21, 11)])
def test_minimizer_set_invariant_under_revcomp(rng, k, w):
    # Leftmost tie-break maps to rightmost under RC, so only the emitted hash
    # *value set* (not multiset/positions) is strand-invariant; small k has real
    # ties (the hash space is only 2^(2k)).
    spec = HashSpec(k=k, w=w, seed=17)
    codes = random_codes(rng, 150)
    a = {h for _, h, _ in O.minimizers(spec, codes)}
    b = {h for _, h, _ in O.minimizers(spec, revcomp_codes(codes))}
    assert a == b


def test_minimizers_subset_and_cover():
    """Every window of w valid k-mers contains an emitted minimizer."""
    spec = HashSpec(k=5, w=4, seed=3)
    codes = random_codes(np.random.default_rng(2), 300, p_bad=0.03)
    all_h = {p: h for p, h, _ in O.kmer_hashes(spec, codes)}
    mins = O.minimizers(spec, codes)
    min_pos = {p for p, _, _ in mins}
    assert min_pos <= set(all_h)
    # cover check on fully-valid windows
    positions = sorted(all_h)
    for i in range(len(positions) - spec.w + 1):
        window = positions[i:i + spec.w]
        if window[-1] - window[0] == spec.w - 1:  # consecutive, no gap
            assert min_pos & set(window), f"window at {window[0]} uncovered"


def test_minimizers_exhaustive_tiny():
    """All 4^n strings for small n: minimizer = leftmost min of each window (brute)."""
    spec = HashSpec(k=2, w=2, seed=17)
    for tup in itertools.product(range(4), repeat=5):
        codes = np.array(tup, np.uint8)
        hashes = O.kmer_hashes(spec, codes)
        vals = [h for _, h, _ in hashes]
        expect = set()
        for s in range(len(vals) - spec.w + 1):
            seg = vals[s:s + spec.w]
            expect.add(s + seg.index(min(seg)))
        got = {p for p, _, _ in O.minimizers(spec, codes)}
        assert got == expect, f"str {tup}"


def test_modimizer_definition(rng):
    spec = HashSpec(k=11, w=7, seed=17)
    codes = random_codes(rng, 400)
    mods = O.modimizers(spec, codes)
    allh = O.kmer_hashes(spec, codes)
    assert mods == [e for e in allh if e[1] % spec.w == 0]


def test_short_run_edge_rule():
    """Runs shorter than w emit exactly the leftmost minimum of the run."""
    spec = HashSpec(k=3, w=10, seed=5)
    codes = ascii_to_codes("acgtacg")  # 5 kmer positions < w
    mins = O.minimizers(spec, codes)
    allh = O.kmer_hashes(spec, codes)
    best = min(allh, key=lambda e: (e[1], e[0]))
    assert mins == [best]


def test_spec_serialization_roundtrip():
    s = HashSpec(k=17, w=9, seed=42)
    s2 = HashSpec.from_json(s.to_json())
    assert s == s2 and s2.factor1 == s.factor1 and s2.pattern_rc == s.pattern_rc
