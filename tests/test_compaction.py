"""The count passes' sketch: ``seqhash_jnp.sketch_emitted`` packs a batch's
emissions into ``B x compact_width`` slots.  The slots must hold exactly the
full-width sketch's emissions, read by read in position order, each with its
read index, and an exact overflow count; repetitive reads (homopolymers emit
at nearly every position) must fit at the engine width.  The full-width
sketch itself must equal the scalar oracle at the widths, ragged lengths and
modes the count passes run."""

import numpy as np
import pytest

from hash10x_jax.hashspec import HashSpec, U64MAX
from hash10x_jax.core import seqhash_jnp as J
from hash10x_jax.oracle import seqhash_ref as O

from conftest import random_codes

U = np.uint64(U64MAX)


def full_width(spec, codes, lengths, **kw):
    h, f, e = (np.asarray(x) for x in J.sketch(spec, codes, lengths, **kw))
    return h, f, e


def compare_compact(spec, codes, lengths, C, **kw):
    """Packed slots == the full-width emissions in row-major order with
    their read indices, U64MAX pads, exact overflow past B x C slots.
    Returns the overflow."""
    h0, _, e0 = full_width(spec, codes, lengths, **kw)
    W = len(codes) * C
    packed, read, over = (np.asarray(x)
                          for x in J.compact_emissions(h0, e0, W))
    assert packed.shape == read.shape == (W,)
    exp, exp_read = h0[e0], np.nonzero(e0)[0]
    n = min(len(exp), W)
    assert packed[:n].tolist() == exp[:n].tolist()
    assert read[:n].tolist() == exp_read[:n].tolist()
    assert (packed[n:] == U).all()
    assert int(over) == len(exp) - n
    flat, rd, total = J.sketch_emitted(spec, codes, lengths, compact_to=C,
                                       **kw)
    assert np.asarray(flat).tolist() == packed.tolist()
    assert np.asarray(rd).tolist() == read.tolist()
    assert int(total) == int(over)
    return int(over)


def oracle_rows(spec, codes, lengths, mode, **kw):
    fn = {"kmer": O.kmer_hashes, "minimizer": O.minimizers,
          "modimizer": O.modimizers, "syncmer": O.syncmers}[mode]
    return [fn(spec, list(codes[i, :lengths[i]]), **kw)
            for i in range(len(codes))]


def compare_oracle(spec, codes, lengths, mode="minimizer", m=0, syncmer_s=0):
    h, f, e = full_width(spec, codes, lengths, mode=mode, m=m,
                         syncmer_s=syncmer_s)
    kw = {"m": m} if mode == "modimizer" else \
        {"s": syncmer_s} if mode == "syncmer" else {}
    want = oracle_rows(spec, codes, lengths, mode, **kw)
    for i in range(len(codes)):
        got = [(p, int(h[i, p]), bool(f[i, p]))
               for p in range(h.shape[1]) if e[i, p]]
        assert got == want[i], f"read {i} ({mode}, k={spec.k}, w={spec.w})"


# k spans the 2k-bit widths: kb<32, kb==32 (k=16), kb>32, and w=1
@pytest.mark.parametrize("k,w", [(4, 3), (15, 1), (16, 5), (17, 7),
                                 (21, 11), (31, 2)])
def test_sketch_matches_oracle(rng, k, w):
    spec = HashSpec(k=k, w=w, seed=17)
    L = max(64, k + w + 10)
    codes = np.stack([random_codes(rng, L) for _ in range(48)])
    compare_oracle(spec, codes, np.full(48, L, np.int32))


def test_sketch_ragged_lengths_match_oracle(rng):
    """Ragged reads, including 0 < P < w (a run shorter than the window)
    and reads shorter than k."""
    spec = HashSpec(k=21, w=11, seed=17)
    codes = np.stack([random_codes(rng, 100) for _ in range(64)])
    lengths = rng.integers(0, 101, size=64).astype(np.int32)
    lengths[:4] = [21, 25, 31, 20]
    compare_oracle(spec, codes, lengths)


@pytest.mark.parametrize("mode,kw", [("kmer", {}), ("modimizer", {"m": 7}),
                                     ("modimizer", {"m": 11}),
                                     ("syncmer", {"syncmer_s": 11}),
                                     ("syncmer", {"syncmer_s": 5})])
def test_sketch_modes_match_oracle(rng, mode, kw):
    spec = HashSpec(k=21, w=11, seed=17)
    L = 120
    codes = np.stack([random_codes(rng, L) for _ in range(32)])
    lengths = rng.integers(0, L + 1, size=32).astype(np.int32)
    compare_oracle(spec, codes, lengths, mode=mode, **kw)


@pytest.mark.parametrize("k,w,C", [(21, 11, 64), (17, 7, 48), (31, 2, 64)])
def test_compaction_matches_full_width(rng, k, w, C):
    spec = HashSpec(k=k, w=w, seed=17)
    L = max(96, k + w + 10)
    codes = np.stack([random_codes(rng, L) for _ in range(512)])
    lengths = rng.integers(0, L + 1, size=512).astype(np.int32)
    compare_compact(spec, codes, lengths, C)


def test_compaction_overflow_exact(rng):
    """A tiny C forces overflow; counts must be exact (never silent)."""
    spec = HashSpec(k=21, w=3, seed=17)
    codes = np.stack([random_codes(rng, 128, p_bad=0.01) for _ in range(256)])
    assert compare_compact(spec, codes, np.full(256, 128, np.int32), 8) > 0


def _repeat(unit, L):
    return np.resize(np.array(unit, np.uint8), L)


# poly-A/T and poly-G/C (two-colour sequencers read no signal as G) hash to
# one value throughout: under the leftmost tie-break every window emits its
# own first position, ~2.5x the engine's per-read slots; short tandem
# repeats emit every period-th position
@pytest.mark.parametrize("unit", [[0], [2], [0, 1], [0, 2, 2]],
                         ids=["polyA", "polyG", "AC", "AGG"])
@pytest.mark.parametrize("p_bad", [0.0, 0.01], ids=["acgt", "N"])
def test_repetitive_read_fits_engine_width(rng, unit, p_bad):
    spec = HashSpec(k=21, w=11, seed=17)
    L, B = 150, 256
    codes = np.stack([random_codes(rng, L, p_bad) for _ in range(B)])
    codes[B // 2] = _repeat(unit, L)
    C = J.compact_width(spec, L - spec.k + 1)
    h, _, e = full_width(spec, codes, np.full(B, L, np.int32))
    assert e[B // 2].sum() > (C if len(unit) == 1 else 0)
    assert compare_compact(spec, codes, np.full(B, L, np.int32), C) == 0


def test_all_homopolymer_batch_overflow_exact():
    """A batch of nothing but poly-G reads emits 120 of 130 positions per
    read against 64 slots: the overflow is exactly the difference."""
    spec = HashSpec(k=21, w=11, seed=17)
    B, L = 64, 150
    codes = np.full((B, L), 2, np.uint8)
    C = J.compact_width(spec, L - spec.k + 1)
    P = L - spec.k + 1
    assert compare_compact(spec, codes, np.full(B, L, np.int32), C) == \
        B * (P - spec.w + 1) - B * C


@pytest.mark.parametrize("mode,kw", [("modimizer", {"m": 11}),
                                     ("syncmer", {"syncmer_s": 11})])
def test_compaction_modes_match_full_width(rng, mode, kw):
    spec = HashSpec(k=21, w=11, seed=17)
    L = 150
    P = L - spec.k + 1
    C = J.compact_width(spec, P, mode, kw.get("m", 0), kw.get("syncmer_s", 0))
    assert 0 < C < P
    codes = np.stack([random_codes(rng, L) for _ in range(256)])
    lengths = rng.integers(0, L + 1, size=256).astype(np.int32)
    compare_compact(spec, codes, lengths, C, mode=mode, **kw)


def test_compact_width_rule():
    """The engine width at 150bp reads, k=21, w=11 is 64 slots per read and
    grows with the cap factor; factor 0, kmer mode and widths that would
    not shrink the batch keep every position."""
    spec = HashSpec(k=21, w=11, seed=17)
    assert J.compact_width(spec, 130) == 64
    assert J.compact_width(spec, 130, factor=8) == 104
    assert J.compact_width(spec, 130, factor=0) == 0
    assert J.compact_width(spec, 130, "kmer") == 0
    assert J.compact_width(HashSpec(k=21, w=1, seed=17), 130) == 0
    assert J.compact_width(spec, 20) == 0


def test_sketch_emitted_uncompacted_is_masked_grid(rng):
    spec = HashSpec(k=21, w=11, seed=17)
    codes = np.stack([random_codes(rng, 80, p_bad=0.02) for _ in range(64)])
    lengths = rng.integers(0, 81, size=64).astype(np.int32)
    h, _, e = full_width(spec, codes, lengths)
    flat, read, over = J.sketch_emitted(spec, codes, lengths)
    assert np.asarray(flat).tolist() == np.where(e, h, U).reshape(-1).tolist()
    assert np.asarray(read).tolist() == np.repeat(np.arange(64), 60).tolist()
    assert int(over) == 0
