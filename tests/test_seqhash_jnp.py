"""Vectorized jnp path must equal the scalar oracle bit-for-bit (SURVEY.md §5.2)."""

import numpy as np
import pytest

from hash10x_jax.hashspec import HashSpec, U64MAX
from hash10x_jax.core import seqhash_jnp as J
from hash10x_jax.oracle import seqhash_ref as O

from conftest import random_codes


def batch_of(rng, B, L, p_bad=0.0, var_len=False):
    codes = np.stack([random_codes(rng, L, p_bad) for _ in range(B)])
    if var_len:
        lengths = rng.integers(1, L + 1, size=B).astype(np.int32)
    else:
        lengths = np.full(B, L, np.int32)
    return codes, lengths


def grid_to_list(hashes, fwd, mask, lengths, k):
    """Dense (B,P) grids -> per-read oracle-style [(pos, hash, isF)] lists."""
    out = []
    for i in range(hashes.shape[0]):
        row = []
        for p in range(hashes.shape[1]):
            if mask[i, p]:
                row.append((p, int(hashes[i, p]), bool(fwd[i, p])))
        out.append(row)
    return out


@pytest.mark.parametrize("k,w,p_bad", [(4, 3, 0.0), (21, 11, 0.0), (21, 11, 0.05), (31, 5, 0.02)])
def test_kmer_grid_matches_oracle(rng, k, w, p_bad):
    spec = HashSpec(k=k, w=w, seed=17)
    codes, lengths = batch_of(rng, 8, 100, p_bad=p_bad, var_len=True)
    hashes, fwd, valid = (np.asarray(x) for x in J.kmer_grid(spec, codes, lengths))
    got = grid_to_list(hashes, fwd, valid, lengths, k)
    for i in range(len(codes)):
        expect = O.kmer_hashes(spec, list(codes[i, :lengths[i]]))
        assert got[i] == expect, f"read {i}"
    # invalid slots carry U64MAX
    assert (hashes[~valid] == U64MAX).all()


@pytest.mark.parametrize("k,w,p_bad", [(4, 3, 0.0), (7, 5, 0.1), (21, 11, 0.0), (21, 11, 0.03), (13, 31, 0.05)])
def test_minimizer_mask_matches_oracle(rng, k, w, p_bad):
    spec = HashSpec(k=k, w=w, seed=17)
    codes, lengths = batch_of(rng, 10, 90, p_bad=p_bad, var_len=True)
    hashes, fwd, emit = J.sketch(spec, codes, lengths, mode="minimizer")
    got = grid_to_list(np.asarray(hashes), np.asarray(fwd), np.asarray(emit), lengths, k)
    for i in range(len(codes)):
        expect = O.minimizers(spec, list(codes[i, :lengths[i]]))
        assert got[i] == expect, f"read {i} (k={k},w={w})"


@pytest.mark.parametrize("k,w", [(11, 7), (21, 64)])
def test_modimizer_mask_matches_oracle(rng, k, w):
    spec = HashSpec(k=k, w=w, seed=17)
    codes, lengths = batch_of(rng, 6, 120, p_bad=0.01, var_len=True)
    hashes, fwd, emit = J.sketch(spec, codes, lengths, mode="modimizer")
    got = grid_to_list(np.asarray(hashes), np.asarray(fwd), np.asarray(emit), lengths, k)
    for i in range(len(codes)):
        expect = O.modimizers(spec, list(codes[i, :lengths[i]]))
        assert got[i] == expect, f"read {i}"


def test_w1_minimizer_is_every_kmer(rng):
    spec = HashSpec(k=9, w=1, seed=4)
    codes, lengths = batch_of(rng, 4, 60)
    hashes, _, valid = J.kmer_grid(spec, codes, lengths)
    emit = J.minimizer_mask(spec, hashes, valid)
    assert (np.asarray(emit) == np.asarray(valid)).all()


def test_syncmer_mask_matches_oracle(rng):
    from hash10x_jax.oracle import seqhash_ref as O2
    spec = HashSpec(k=15, w=5, seed=17)
    codes, lengths = batch_of(rng, 6, 90, var_len=True)
    hashes, fwd, emit = J.sketch(spec, codes, lengths, mode="syncmer", syncmer_s=7)
    got = grid_to_list(np.asarray(hashes), np.asarray(fwd), np.asarray(emit),
                       lengths, spec.k)
    for i in range(len(codes)):
        expect = O2.syncmers(spec, list(codes[i, :lengths[i]]), s=7)
        assert got[i] == expect, f"read {i}"
