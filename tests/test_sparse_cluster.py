"""The sparse global friend-clustering path (cluster/sparse.py) must bit-match
the union-find oracle (cluster_barcode_friend, no cap) and the dense share
tally (barcode_shares) — SURVEY.md §5 item 2, §8.3 deterministic clustering."""

import numpy as np
import pytest

from hash10x_jax.cluster import sparse as SP
from hash10x_jax.cluster import cooccur
from hash10x_jax.oracle import cluster_ref as CO
from hash10x_jax.table.incidence import build_incidence


def random_incidence(rng, n_kmers=60, n_codes=30, density=0.15):
    pairs = rng.random((n_kmers, n_codes)) < density
    k, c = np.nonzero(pairs)
    return build_incidence(k.astype(np.int32), c.astype(np.int32), n_kmers, n_codes)


def oracle_labels_uncapped(inc, thr):
    hash_codes = {k: inc.codes_of(k).tolist() for k in range(inc.n_kmers)}
    return [CO.cluster_barcode_friend(inc.kmers_of(c).tolist(), hash_codes, c,
                                      thr, max_friends=0)
            for c in range(inc.n_codes)]


def test_cooccurrence_matches_oracle_shares(rng):
    inc = random_incidence(rng, n_kmers=40, n_codes=20, density=0.2)
    keys, shares = SP.cooccurrence_counts(inc)
    hash_codes = {k: inc.codes_of(k).tolist() for k in range(inc.n_kmers)}
    got = {}
    for key, s in zip(keys.tolist(), shares.tolist()):
        got[(key // inc.n_codes, key % inc.n_codes)] = s
    for c in range(inc.n_codes):
        expect = CO.barcode_shares(inc.kmers_of(c).tolist(), hash_codes, c)
        mine = {c2: s for (c1, c2), s in got.items() if c1 == c}
        assert mine == expect, f"code {c}"


@pytest.mark.parametrize("thr,density", [(1, 0.1), (2, 0.2), (3, 0.25), (8, 0.4)])
def test_sparse_matches_oracle_random(rng, thr, density):
    inc = random_incidence(rng, n_kmers=50, n_codes=24, density=density)
    got = SP.cluster_codes_sparse(inc, min_friend_share=thr)
    expect = oracle_labels_uncapped(inc, thr)
    for c in range(inc.n_codes):
        assert got[c].tolist() == expect[c], f"code {c}"


def test_sparse_larger_instance(rng):
    inc = random_incidence(rng, n_kmers=400, n_codes=120, density=0.06)
    got = SP.cluster_codes_sparse(inc, min_friend_share=2)
    expect = oracle_labels_uncapped(inc, 2)
    for c in range(inc.n_codes):
        assert got[c].tolist() == expect[c], f"code {c}"


def test_sparse_is_default_uncapped_friend_path(rng):
    """cluster_codes(mode='friend', max_friends=0) routes to the sparse path."""
    inc = random_incidence(rng, n_kmers=60, n_codes=24, density=0.15)
    via_codes = cooccur.cluster_codes(inc, mode="friend", min_friend_share=2,
                                      max_friends=0)
    direct = SP.cluster_codes_sparse(inc, min_friend_share=2)
    for c in range(inc.n_codes):
        assert via_codes[c].tolist() == direct[c].tolist()


def test_sparse_empty_and_singletons():
    # no pairs at all
    inc = build_incidence(np.zeros(0, np.int32), np.zeros(0, np.int32), 5, 3)
    got = SP.cluster_codes_sparse(inc, min_friend_share=1)
    assert [g.tolist() for g in got] == [[], [], []]
    # one kmer in one code: single cluster 0, no friends anywhere
    inc = build_incidence(np.array([2], np.int32), np.array([1], np.int32), 5, 3)
    got = SP.cluster_codes_sparse(inc, min_friend_share=1)
    assert [g.tolist() for g in got] == [[], [0], []]


def test_sparse_no_friends_all_singletons(rng):
    """Threshold above every share: every k-mer is its own cluster."""
    inc = random_incidence(rng, n_kmers=30, n_codes=10, density=0.3)
    got = SP.cluster_codes_sparse(inc, min_friend_share=10 ** 6)
    for c in range(inc.n_codes):
        assert got[c].tolist() == list(range(len(inc.kmers_of(c))))


def test_sparse_chunk_boundaries(rng):
    """Tiny chunk forces many enumeration steps; result must not change."""
    inc = random_incidence(rng, n_kmers=50, n_codes=20, density=0.2)
    a = SP.cluster_codes_sparse(inc, min_friend_share=2)
    b = SP.cluster_codes_sparse(inc, min_friend_share=2, chunk=64)
    for c in range(inc.n_codes):
        assert a[c].tolist() == b[c].tolist()


def test_blocked_propagate_matches_monolithic(rng, monkeypatch):
    """The blocked propagate fallback (engaged past _EDGE_BLOCK edges; bounds
    per-dispatch memory on dense lanes) must be
    label-identical to the monolithic while_loop path."""
    from hash10x_jax.cluster import sparse as SP
    inc = random_incidence(rng, n_kmers=400, n_codes=120, density=0.2)
    want = SP.cluster_codes_sparse(inc, min_friend_share=4, flat=True)
    monkeypatch.setattr(SP, "_EDGE_BLOCK", 1 << 10)
    got = SP.cluster_codes_sparse(inc, min_friend_share=4, flat=True)
    assert (want == got).all()
