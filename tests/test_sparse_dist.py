"""Mesh-distributed sparse clustering (cluster/sparse_dist.py) must equal the
single-device sparse path (and hence the union-find oracle) exactly, across
mesh sizes — SURVEY.md §5 item 4 (distributed without a cluster)."""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from hash10x_jax.cluster import sparse as SP
from hash10x_jax.cluster import sparse_dist as SD
from hash10x_jax.table.incidence import build_incidence


def mesh_of(n):
    return Mesh(np.array(jax.devices("cpu")[:n]), ("d",))


def random_incidence(rng, n_kmers=60, n_codes=30, density=0.15):
    pairs = rng.random((n_kmers, n_codes)) < density
    k, c = np.nonzero(pairs)
    return build_incidence(k.astype(np.int32), c.astype(np.int32), n_kmers,
                           n_codes)


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_cooccurrence_dist_equals_single(rng, n_dev):
    inc = random_incidence(rng, n_kmers=50, n_codes=24, density=0.2)
    k1, s1 = SP.cooccurrence_counts(inc)
    k2, s2 = SD.cooccurrence_counts_dist(inc, mesh_of(n_dev), chunk=256)
    assert (k1 == k2).all()
    assert (s1 == s2).all()


@pytest.mark.parametrize("n_dev,thr", [(1, 2), (2, 2), (8, 2), (8, 3)])
def test_cluster_dist_equals_single(rng, n_dev, thr):
    inc = random_incidence(rng, n_kmers=70, n_codes=28, density=0.18)
    got = SD.cluster_codes_sparse_dist(inc, mesh_of(n_dev),
                                       min_friend_share=thr, chunk=256)
    want = SP.cluster_codes_sparse(inc, min_friend_share=thr)
    for c in range(inc.n_codes):
        assert got[c].tolist() == want[c].tolist(), f"code {c}"


@pytest.mark.parametrize("n_dev,block", [(2, 40), (8, 40), (8, 150)])
def test_cluster_dist_label_blocks_equals_single(rng, n_dev, block):
    """label_block_pairs (the config-#5 memory path: per-block label vectors
    over contiguous slices of the p-sorted edge tables) must reproduce the
    replicated-label path exactly."""
    inc = random_incidence(rng, n_kmers=70, n_codes=28, density=0.18)
    want = SP.cluster_codes_sparse(inc, min_friend_share=2)
    got = SD.cluster_codes_sparse_dist(inc, mesh_of(n_dev),
                                       min_friend_share=2, chunk=256,
                                       label_block_pairs=block)
    for c in range(inc.n_codes):
        assert got[c].tolist() == want[c].tolist(), f"code {c}"


def test_cluster_dist_empty(rng):
    inc = build_incidence(np.zeros(0, np.int32), np.zeros(0, np.int32), 5, 3)
    got = SD.cluster_codes_sparse_dist(inc, mesh_of(8), min_friend_share=1)
    assert [g.tolist() for g in got] == [[], [], []]


def test_cluster_dist_no_friends(rng):
    inc = random_incidence(rng, n_kmers=30, n_codes=10, density=0.3)
    got = SD.cluster_codes_sparse_dist(inc, mesh_of(4),
                                       min_friend_share=10 ** 6)
    for c in range(inc.n_codes):
        assert got[c].tolist() == list(range(len(inc.kmers_of(c))))
