"""Shard-resident incidence (dist/sharded_inc.py): the code-range
redistribution, the distributed transpose, and the device-built shift-join
arrays must reproduce the host double-CSR build exactly — and the sharded
cluster path over it must never materialize the host incidence."""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from hash10x_jax.hashspec import HashSpec, U64MAX
from hash10x_jax.dist import sharded_inc as SI
from hash10x_jax.dist import sharded_sorted as SS
from hash10x_jax.table.incidence import build_incidence

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def mesh_of(n):
    return Mesh(np.array(jax.devices("cpu")[:n]), ("d",))


def random_pairs(rng, n_kmers=60, n_codes=30, density=0.15):
    grid = rng.random((n_kmers, n_codes)) < density
    k, c = np.nonzero(grid)
    pairs = np.sort(c.astype(np.uint64) * np.uint64(n_kmers)
                    + k.astype(np.uint64))
    return pairs, build_incidence(k.astype(np.int32), c.astype(np.int32),
                                  n_kmers, n_codes)


def fake_low_sharded_table(pairs, mesh, cap=0):
    """A finished low-bit-sharded pair table holding ``pairs``."""
    n = mesh.devices.size
    dest = (pairs & np.uint64(n - 1)).astype(np.int64)
    counts = np.bincount(dest, minlength=n)
    cap = cap or (1 << int(max(int(counts.max(initial=1)) - 1, 1)
                           ).bit_length())
    rows = np.full((n, cap), U64MAX, np.uint64)
    for s in range(n):
        sel = np.sort(pairs[dest == s])
        rows[s, :len(sel)] = sel
    t = SS.ShardedSortedTable(mesh, cap, cap, routing="low")
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    t.hashes = jax.device_put(jnp.asarray(rows), NamedSharding(mesh, P("d")))
    t.fill_bound = int(counts.max(initial=0))
    return t


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_build_matches_host_csr(rng, n_dev):
    pairs, inc = random_pairs(rng)
    mesh = mesh_of(n_dev)
    dt = fake_low_sharded_table(pairs, mesh)
    sh = SI.build_sharded_incidence(dt, inc.n_kmers, inc.n_codes)
    assert sh.n_pairs == inc.n_pairs
    # gathered pair set is the global sorted set (concat, no re-sort)
    assert sh.gathered_pairs().tolist() == pairs.tolist()
    # host view equals the single-device CSR build
    h = sh.to_host()
    assert (h.code_offsets == inc.code_offsets).all()
    assert (h.code_kmers == inc.code_kmers).all()
    assert (h.kmer_offsets == inc.kmer_offsets).all()
    assert (h.kmer_codes == inc.kmer_codes).all()
    # shard-side code offsets equal the host CSR offsets
    assert (sh.code_offsets == inc.code_offsets).all()


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_inverted_positions(rng, n_dev):
    """The distributed transpose must carry exact global forward positions:
    for every kmer-major entry, pos is the rank of (code, kmer) in the
    code-major order."""
    pairs, inc = random_pairs(rng, n_kmers=40, n_codes=20, density=0.2)
    mesh = mesh_of(n_dev)
    sh = SI.build_sharded_incidence(fake_low_sharded_table(pairs, mesh),
                                    inc.n_kmers, inc.n_codes)
    sh.build_inverted()
    k2 = np.asarray(jax.jit(lambda x: x)(sh.inv_keys)).reshape(-1)
    ps = np.asarray(jax.jit(lambda x: x)(sh.inv_pos)).reshape(-1)
    keep = k2 != U64MAX
    k2, ps = k2[keep], ps[keep]
    # reconstruct (code, kmer) and check pos = searchsorted(pairs, key)
    code = (k2 % np.uint64(inc.n_codes)).astype(np.int64)
    kmer = (k2 // np.uint64(inc.n_codes)).astype(np.int64)
    fwd_key = code.astype(np.uint64) * np.uint64(inc.n_kmers) \
        + kmer.astype(np.uint64)
    want = np.searchsorted(pairs, fwd_key)
    order = np.argsort(ps)
    assert (ps[order] == want[order]).all()
    assert len(k2) == inc.n_pairs


@pytest.mark.parametrize("n_dev", [2, 8])
def test_cluster_over_sharded_incidence_matches(rng, n_dev):
    """cluster_codes_sparse_dist over a ShardedIncidence == over the host
    incidence == single-device sparse."""
    from hash10x_jax.cluster import sparse as SP
    from hash10x_jax.cluster import sparse_dist as SD
    pairs, inc = random_pairs(rng, n_kmers=70, n_codes=28, density=0.18)
    mesh = mesh_of(n_dev)
    sh = SI.build_sharded_incidence(fake_low_sharded_table(pairs, mesh),
                                    inc.n_kmers, inc.n_codes)
    want = SP.cluster_codes_sparse(inc, min_friend_share=2, flat=True)
    got = SD.cluster_codes_sparse_dist(sh, mesh, min_friend_share=2,
                                       chunk=256, flat=True)
    # the device path returns ShardedLabels (no host O(n_pairs)); its host
    # view must equal the single-device flat labels, and its shard-side
    # molecule count must match
    assert got.to_host().tolist() == want.tolist()
    code_of_p = np.repeat(np.arange(inc.n_codes, dtype=np.int64),
                          np.diff(inc.code_offsets))
    n_mol = len(np.unique(code_of_p * (int(want.max()) + 1) + want)) \
        if len(want) else 0
    assert got.n_molecules == n_mol


@pytest.mark.parametrize("n_dev,block", [(2, 40), (8, 40), (8, 150)])
def test_label_blocks_over_sharded_incidence_stays_device(rng, n_dev, block):
    """label_block_pairs over a ShardedIncidence must return ShardedLabels
    (block results written shard-resident, canonicalized shard-side — the
    host never assembles the O(n_pairs) label vector) and equal the
    single-device sparse labels exactly."""
    from hash10x_jax.cluster import sparse as SP
    from hash10x_jax.cluster import sparse_dist as SD
    pairs, inc = random_pairs(rng, n_kmers=70, n_codes=28, density=0.18)
    mesh = mesh_of(n_dev)
    sh = SI.build_sharded_incidence(fake_low_sharded_table(pairs, mesh),
                                    inc.n_kmers, inc.n_codes)
    want = SP.cluster_codes_sparse(inc, min_friend_share=2, flat=True)
    got = SD.cluster_codes_sparse_dist(sh, mesh, min_friend_share=2,
                                       chunk=256, flat=True,
                                       label_block_pairs=block)
    assert isinstance(got, SI.ShardedLabels), \
        "block path over ShardedIncidence fell back to host assembly"
    assert got.to_host().tolist() == want.tolist()
    code_of_p = np.repeat(np.arange(inc.n_codes, dtype=np.int64),
                          np.diff(inc.code_offsets))
    n_mol = len(np.unique(code_of_p * (int(want.max()) + 1) + want)) \
        if len(want) else 0
    assert got.n_molecules == n_mol


def test_engine_sharded_cluster_never_materializes_host_inc():
    """--codeClusters on the sharded path: the host incidence must stay
    unmaterialized through cluster(); report() then materializes lazily."""
    import io
    from hash10x_jax.engine import Engine, EngineConfig
    from hash10x_jax.io import fqb as FB
    from hash10x_jax.io.sim import SimConfig, simulate
    sim = simulate(SimConfig(genome_len=50_000, n_barcodes=16,
                             molecules_per_barcode=2, molecule_len=4000,
                             reads_per_molecule=25, read_len=110, seed=9))
    fqb = FB.from_read_batch(sim.reads)
    eng = Engine(EngineConfig(spec=HashSpec(k=21, w=7, seed=17),
                              table_bits=16, batch_reads=512,
                              min_count=2, max_count=30,
                              min_friend_share=10, n_shards=8), log=None)
    eng.count(fqb)
    eng.filter()
    eng.incidence(fqb)
    assert eng._inc_sh is not None and eng._inc_host is None
    eng.cluster()
    assert eng._inc_host is None, \
        "cluster() materialized the host incidence on the sharded path"
    assert eng._labels_sh is not None and eng._labels_host is None, \
        "cluster() materialized host labels on the sharded path"
    # report matches the plain engine — and aggregates SHARD-SIDE: the host
    # incidence and flat labels stay unmaterialized through report() too
    ref = Engine(EngineConfig(spec=HashSpec(k=21, w=7, seed=17),
                              table_bits=16, batch_reads=512,
                              min_count=2, max_count=30,
                              min_friend_share=10, n_shards=1), log=None)
    ref.count(fqb)
    ref.filter()
    ref.incidence(fqb)
    ref.cluster()
    a, b = io.StringIO(), io.StringIO()
    eng.report(a)
    ref.report(b)
    assert a.getvalue() == b.getvalue()
    assert eng._inc_host is None, \
        "report() materialized the host incidence on the sharded path"
    assert eng._labels_host is None, \
        "report() materialized host flat labels on the sharded path"


def _lane_engines():
    from hash10x_jax.engine import Engine, EngineConfig
    from hash10x_jax.io import fqb as FB
    from hash10x_jax.io.sim import SimConfig, simulate
    sim = simulate(SimConfig(genome_len=50_000, n_barcodes=16,
                             molecules_per_barcode=2, molecule_len=4000,
                             reads_per_molecule=25, read_len=110, seed=9))
    fqb = FB.from_read_batch(sim.reads)
    mk = lambda n: Engine(EngineConfig(spec=HashSpec(k=21, w=7, seed=17),
                                       table_bits=16, batch_reads=512,
                                       min_count=2, max_count=30,
                                       min_friend_share=10, n_shards=n),
                          log=None)
    return fqb, mk


def test_engine_sharded_split_matches_host():
    """--clusterSplit on the sharded path: the split pair set stays
    shard-resident (split_sharded); origin table and the lazily
    materialized molecule-code CSR are byte-identical to the host split."""
    fqb, mk = _lane_engines()
    eng, ref = mk(8), mk(1)
    for e in (eng, ref):
        e.count(fqb)
        e.filter()
        e.incidence(fqb)
        e.cluster()
        e.split()
    assert eng._split_inc_sh is not None and eng._split_inc_host is None, \
        "split() materialized the host split incidence on the sharded path"
    assert eng._inc_host is None, \
        "split() materialized the host incidence on the sharded path"
    assert (eng.split_origin == ref.split_origin).all()
    s, r = eng.split_inc, ref.split_inc  # lazy host view (explicit command)
    assert s.n_codes == r.n_codes and s.n_kmers == r.n_kmers
    assert (s.code_offsets == r.code_offsets).all()
    assert (s.code_kmers == r.code_kmers).all()
    assert (s.kmer_offsets == r.kmer_offsets).all()
    assert (s.kmer_codes == r.kmer_codes).all()


def test_engine_one_shard_sharded_pipeline_stays_device():
    """A 1-shard sharded pipeline (the single-chip drive of the pod path:
    bench/verify drive _count_sharded directly) must cluster/split/report
    through the SHARDED branches — cluster() keys on the existing
    ShardedIncidence, not just cfg.n_shards — and never materialize host
    O(n_pairs) state, byte-identical to the plain engine."""
    import io
    fqb, mk = _lane_engines()
    eng, ref = mk(1), mk(1)
    ref.count(fqb)
    ref.filter()
    ref.incidence(fqb)
    ref.cluster()
    ref.split()
    eng._count_sharded(fqb)
    eng.filter()
    eng._incidence_sharded(fqb)
    eng.cluster()
    eng.split()
    assert eng._inc_sh is not None and eng._labels_sh is not None
    assert eng._inc_host is None and eng._labels_host is None \
        and eng._split_inc_host is None, \
        "1-shard sharded pipeline materialized host O(n_pairs) state"
    a, b = io.StringIO(), io.StringIO()
    eng.report(a)
    ref.report(b)
    assert a.getvalue() == b.getvalue()
    assert (eng.split_origin == ref.split_origin).all()
