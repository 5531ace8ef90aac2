"""Sharded pipeline on the 8-device virtual CPU mesh: sharded output must equal
single-device output exactly (SURVEY.md §5 item 4)."""

import numpy as np
import pytest
import jax

from hash10x_jax.hashspec import HashSpec, U64MAX
from hash10x_jax.dist import sharded as D
from hash10x_jax.table import oa_table as T
from hash10x_jax.core import seqhash_jnp as J
from hash10x_jax.io.sim import SimConfig, simulate
from hash10x_jax.io import fqb as FB

from conftest import random_codes

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def sim_lane(seed=0, n_reads_pad=2048):
    sim = simulate(SimConfig(genome_len=80_000, n_barcodes=16,
                             molecules_per_barcode=2, molecule_len=5000,
                             reads_per_molecule=40, read_len=120, seed=seed))
    fqb = FB.from_read_batch(sim.reads)
    codes = fqb.codes()
    n = len(codes)
    assert n <= n_reads_pad
    c = np.zeros((n_reads_pad, codes.shape[1]), np.uint8)
    l = np.zeros(n_reads_pad, np.int32)
    b = np.full(n_reads_pad, -1, np.int32)
    c[:n], l[:n], b[:n] = codes, fqb.lengths, fqb.barcode_ids
    return c, l, b


def single_device_counts(spec, codes, lengths, bcs, mode="minimizer"):
    h, _, emit = J.sketch(spec, codes, lengths, mode=mode)
    flat = np.where(np.asarray(emit), np.asarray(h), U64MAX).reshape(-1)
    t = T.insert(T.make_table(16), flat, np.ones(flat.shape, np.uint32))
    keys = np.asarray(t.keys)
    counts = np.asarray(t.counts)
    m = keys != U64MAX
    return dict(zip(keys[m].tolist(), counts[m].tolist()))


@pytest.mark.parametrize("n_mesh", [1, 2, 8])
def test_sharded_count_equals_single_device(n_mesh):
    spec = HashSpec(k=21, w=7, seed=17)
    codes, lengths, bcs = sim_lane()
    mesh = D.make_mesh(n_mesh)
    st = D.ShardedTable(mesh, bits_per_shard=17)
    step = D.make_count_step(spec, mesh)
    st = step(st, codes, lengths, bcs)
    assert int(np.asarray(st.route_drops).sum()) == 0
    assert int(np.asarray(st.overflow).sum()) == 0
    gh, gc = D.gather_compact(st)
    expect = single_device_counts(spec, codes, lengths, bcs)
    got = dict(zip(gh.tolist(), gc.tolist()))
    assert got == expect


def test_shard_ownership():
    """Every resident key lives on the shard selected by its low bits."""
    spec = HashSpec(k=21, w=7, seed=17)
    codes, lengths, bcs = sim_lane(seed=1)
    mesh = D.make_mesh(8)
    st = D.ShardedTable(mesh, bits_per_shard=17)
    step = D.make_count_step(spec, mesh)
    st = step(st, codes, lengths, bcs)
    keys = np.asarray(st.keys)
    for s in range(8):
        k = keys[s]
        k = k[k != U64MAX]
        assert (k & 7 == s).all()


def test_merged_histogram_equals_gather():
    spec = HashSpec(k=21, w=7, seed=17)
    codes, lengths, bcs = sim_lane(seed=2)
    mesh = D.make_mesh(8)
    st = D.ShardedTable(mesh, bits_per_shard=17)
    step = D.make_count_step(spec, mesh)
    st = step(st, codes, lengths, bcs)
    hist = D.merged_histogram(st, 64)
    _, gc = D.gather_compact(st)
    expect = np.bincount(np.clip(gc, 0, 64), minlength=65)
    expect[0] = 0
    assert (hist == expect).all()


def test_multi_step_accumulation():
    """Two batches through the sharded step == one concatenated single pass."""
    spec = HashSpec(k=17, w=5, seed=17)
    codes, lengths, bcs = sim_lane(seed=3)
    half = len(codes) // 2
    mesh = D.make_mesh(8)
    st = D.ShardedTable(mesh, bits_per_shard=17)
    step = D.make_count_step(spec, mesh)
    st = step(st, codes[:half], lengths[:half], bcs[:half])
    st = step(st, codes[half:], lengths[half:], bcs[half:])
    gh, gc = D.gather_compact(st)
    expect = single_device_counts(spec, codes, lengths, bcs)
    assert dict(zip(gh.tolist(), gc.tolist())) == expect


def test_lane_overflow_is_counted():
    """Tiny lane capacity forces routing drops; they must be counted, not silent."""
    spec = HashSpec(k=21, w=7, seed=17)
    codes, lengths, bcs = sim_lane(seed=4)
    mesh = D.make_mesh(8)
    st = D.ShardedTable(mesh, bits_per_shard=17)
    step = D.make_count_step(spec, mesh, lane_capacity=8)
    st = step(st, codes, lengths, bcs)
    drops = int(np.asarray(st.route_drops).sum())
    assert drops > 0
    gh, gc = D.gather_compact(st)
    expect = single_device_counts(spec, codes, lengths, bcs)
    # delivered mass + dropped mass == total mass
    assert int(gc.sum()) + drops == sum(expect.values())


# ---- sorted-table sharded path (production count path) ----

from hash10x_jax.dist import sharded_sorted as DS


@pytest.mark.parametrize("n_mesh", [1, 2, 8])
def test_sharded_sorted_equals_single_device(n_mesh):
    spec = HashSpec(k=21, w=7, seed=17)
    codes, lengths, bcs = sim_lane()
    mesh = D.make_mesh(n_mesh)
    t = DS.ShardedSortedTable(mesh, capacity=1 << 17, buf_capacity=1 << 20,
                              spec=spec)
    step = DS.make_sorted_count_step(spec, mesh)
    half = len(codes) // 2
    t = step(t, codes[:half], lengths[:half], bcs[:half])
    t = step(t, codes[half:], lengths[half:], bcs[half:])
    t = step.finish(t)
    assert int(np.asarray(t.route_drops).sum()) == 0
    assert int(np.asarray(t.spilled).sum()) == 0
    gh, gc = DS.gather_sorted_compact(t)
    expect = single_device_counts(spec, codes, lengths, bcs)
    assert dict(zip(gh.tolist(), gc.tolist())) == expect
    # histogram psum merge agrees
    hist = DS.sorted_histogram(t, 64)
    eh = np.bincount(np.clip(gc, 0, 64), minlength=65)
    eh[0] = 0
    assert (hist == eh).all()


def test_snapshot_restore_mesh_portable(tmp_path):
    spec = HashSpec(k=17, w=5, seed=11)
    codes, lengths, bcs = sim_lane(seed=6)
    mesh8 = D.make_mesh(8)
    t = DS.ShardedSortedTable(mesh8, capacity=1 << 17, buf_capacity=1 << 20,
                              spec=spec)
    step = DS.make_sorted_count_step(spec, mesh8)
    t = step(t, codes, lengths, bcs)
    t = step.finish(t)
    gh, gc = DS.gather_sorted_compact(t)
    DS.save_snapshot(t, str(tmp_path / "snap"))
    # reload on a 2-device mesh: same global table
    mesh2 = D.make_mesh(2)
    t2 = DS.load_snapshot(str(tmp_path / "snap"), mesh2, capacity=1 << 17,
                          expect_spec=spec)
    gh2, gc2 = DS.gather_sorted_compact(t2)
    assert (gh == gh2).all() and (gc == gc2).all()
    # shard ownership under the new mesh: contiguous ascending value ranges
    keys = np.asarray(t2.hashes)
    split = DS.range_splitters(spec, 2, t2.range_eff)
    for s in range(2):
        k = keys[s][keys[s] != U64MAX]
        assert (np.searchsorted(split, k, side="right") == s).all()
        assert (np.diff(k.astype(np.int64)) > 0).all()  # shard-local ascending
    # spec mismatch rejected
    with pytest.raises(ValueError):
        DS.load_snapshot(str(tmp_path / "snap"), mesh2,
                         expect_spec=HashSpec(k=19, w=5, seed=11))


def test_engine_sharded_equals_single():
    """Engine(n_shards=8) == Engine(n_shards=1) end-to-end (histogram,
    retained set, cluster labels)."""
    from hash10x_jax.engine import Engine, EngineConfig
    from hash10x_jax.io import fqb as FB
    from hash10x_jax.io.sim import SimConfig, simulate
    sim = simulate(SimConfig(genome_len=60_000, n_barcodes=24,
                             molecules_per_barcode=2, molecule_len=5000,
                             reads_per_molecule=30, read_len=120, seed=8))
    fqb = FB.from_read_batch(sim.reads)
    outs = []
    for n in (1, 8):
        eng = Engine(EngineConfig(spec=HashSpec(k=21, w=7, seed=17),
                                  table_bits=18, batch_reads=512,
                                  min_count=2, max_count=30,
                                  min_friend_share=15, n_shards=n), log=None)
        eng.count(fqb)
        eng.filter()
        eng.incidence(fqb)
        eng.cluster()
        outs.append(eng)
    a, b = outs
    assert (a.histogram(64) == b.histogram(64)).all()
    assert (a.retained_hashes == b.retained_hashes).all()
    assert (a.retained_counts == b.retained_counts).all()
    # the sharded incidence build must reproduce the exact pair set
    assert (a.inc.code_offsets == b.inc.code_offsets).all()
    assert (a.inc.code_kmers == b.inc.code_kmers).all()
    assert (a.inc.kmer_offsets == b.inc.kmer_offsets).all()
    assert (a.inc.kmer_codes == b.inc.kmer_codes).all()
    for c in range(a.inc.n_codes):
        assert a.clusters[c].tolist() == b.clusters[c].tolist()


@pytest.mark.parametrize("n_mesh", [2, 8])
def test_sharded_incidence_with_ns_and_short_reads(n_mesh):
    """The sharded incidence pass must stay exact through the jnp fallbacks:
    reads with N bases (nmask) and short reads (0 < P_i < w)."""
    from hash10x_jax.engine import Engine, EngineConfig
    from hash10x_jax.io import fqb as FB
    from hash10x_jax.io.sim import SimConfig, simulate
    sim = simulate(SimConfig(genome_len=40_000, n_barcodes=12,
                             molecules_per_barcode=2, molecule_len=4000,
                             reads_per_molecule=24, read_len=100, seed=5))
    rb = sim.reads
    # inject Ns into some reads and shorten others into the 0 < P_i < w band
    codes = rb.codes.copy()
    lens = rb.lengths.copy()
    spec = HashSpec(k=21, w=7, seed=17)
    codes[::7, 3] = 4                        # N (invalid base)
    lens[3::11] = spec.k + spec.w - 3        # P_i = w - 2: kernel would skip
    rb2 = type(rb)(codes=codes, lengths=lens, barcodes=rb.barcodes)
    fqb = FB.from_read_batch(rb2)
    outs = []
    for n in (1, n_mesh):
        eng = Engine(EngineConfig(spec=spec, table_bits=16, batch_reads=512,
                                  min_count=2, max_count=40, n_shards=n),
                     log=None)
        eng.count(fqb)
        eng.filter()
        eng.incidence(fqb)
        outs.append(eng.inc)
    a, b = outs
    assert a.n_pairs == b.n_pairs
    assert (a.code_offsets == b.code_offsets).all()
    assert (a.code_kmers == b.code_kmers).all()


@pytest.mark.parametrize("n_mesh,mode_kw", [
    (2, {}), (8, {}), (8, {"count_mode": "barcodes"})])
def test_scan_stacked_equals_per_batch(n_mesh, mode_kw):
    """One device-major stacked dispatch of S batches (the multi-process
    scan-fusion path) must produce exactly the table the per-batch step
    builds — including zero-pad batches past the real count."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    spec = HashSpec(k=21, w=7, seed=17)
    codes, lengths, bcs = sim_lane()
    mesh = D.make_mesh(n_mesh)
    bsz = 256
    n_b = len(codes) // bsz          # real batches
    S = 1 << (n_b - 1).bit_length()  # pow2 with pad batches
    perdev = bsz // n_mesh

    def fresh():
        return DS.ShardedSortedTable(mesh, capacity=1 << 17,
                                     buf_capacity=1 << 20, spec=spec)

    step = DS.make_sorted_count_step(spec, mesh, **mode_kw)
    want = fresh()
    for b in range(n_b):
        sl = slice(b * bsz, (b + 1) * bsz)
        want = step(want, codes[sl], lengths[sl], bcs[sl])
    want = step.finish(want)
    wh, wc = DS.gather_sorted_compact(want)

    def stack(arr, pad, dtype, width=0):
        shape = (S, bsz, width) if width else (S, bsz)
        out = np.full(shape, pad, dtype)
        for b in range(n_b):
            out[b] = arr[b * bsz:(b + 1) * bsz]
        out = out.reshape((S, n_mesh, perdev) + out.shape[2:])
        out = np.moveaxis(out, 0, 1)
        return jax.device_put(
            jnp.asarray(out.reshape((n_mesh * S * perdev,) + out.shape[3:])),
            NamedSharding(mesh, P("d")))

    got = fresh()
    got = step.scan_stacked(
        got, stack(codes, 0, codes.dtype, codes.shape[1]),
        stack(lengths, 0, np.int32), stack(bcs, -1, np.int32),
        None, S, n_b)
    got = step.finish(got)
    assert int(np.asarray(got.route_drops).sum()) == 0
    gh, gc = DS.gather_sorted_compact(got)
    assert gh.tolist() == wh.tolist()
    assert gc.tolist() == wc.tolist()


def test_force_routing_env_matches_specialized(monkeypatch):
    """H10X_FORCE_ROUTING=1 (the bench routing-A/B knob) must route the n=1
    lane through the n>1 code path and produce the identical table — the
    knob isolates routing-machinery COST, never output."""
    spec = HashSpec(k=21, w=7, seed=17)
    codes, lengths, bcs = sim_lane()
    mesh = D.make_mesh(1)
    bsz = 256

    def run():
        t = DS.ShardedSortedTable(mesh, capacity=1 << 17,
                                  buf_capacity=1 << 20, spec=spec)
        step = DS.make_sorted_count_step(spec, mesh)
        for b in range(len(codes) // bsz):
            sl = slice(b * bsz, (b + 1) * bsz)
            t = step(t, codes[sl], lengths[sl], bcs[sl])
        t = step.finish(t)
        return DS.gather_sorted_compact(t)

    wh, wc = run()
    monkeypatch.setenv("H10X_FORCE_ROUTING", "1")
    gh, gc = run()
    assert gh.tolist() == wh.tolist()
    assert gc.tolist() == wc.tolist()


def test_lane_overflow_auto_retry_completes():
    """A pathologically skewed lane (identical reads -> every emission owned
    by ONE shard) overflows the expected-load auto-sized lanes; the engine
    must recount with doubled lanes instead of aborting
    and end byte-identical to the plain single-device pass."""
    from hash10x_jax.engine import Engine, EngineConfig
    from hash10x_jax.io.fqb import Fqb
    from hash10x_jax.core.encode import pack_2bit
    import hash10x_jax.table.sorted_table as st

    n, L = 2048, 120
    reads = np.zeros((n, L), np.uint8)        # poly-A: one canonical k-mer
    fqb = Fqb(packed=pack_2bit(reads), lengths=np.full(n, L, np.int32),
              barcode_ids=np.zeros(n, np.int32),
              barcode_keys=np.zeros(1, np.uint32), read_len=L)

    def mk(shards):
        # w=1: every position emits (no per-read compaction), so the one
        # value's owner receives per*P keys >> the 2E/n + 4096 auto lane
        return Engine(EngineConfig(spec=HashSpec(k=21, w=1, seed=17),
                                   count_mode="occurrences", table_bits=14,
                                   batch_reads=2048, flush_batches=2,
                                   n_shards=shards), log=None)

    plain = mk(1)
    plain.count(fqb)
    ph, pc = st.compact(plain._flushed())

    stages = []
    sharded = mk(8)
    sharded.timer.stage = lambda msg: stages.append(msg)  # capture retries
    sharded.count(fqb)
    from hash10x_jax.dist import sharded_sorted as DS
    gh, gc = DS.gather_sorted_compact(sharded._dt)
    assert any("lane overflow" in s for s in stages), stages
    assert sharded.cfg.lane_capacity > 0   # the grown knob sticks
    np.testing.assert_array_equal(np.asarray(ph), gh)
    np.testing.assert_array_equal(np.asarray(pc), gc)
