"""GPU-lowering regression tests on the card.

These cover exactly what the CPU suite cannot: XLA's GPU lowering of the
count passes' sketch (full width and packed) and the engine's count →
incidence → cluster pipeline, against the pure-Python oracles.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from hash10x_jax import HashSpec, U64MAX
from hash10x_jax.core import seqhash_jnp
from hash10x_jax.core.encode import pack_2bit
from hash10x_jax.engine import Engine, EngineConfig
from hash10x_jax.io.fqb import Fqb
from hash10x_jax.oracle import cluster_ref as CO
from hash10x_jax.oracle import seqhash_ref
from hash10x_jax.table import sorted_table as st

pytestmark = pytest.mark.chip

SPEC = HashSpec(k=21, w=11, seed=17)


def _batch(rng, lengths_head):
    B, L = 1024, 150
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lengths = np.full(B, L, np.int32)
    lengths[:len(lengths_head)] = lengths_head
    return codes, lengths


def test_sketch_bit_equals_oracle_on_chip(rng):
    """The minimizer sketch under XLA's GPU lowering == the scalar oracle,
    including ragged reads and runs shorter than the window."""
    codes, lengths = _batch(rng, [150, 149, 100, 32, 31, 21, 0])
    h, f, e = (np.asarray(x) for x in seqhash_jnp.sketch(
        SPEC, jnp.asarray(codes), jnp.asarray(lengths), mode="minimizer"))
    for r in list(range(7)) + list(range(100, 1024, 101)):
        want = seqhash_ref.minimizers(SPEC, list(codes[r][: lengths[r]]))
        got = [(p, int(h[r, p]), bool(f[r, p]))
               for p in range(h.shape[1]) if e[r, p]]
        assert got == want, f"read {r}"


def test_compaction_on_chip(rng):
    """Emission packing on the card: the batch's emissions in row-major
    order with their read indices, U64MAX pads, exact overflow (none at the
    engine width, with a poly-G read and N bases in the batch)."""
    codes, lengths = _batch(rng, [150, 100, 31, 0])
    codes = np.where(rng.random(codes.shape) < 0.01, 4, codes).astype(
        np.uint8)
    codes[10] = 2
    C = seqhash_jnp.compact_width(SPEC, 130)
    h0, _, e0 = (np.asarray(x) for x in seqhash_jnp.sketch(
        SPEC, jnp.asarray(codes), jnp.asarray(lengths)))
    flat, read, over = (np.asarray(x) for x in seqhash_jnp.sketch_emitted(
        SPEC, jnp.asarray(codes), jnp.asarray(lengths), compact_to=C))
    assert int(over) == 0
    n = int(e0.sum())
    assert e0[10].sum() > C
    assert flat[:n].tolist() == h0[e0].tolist()
    assert read[:n].tolist() == np.nonzero(e0)[0].tolist()
    assert (flat[n:] == np.uint64(U64MAX)).all()


def test_sketch_modes_on_chip(rng):
    """kmer/modimizer/syncmer under XLA's GPU lowering == the oracle."""
    codes, lengths = _batch(rng, [150, 100, 25])
    for mode, kw, ref in [
            ("kmer", {}, lambda c: seqhash_ref.kmer_hashes(SPEC, c)),
            ("modimizer", {"m": 11},
             lambda c: seqhash_ref.modimizers(SPEC, c, m=11)),
            ("syncmer", {"syncmer_s": 11},
             lambda c: seqhash_ref.syncmers(SPEC, c, s=11))]:
        h, f, e = (np.asarray(x) for x in seqhash_jnp.sketch(
            SPEC, jnp.asarray(codes), jnp.asarray(lengths), mode=mode,
            m=kw.get("m", 0), syncmer_s=kw.get("syncmer_s", 0)))
        for r in (0, 1, 2, 500, 1023):
            got = [(p, int(h[r, p]), bool(f[r, p]))
                   for p in range(h.shape[1]) if e[r, p]]
            assert got == ref(list(codes[r][: lengths[r]])), (mode, r)


def test_sorted_table_flush_grow_on_chip(rng):
    """flush_grow adopts capacity on device without spilling."""
    keys = rng.integers(0, 1 << 20, size=1 << 16, dtype=np.uint64)
    t = st.make_sorted_table(1 << 10, 1 << 17)
    t = st.append(t, jnp.asarray(keys))
    t = st.flush_grow(t)
    h, c = st.compact(t)
    u, cnt = np.unique(keys, return_counts=True)
    assert (h == u).all() and (c == cnt).all()
    assert int(np.asarray(t.spilled)) == 0


def test_engine_pipeline_on_chip(rng):
    """count -> filter -> incidence -> cluster on chip, oracle-checked."""
    genome = rng.integers(0, 4, size=120_000).astype(np.uint8)
    N, n_codes = 4096, 128
    mol = rng.integers(0, len(genome) - 15_000, size=n_codes)
    bc = np.repeat(np.arange(n_codes, dtype=np.int32), N // n_codes)
    starts = mol[bc] + rng.integers(0, 15_000 - 150, size=N)
    reads = np.stack([genome[s:s + 150] for s in starts])
    fqb = Fqb(packed=pack_2bit(reads), lengths=np.full(N, 150, np.int32),
              barcode_ids=bc, barcode_keys=np.arange(n_codes, dtype=np.uint32),
              read_len=150)
    eng = Engine(EngineConfig(spec=SPEC, table_bits=16, batch_reads=1024,
                              min_friend_share=4), log=None)
    eng.count(fqb)
    eng.filter()
    eng.incidence(fqb)
    eng.cluster()
    inc = eng.inc
    assert inc.n_pairs > 0
    hash_codes = {k: inc.codes_of(k).tolist() for k in range(inc.n_kmers)}
    for c in range(0, n_codes, 17):
        want = CO.cluster_barcode_friend(inc.kmers_of(c).tolist(), hash_codes,
                                         c, 4, max_friends=0)
        assert eng.clusters[c].tolist() == want, f"code {c}"
