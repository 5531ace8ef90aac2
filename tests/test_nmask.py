"""N-base validity must survive the packed (.fqb) round trip: k-mers spanning
an N never count, and fqb-path counts equal text-path counts for the same reads
(packing N as 'a' would mint k-mers that don't exist)."""

import io as _io

import numpy as np

from hash10x_jax.core import encode as E
from hash10x_jax.engine import Engine, EngineConfig
from hash10x_jax.hashspec import HashSpec
from hash10x_jax.io import fqb as FB
from hash10x_jax.io.fastq import ReadBatch
from hash10x_jax.oracle import seqhash_ref as SR


def test_nmask_pack_roundtrip(rng):
    codes = rng.integers(0, 4, size=(8, 50)).astype(np.uint8)
    codes[2, 10] = 4
    codes[5, 0] = 4
    codes[5, 49] = 4
    nm = E.nmask_from_codes(codes)
    packed = E.pack_2bit(codes)
    back = E.unpack_2bit(packed, 50, nm)
    assert (back == codes).all()


def test_nmask_jnp_matches_numpy(rng):
    codes = rng.integers(0, 4, size=(4, 40)).astype(np.uint8)
    codes[1, 7] = 4
    codes[3, 39] = 4
    nm = E.nmask_from_codes(codes)
    packed = E.pack_2bit(codes)
    a = E.unpack_2bit(packed, 40, nm)
    b = np.asarray(E.unpack_2bit_jnp(packed, 40, nm))
    assert (a == b).all()


def _fastq_bytes(reads):
    out = []
    for i, (bc, seq) in enumerate(reads):
        s = bc + seq
        out.append(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")
    return "".join(out).encode()


def _counts(engine):
    import hash10x_jax.table.sorted_table as st
    h, c = st.compact(engine._flushed())
    return dict(zip(h.tolist(), c.tolist()))


def test_fqb_counts_equal_text_counts_with_ns(rng, tmp_path):
    """Reads containing Ns: count table from the packed fqb path must equal
    the scalar text oracle (which invalidates N windows)."""
    bases = "acgt"
    bc = "acgtacgtacgtacgt"
    reads = []
    for i in range(24):
        seq = "".join(bases[rng.integers(0, 4)] for _ in range(60))
        if i % 3 == 0:  # salt Ns into a third of the reads
            p = int(rng.integers(5, 55))
            seq = seq[:p] + "N" + seq[p + 1:]
        reads.append((bc, seq))
    fq = tmp_path / "lane.fastq"
    fq.write_bytes(_fastq_bytes(reads))

    fqb = FB.fastq_to_fqb(str(fq), prefer_native=False)
    assert fqb.nmask is not None
    spec = HashSpec(k=13, w=5)
    eng = Engine(EngineConfig(spec=spec, mode="minimizer", batch_reads=32,
                              count_mode="occurrences"), log=None)
    eng.count(fqb)
    got = _counts(eng)

    expect = {}
    for _, seq in reads:
        for _, h, _ in SR.minimizers(spec, E.ascii_to_codes(seq)):
            expect[h] = expect.get(h, 0) + 1
    assert got == expect


def test_native_loader_nmask_matches_numpy(rng, tmp_path):
    from hash10x_jax.io import native_loader
    if not native_loader.available():
        import pytest
        pytest.skip("no native toolchain")
    bases = "acgt"
    bc = "ttttacgtacgtacgt"
    reads = []
    for i in range(10):
        seq = "".join(bases[rng.integers(0, 4)] for _ in range(44))
        if i in (2, 7):
            seq = seq[:11] + "NN" + seq[13:]
        reads.append((bc, seq))
    fq = tmp_path / "n.fastq"
    fq.write_bytes(_fastq_bytes(reads))
    native = FB.fastq_to_fqb(str(fq), prefer_native=True)
    plain = FB.fastq_to_fqb(str(fq), prefer_native=False)
    assert (native.packed == plain.packed).all()
    assert (native.nmask is None) == (plain.nmask is None)
    if native.nmask is not None:
        assert (native.nmask == plain.nmask).all()


def test_fqb_save_load_keeps_nmask(rng, tmp_path):
    codes = rng.integers(0, 4, size=(6, 30)).astype(np.uint8)
    codes[0, 3] = 4
    lengths = np.full(6, 30, np.int32)
    batch = ReadBatch(codes=codes, lengths=lengths,
                      barcodes=np.arange(6, dtype=np.uint32))
    fqb = FB.from_read_batch(batch)
    assert fqb.nmask is not None
    p = tmp_path / "x.fqb.npz"
    FB.save_fqb(p, fqb)
    back = FB.load_fqb(p)
    assert (back.nmask == fqb.nmask).all()
    assert (back.codes() == fqb.codes()).all()
