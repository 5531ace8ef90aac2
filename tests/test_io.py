"""Host IO: FASTQ/FASTA parse, barcode extraction, fqb round-trip, simulator."""

import gzip

import numpy as np

from hash10x_jax.core.encode import ascii_to_codes, codes_to_ascii
from hash10x_jax.io import fastq as FQ
from hash10x_jax.io import fqb as FB
from hash10x_jax.io.sim import SimConfig, simulate


def write_fastq(path, records):
    with open(path, "wb") as f:
        for name, seq in records:
            f.write(b"@" + name + b"\n" + seq + b"\n+\n" + b"I" * len(seq) + b"\n")


def test_fastq_parse_ragged(tmp_path):
    recs = [(b"r1", b"ACGTACGTAC"), (b"r2 extra", b"TTTT"), (b"r3", b"ACGNNACGT")]
    p = tmp_path / "t.fastq"
    write_fastq(p, recs)
    b = FQ.read_fastq(p, with_names=True)
    assert len(b) == 3 and b.names == [b"r1", b"r2", b"r3"]
    assert b.lengths.tolist() == [10, 4, 9]
    assert bytes(codes_to_ascii(b.codes[0][:10])) == b"acgtacgtac"
    assert (b.codes[1][4:] == 4).all()          # padding invalid
    assert b.codes[2][3] == 4 and b.codes[2][4] == 4  # Ns invalid


def test_fastq_gz(tmp_path):
    p = tmp_path / "t.fastq.gz"
    with gzip.open(p, "wb") as f:
        f.write(b"@r\nACGT\n+\nIIII\n")
    b = FQ.read_fastq(p)
    assert b.lengths.tolist() == [4]


def test_fasta_records(tmp_path):
    p = tmp_path / "g.fa"
    p.write_bytes(b">chr1 desc\nACGT\nACGT\n>chr2\nTTTT\n")
    recs = list(FQ.fasta_records(p))
    assert recs == [(b"chr1", b"ACGTACGT"), (b"chr2", b"TTTT")]


def test_barcode_extraction():
    bc = b"ACGTACGTACGTACGT"
    seq = b"TTTTGGGG"
    codes = ascii_to_codes(bc + seq)[None, :]
    batch = FQ.ReadBatch(codes=np.asarray(codes), lengths=np.array([24], np.int32))
    keys, rest = FQ.extract_barcodes(batch)
    assert rest.lengths.tolist() == [8]
    assert bytes(codes_to_ascii(rest.codes[0][:8])) == b"ttttgggg"
    # key packs base0 into top bits: acgt x4 = 0b00011011 repeated
    assert keys[0] == int("00011011" * 4, 2)
    # N in barcode -> invalid
    codes2 = ascii_to_codes(b"N" + bc[1:] + seq)[None, :]
    k2, r2 = FQ.extract_barcodes(FQ.ReadBatch(codes=np.asarray(codes2), lengths=np.array([24], np.int32)))
    assert k2[0] == 0xFFFFFFFF and r2.lengths[0] == 0


def test_fqb_roundtrip(tmp_path):
    sim = simulate(SimConfig(genome_len=5000, n_barcodes=4, molecules_per_barcode=2,
                             molecule_len=1000, reads_per_molecule=5, read_len=100))
    fqb = FB.from_read_batch(sim.reads)
    assert fqb.n_barcodes == 4
    p = tmp_path / "x.fqb"
    FB.save_fqb(p, fqb)
    f2 = FB.load_fqb(str(p) + ".npz")
    assert (f2.packed == fqb.packed).all()
    assert (f2.barcode_ids == fqb.barcode_ids).all()
    assert (f2.barcode_keys == fqb.barcode_keys).all()
    # unpack restores the simulated bases exactly (sim emits no Ns)
    assert (f2.codes() == sim.reads.codes).all()
    # barcode id remap is key-sorted: ids ascend with keys
    keys_by_id = f2.barcode_keys[f2.barcode_ids]
    assert (keys_by_id == sim.barcode_keys).all()


def test_fastq_to_fqb_pipeline(tmp_path):
    rng = np.random.default_rng(0)
    bases = b"ACGT"
    recs = []
    for i in range(10):
        bc = bytes(bases[b] for b in rng.integers(0, 4, 16))
        seq = bytes(bases[b] for b in rng.integers(0, 4, 80))
        recs.append((b"r%d" % i, bc + seq))
    p = tmp_path / "lane.fastq"
    write_fastq(p, recs)
    fqb = FB.fastq_to_fqb(p, out_path=tmp_path / "lane.fqb")
    assert len(fqb) == 10 and fqb.read_len == 80
    assert (tmp_path / "lane.fqb.npz").exists()


def test_simulator_truth_consistency():
    cfg = SimConfig(genome_len=30000, n_barcodes=8, molecules_per_barcode=3,
                    molecule_len=5000, reads_per_molecule=10, read_len=120, seed=3)
    sim = simulate(cfg)
    assert len(sim.reads) == 8 * 3 * 10
    # every read's bases appear at its molecule's span in the right haplotype
    for r in [0, 57, 239]:
        m = sim.truth_molecule[r]
        hap, s, e = sim.truth_span[m]
        g = sim.genome if hap == 0 else sim.genome_hap1
        hay = bytes(g[s:e])
        assert bytes(sim.reads.codes[r]) in hay


def test_native_loader_matches_numpy(tmp_path):
    """The C loader's packed output must equal the numpy path exactly,
    including N-in-barcode invalidation and N-in-sequence packing."""
    from hash10x_jax.io import native_loader
    if not native_loader.available():
        import pytest
        pytest.skip("no C toolchain")
    rng = np.random.default_rng(5)
    bases = b"ACGT"
    recs = []
    for i in range(50):
        bc = bytearray(bases[b] for b in rng.integers(0, 4, 16))
        if i % 7 == 0:
            bc[3] = ord("N")                      # invalid barcode
        seqlen = int(rng.integers(30, 120))
        seq = bytearray(bases[b] for b in rng.integers(0, 4, seqlen))
        if i % 5 == 0 and seqlen > 10:
            seq[10] = ord("N")                    # N inside the sequence
        recs.append((b"r%d" % i, bytes(bc) + bytes(seq)))
    p = tmp_path / "lane.fastq"
    write_fastq(p, recs)

    native = FB.fastq_to_fqb(p, prefer_native=True)
    plain = FB.fastq_to_fqb(p, prefer_native=False)
    assert native.read_len == plain.read_len
    assert (native.lengths == plain.lengths).all()
    assert (native.barcode_ids == plain.barcode_ids).all()
    assert (native.barcode_keys == plain.barcode_keys).all()
    assert (native.packed == plain.packed).all()


def test_native_loader_malformed(tmp_path):
    from hash10x_jax.io import native_loader
    if not native_loader.available():
        import pytest
        pytest.skip("no C toolchain")
    p = tmp_path / "bad.fastq"
    p.write_bytes(b"not a fastq\nACGT\n+\nIIII\n")
    import pytest
    with pytest.raises(ValueError):
        native_loader.load_fastq_native(p)


def test_paired_fastq_to_fqb(tmp_path):
    """R2 reads inherit R1's barcode; both mates' bases are counted."""
    rng = np.random.default_rng(1)
    bases = b"ACGT"
    r1, r2 = [], []
    bcs = []
    for i in range(12):
        bc = bytes(bases[b] for b in rng.integers(0, 4, 16))
        bcs.append(bc)
        s1 = bytes(bases[b] for b in rng.integers(0, 4, 60))
        s2 = bytes(bases[b] for b in rng.integers(0, 4, 80))
        r1.append((b"r%d" % i, bc + s1))
        r2.append((b"r%d" % i, s2))
    p1, p2 = tmp_path / "r1.fastq", tmp_path / "r2.fastq"
    write_fastq(p1, r1)
    write_fastq(p2, r2)
    fqb = FB.paired_fastq_to_fqb(p1, p2)
    assert len(fqb) == 24
    # mates share barcodes
    keys = fqb.barcode_keys[fqb.barcode_ids]
    assert (keys[:12] == keys[12:]).all()
    # R2 bases preserved
    from hash10x_jax.core.encode import codes_to_ascii
    codes = fqb.codes()
    got = bytes(codes_to_ascii(codes[12][:fqb.lengths[12]]))
    assert got == r2[0][1].lower()
    # R1 trimmed bases preserved
    got1 = bytes(codes_to_ascii(codes[0][:fqb.lengths[0]]))
    assert got1 == r1[0][1][16:].lower()
