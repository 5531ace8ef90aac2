"""Full-pipeline differential test against the C reference stand-in.

``native/c_ref/hash10x_ref.c`` implements the same documented contract
(hashspec + leftmost-minimum minimizers + barcodes-mode counts + band filter
+ friend clustering + split/report) in plain single-thread C.  The reference
binary itself is unobtainable (SURVEY.md §0 — empty mount), so this pins the
framework's full pipeline against an independent scalar implementation of
its spec: counts, cluster assignments, and the report must match BYTE-FOR-
BYTE."""

import io
import os
import subprocess

import numpy as np
import pytest

from hash10x_jax.hashspec import HashSpec
from hash10x_jax.engine import Engine, EngineConfig
from hash10x_jax.io.fqb import Fqb
from hash10x_jax.core.encode import pack_2bit

SRC = os.path.join(os.path.dirname(__file__), "..", "native", "c_ref",
                   "hash10x_ref.c")


@pytest.fixture(scope="module")
def c_ref_exe(tmp_path_factory):
    exe = str(tmp_path_factory.mktemp("cref") / "hash10x_ref")
    subprocess.run(["gcc", "-O2", "-o", exe, SRC], check=True,
                   capture_output=True)
    return exe


def _molecule_lane(rng, n_reads=3000, n_codes=60, read_len=120,
                   genome_len=400_000, mol_len=12_000):
    genome = rng.integers(0, 4, size=genome_len).astype(np.uint8)
    mol_starts = rng.integers(0, genome_len - mol_len, size=n_codes)
    bc = np.repeat(np.arange(n_codes, dtype=np.int32), n_reads // n_codes)
    offs = rng.integers(0, mol_len - read_len, size=len(bc))
    starts = mol_starts[bc] + offs
    reads = genome[starts[:, None] + np.arange(read_len)[None, :]]
    return reads, bc


def _write_inputs(tmp_path, reads, bc):
    rb = tmp_path / "reads.bin"
    with open(rb, "wb") as f:
        np.array([len(reads), reads.shape[1]], np.uint32).tofile(f)
        reads.astype(np.uint8).tofile(f)
    bb = tmp_path / "bc.bin"
    bc.astype(np.uint32).tofile(bb)
    return str(rb), str(bb)


def test_c_ref_full_pipeline_bit_equal(rng, c_ref_exe, tmp_path):
    k, w, seed = 21, 7, 17
    reads, bc = _molecule_lane(rng)
    rb, bb = _write_inputs(tmp_path, reads, bc)
    dump = str(tmp_path / "counts.bin")
    clus = str(tmp_path / "clusters.txt")
    rep = str(tmp_path / "report.txt")
    out = subprocess.run(
        [c_ref_exe, rb, str(k), str(w), str(seed), "20",
         "--barcodes", bb, "--minCount", "2", "--maxCount", "64",
         "--friendShare", "4", "--cluster",
         "--dump", dump, "--dumpClusters", clus, "--report", rep],
        check=True, capture_output=True, text=True).stdout
    assert "molecules" in out

    fqb = Fqb(packed=pack_2bit(reads),
              lengths=np.full(len(reads), reads.shape[1], np.int32),
              barcode_ids=bc,
              barcode_keys=np.arange(bc.max() + 1, dtype=np.uint32),
              read_len=reads.shape[1])
    cfg = EngineConfig(spec=HashSpec(k=k, w=w, seed=seed),
                       count_mode="barcodes", table_bits=16,
                       batch_reads=512, min_count=2, max_count=64,
                       min_friend_share=4)
    eng = Engine(cfg, log=None)
    eng.count(fqb)

    # counts: C dump (sorted hash, distinct-barcode count) == engine table
    with open(dump, "rb") as f:
        m = int(np.fromfile(f, np.uint64, 1)[0])
        c_hashes = np.fromfile(f, np.uint64, m)
        c_counts = np.fromfile(f, np.uint32, m)
    import hash10x_jax.table.sorted_table as st
    e_hashes, e_counts = st.compact(eng._flushed())
    np.testing.assert_array_equal(np.asarray(e_hashes), c_hashes)
    np.testing.assert_array_equal(np.asarray(e_counts), c_counts)

    # clusters: byte-identical (code, kmer hash, cluster) dump
    eng.filter()
    eng.incidence(fqb)
    eng.cluster()
    buf = io.StringIO()
    eng.write_clusters(buf)
    with open(clus) as f:
        assert buf.getvalue() == f.read()

    # report: byte-identical per-code cluster report
    buf = io.StringIO()
    eng.report(buf)
    with open(rep) as f:
        assert buf.getvalue() == f.read()


def test_c_ref_occurrence_mode_still_matches(rng, c_ref_exe, tmp_path):
    """The original config-#1 surface (occurrence counts, no barcodes)."""
    k, w, seed = 21, 11, 17
    reads = rng.integers(0, 4, size=(2000, 100)).astype(np.uint8)
    rb, _ = _write_inputs(tmp_path, reads, np.zeros(len(reads), np.int32))
    dump = str(tmp_path / "counts.bin")
    subprocess.run([c_ref_exe, rb, str(k), str(w), str(seed), "20",
                    "--dump", dump], check=True, capture_output=True)
    with open(dump, "rb") as f:
        m = int(np.fromfile(f, np.uint64, 1)[0])
        c_hashes = np.fromfile(f, np.uint64, m)
        c_counts = np.fromfile(f, np.uint32, m)

    fqb = Fqb(packed=pack_2bit(reads),
              lengths=np.full(len(reads), reads.shape[1], np.int32),
              barcode_ids=np.zeros(len(reads), np.int32),
              barcode_keys=np.zeros(1, np.uint32), read_len=reads.shape[1])
    cfg = EngineConfig(spec=HashSpec(k=k, w=w, seed=seed),
                       count_mode="occurrences", table_bits=16,
                       batch_reads=512)
    eng = Engine(cfg, log=None)
    eng.count(fqb)
    import hash10x_jax.table.sorted_table as st
    e_hashes, e_counts = st.compact(eng._flushed())
    np.testing.assert_array_equal(np.asarray(e_hashes), c_hashes)
    np.testing.assert_array_equal(np.asarray(e_counts), c_counts)
