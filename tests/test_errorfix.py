"""Error-band correction with barcode-context rescue (SURVEY.md §3.1 #12).

Semantics under test (documented in engine.error_fix): in barcodes count
mode, k-mers with count <= max (single-GEM k-mers) are the error band; with
--errorFixReads M and loaded reads, band k-mers that occur in >= M reads are
RESCUED (a sequencing error is read-unique; a real low-coverage k-mer recurs
across its molecule's reads), the rest are dropped.
"""

import io

import numpy as np
import pytest

from hash10x_jax.hashspec import HashSpec
from hash10x_jax.engine import Engine, EngineConfig
from hash10x_jax.io.fqb import Fqb
from hash10x_jax.core.encode import pack_2bit
from hash10x_jax.oracle import seqhash_ref


L = 80
SPEC = HashSpec(k=21, w=11, seed=17)


def lane(rng):
    """3 regions: X seen 3x in barcode 0 only (rescuable), Y once in barcode
    1 only (droppable), Z once in each of barcodes 2..9 (good count)."""
    gx = rng.integers(0, 4, size=L).astype(np.uint8)
    gy = rng.integers(0, 4, size=L).astype(np.uint8)
    gz = rng.integers(0, 4, size=L).astype(np.uint8)
    reads = np.stack([gx, gx, gx, gy] + [gz] * 8)
    bcs = np.array([0, 0, 0, 1] + list(range(2, 10)), np.int32)
    fqb = Fqb(packed=pack_2bit(reads), lengths=np.full(len(reads), L, np.int32),
              barcode_ids=bcs,
              barcode_keys=np.arange(10, dtype=np.uint32), read_len=L)
    return fqb, gx, gy, gz


def kmer_set(genome):
    return {h for _, h, _ in seqhash_ref.minimizers(SPEC, list(genome))}


def table_keys(eng):
    buf = io.StringIO()
    eng.write_counts(buf)
    return {int(line.split()[0], 16) for line in buf.getvalue().splitlines()}


@pytest.mark.parametrize("min_reads,expect_x", [(0, False), (2, True),
                                                (4, False)])
def test_errorfix_context_rescue(rng, min_reads, expect_x):
    fqb, gx, gy, gz = lane(rng)
    sx, sy, sz = kmer_set(gx), kmer_set(gy), kmer_set(gz)
    # regions are random and long; their minimizer sets must be disjoint for
    # the membership assertions below to be meaningful
    assert not (sx & sy) and not (sx & sz) and not (sy & sz)
    cfg = EngineConfig(spec=SPEC, count_mode="barcodes", table_bits=12,
                       batch_reads=16)
    eng = Engine(cfg, log=None)
    eng.count(fqb)
    eng.error_fix(1, fqb=fqb, min_reads=min_reads)
    keys = table_keys(eng)
    assert sz <= keys                      # good band always kept
    assert not (sy & keys)                 # read-unique error always dropped
    assert (sx <= keys) == expect_x        # rescued iff occurrences >= M
    if not expect_x:
        assert not (sx & keys)


def test_errorfix_droponly_matches_prune(rng):
    fqb, *_ = lane(rng)
    outs = []
    for kwargs in ({}, {"fqb": fqb, "min_reads": 0}):
        cfg = EngineConfig(spec=SPEC, count_mode="barcodes", table_bits=12,
                           batch_reads=16)
        eng = Engine(cfg, log=None)
        eng.count(fqb)
        eng.error_fix(1, **kwargs)
        outs.append(frozenset(table_keys(eng)))
    assert outs[0] == outs[1]


def test_errorfix_cli_flag(rng, tmp_path):
    """--errorFixReads wires through the CLI command language."""
    from hash10x_jax.cli.main import main
    fqb, gx, gy, gz = lane(rng)
    from hash10x_jax.io.fqb import save_fqb
    p = tmp_path / "lane.fqb.npz"
    save_fqb(str(p), fqb)
    outs = {}
    for flag_reads in (0, 2):
        f = tmp_path / f"counts_{flag_reads}.txt"
        main(["--errorFixReads", str(flag_reads), "--batchReads", "16",
              "--readFQB", str(p), "--errorFix", "1",
              "--writeCounts", str(f)], out=io.StringIO(), err=io.StringIO())
        outs[flag_reads] = {int(l.split()[0], 16)
                            for l in f.read_text().splitlines()}
    sx = kmer_set(gx)
    assert not (sx & outs[0])
    assert sx <= outs[2]
