"""End-to-end smoke of the barcodes pipeline on an NVIDIA GPU.

    python3 chip_smoke.py              # one card: every phase below
    python3 chip_smoke.py --cards 4    # four cards: the --shards 4 pipeline only

Phases, in this one process (a JAX process reserves most of a card's memory,
so nothing else here opens the card):

1. device gate: exits non-zero unless JAX's first device is a GPU, and prints
   the card's name and power limit as nvidia-smi reports them;
2. the count passes' sketch at the engine's shapes (4,096 reads x 150 bp,
   k=21, w=11, seed 17, homopolymer and repeat reads among them), its
   emissions packed into the engine's slots, bit-identical to the full-width
   ``seqhash_jnp.sketch`` and, on sampled rows, to the scalar oracle, in all
   four sketch modes; prints the count step's ``memory_analysis()``;
3. the barcodes pipeline through the CLI on a seeded lane at BASELINE
   config-#3 scale (100 Mb genome, 50,000 barcodes, 30 kb molecules, 800,000
   reads of 150 bp); its cluster dump and its stdout (count histogram +
   cluster report) must be byte-identical to ``native/c_ref`` on the same
   lane, which runs alone before the pipeline;
4. the ``chip``-marked tests of ``tests_chip/`` through ``pytest.main``.

The last line of standard output is one JSON object, printed only when every
phase ran and every comparison held:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises, so the script exits non-zero without that line.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
C_REF_SRC = os.path.join(REPO, "native", "c_ref", "hash10x_ref.c")

K, W, SEED = 21, 11, 17
READ_LEN = 150
MIN_COUNT, MAX_COUNT = 2, 64
FRIEND_SHARE = 8          # the CLI's default --friendShare
HIST_MAX = 256            # Engine.write_histogram's top bin

# BASELINE config-#3 scale (C. elegans-sized genome, ~50k barcodes)
LANE = dict(genome_len=100_000_000, n_barcodes=50_000, molecule_len=30_000,
            n_reads=800_000, read_len=READ_LEN)


def require_gpu():
    """The device gate: JAX's first device must be a GPU, never a fallback
    to the CPU.  Returns the devices."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU found (JAX's first device is "
                         f"{devs[0].platform!r}); this smoke needs an "
                         "NVIDIA GPU")
    return devs


def card_line() -> str:
    """``name, power.limit`` of the cards, from an nvidia-smi child that
    does not import JAX."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip()


def make_lane(seed: int = 11, genome_len: int = LANE["genome_len"],
              n_barcodes: int = LANE["n_barcodes"],
              molecule_len: int = LANE["molecule_len"],
              n_reads: int = LANE["n_reads"], read_len: int = READ_LEN):
    """Seeded linked-read lane: each barcode samples its reads uniformly
    from one molecule of a random genome.  Returns (reads (N, L) uint8
    codes, barcode ids (N,) int32)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len).astype(np.uint8)
    mol_starts = rng.integers(0, genome_len - molecule_len, size=n_barcodes)
    bc = np.repeat(np.arange(n_barcodes, dtype=np.int32),
                   n_reads // n_barcodes)
    offs = rng.integers(0, molecule_len - read_len, size=len(bc))
    starts = mol_starts[bc] + offs
    reads = genome[starts[:, None] + np.arange(read_len)[None, :]]
    return reads, bc


def first_difference(got: str, want: str):
    """Byte offset of the first difference, or None when identical."""
    if got == want:
        return None
    step = 1 << 16
    base = next(i for i in range(0, max(len(got), len(want)), step)
                if got[i:i + step] != want[i:i + step])
    g, w = got[base:base + step], want[base:base + step]
    return base + next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                       min(len(g), len(w)))


def require_identical(name: str, got: str, want: str) -> None:
    at = first_difference(got, want)
    if at is not None:
        raise AssertionError(
            f"{name}: differs from the C stand-in at byte {at} "
            f"(got {got[max(at - 40, 0):at + 40]!r}, "
            f"want {want[max(at - 40, 0):at + 40]!r})")


def histogram_text(counts: np.ndarray) -> str:
    """``--hashDist`` text for a table's counts (Engine.write_histogram)."""
    hist = np.bincount(np.clip(counts.astype(np.int64), 0, HIST_MAX),
                       minlength=HIST_MAX + 1)
    hist[0] = 0
    return "".join(f"{c}\t{int(hist[c])}\n" for c in np.nonzero(hist)[0])


def run_c_ref(tmp: str, reads: np.ndarray, bc: np.ndarray) -> dict:
    """Build and run the single-thread C stand-in on the lane; returns its
    cluster dump, expected CLI stdout and timings."""
    exe = os.path.join(tmp, "hash10x_ref")
    subprocess.run(["gcc", "-O3", "-o", exe, C_REF_SRC], check=True,
                   capture_output=True)
    rb, bb = os.path.join(tmp, "reads.bin"), os.path.join(tmp, "bc.bin")
    with open(rb, "wb") as f:
        np.array([len(reads), reads.shape[1]], np.uint32).tofile(f)
        reads.astype(np.uint8).tofile(f)
    bc.astype(np.uint32).tofile(bb)
    dump, clus, rep = (os.path.join(tmp, n) for n in
                       ("c_counts.bin", "c_clusters.txt", "c_report.txt"))
    t0 = time.monotonic()
    out = subprocess.run(
        [exe, rb, str(K), str(W), str(SEED), "22", "--barcodes", bb,
         "--minCount", str(MIN_COUNT), "--maxCount", str(MAX_COUNT),
         "--friendShare", str(FRIEND_SHARE), "--cluster", "--dump", dump,
         "--dumpClusters", clus, "--report", rep],
        check=True, capture_output=True, text=True).stdout
    wall = time.monotonic() - t0
    with open(dump, "rb") as f:
        m = int(np.fromfile(f, np.uint64, 1)[0])
        np.fromfile(f, np.uint64, m)
        counts = np.fromfile(f, np.uint32, m)
    with open(clus) as f:
        clusters = f.read()
    with open(rep) as f:
        report = f.read()
    return {"clusters": clusters, "stdout": histogram_text(counts) + report,
            "wall_s": wall, "summary": out.strip()}


def compile_seconds():
    """A running total of JAX's trace + lower + compile seconds."""
    import jax
    events = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")
    total = [0.0]

    def listen(event, duration, **_):
        if event in events:
            total[0] += duration
    jax.monitoring.register_event_duration_secs_listener(listen)
    return total


def phase_sketch(card: str) -> None:
    """The count passes' sketch at the engine's shapes, every mode."""
    import jax
    import jax.numpy as jnp
    from hash10x_jax import HashSpec, U64MAX
    from hash10x_jax.core import seqhash_jnp
    from hash10x_jax.core.encode import pack_2bit, nmask_from_codes
    from hash10x_jax.engine import Engine, EngineConfig
    from hash10x_jax.oracle import seqhash_ref

    spec = HashSpec(k=K, w=W, seed=SEED)
    B = 4096
    rng = np.random.default_rng(17)
    codes = rng.integers(0, 4, (B, READ_LEN)).astype(np.uint8)
    lengths = np.full(B, READ_LEN, np.int32)
    lengths[:6] = [150, 149, 100, 31, 25, 0]   # ragged, short, empty
    codes[6] = 2                               # poly-G: emits ~every window
    codes[7] = np.arange(READ_LEN) % 2         # dinucleotide repeat
    with_n = np.where(rng.random(codes.shape) < 0.01, 4, codes).astype(
        np.uint8)                              # N bases break runs
    oracle = {"kmer": lambda c: seqhash_ref.kmer_hashes(spec, c),
              "minimizer": lambda c: seqhash_ref.minimizers(spec, c),
              "modimizer": lambda c: seqhash_ref.modimizers(spec, c, m=11),
              "syncmer": lambda c: seqhash_ref.syncmers(spec, c, s=11)}
    for mode, kw, cs in [("minimizer", {}, codes),
                         ("minimizer", {}, with_n), ("kmer", {}, codes),
                         ("modimizer", {"modulus": 11}, codes),
                         ("syncmer", {"syncmer_s": 11}, codes)]:
        eng = Engine(EngineConfig(spec=spec, mode=mode, batch_reads=B, **kw),
                     log=None)
        eng._read_len = READ_LEN
        C = eng._compact_rows(READ_LEN - K + 1)
        nm = nmask_from_codes(cs) if (cs > 3).any() else None
        flat, read, over = (np.asarray(x) for x in jax.jit(
            eng._sketch_packed)(jnp.asarray(pack_2bit(cs)),
                                None if nm is None else jnp.asarray(nm),
                                jnp.asarray(lengths)))
        h, f, e = (np.asarray(x) for x in jax.jit(
            lambda c, l: seqhash_jnp.sketch(
                spec, c, l, mode=mode, m=kw.get("modulus", 0),
                syncmer_s=kw.get("syncmer_s", 0)))(jnp.asarray(cs),
                                                   jnp.asarray(lengths)))
        # the plain reference packing, on the host: every read's emissions
        # in order into B x C slots (C = 0: the masked full-width grid)
        if C:
            want, want_read = h[e], np.nonzero(e)[0].astype(np.int32)
            want_over = max(len(want) - B * C, 0)
            want = np.concatenate([want, np.full(B * C, np.uint64(U64MAX))]
                                  )[:B * C]
            n = min(len(want_read), B * C)
            ok = (np.array_equal(flat, want)
                  and np.array_equal(read[:n], want_read[:n]))
        else:
            want_over = 0
            ok = (np.array_equal(flat, np.where(e, h, np.uint64(U64MAX))
                                 .reshape(-1))
                  and np.array_equal(read, np.repeat(np.arange(B),
                                                     h.shape[1])))
        if not ok or int(over) != want_over:
            raise AssertionError(f"sketch[{mode}]: packed emissions differ "
                                 "from the full-width seqhash_jnp sketch")
        for r in list(range(8)) + [1000, 2047, 4095]:
            got = [(p, int(h[r, p]), bool(f[r, p]))
                   for p in range(h.shape[1]) if e[r, p]]
            if got != oracle[mode](list(cs[r][: lengths[r]])):
                raise AssertionError(f"sketch[{mode}]: read {r} differs "
                                     "from the scalar oracle")
        print(f"sketch[{mode}{', N bases' if nm is not None else ''}]: "
              f"{B} x {READ_LEN}, {C or h.shape[1]} slots per read, "
              f"{int((flat != np.uint64(U64MAX)).sum())} emissions "
              f"(poly-G read: {int(e[6].sum())}), bit-identical to "
              f"seqhash_jnp, 11 rows to the oracle [{card}]")

    # the count step as the engine compiles it for an 800k-read lane chunk
    eng = Engine(EngineConfig(spec=spec, batch_reads=B), log=None)
    eng._read_len = READ_LEN
    S = eng.cfg.flush_batches
    fn = eng._fused_count_scan(eng._CHUNK_BATCHES * B + B, 0, S)
    eng._ensure_table(fn.slots)
    t = eng.table
    Wp = (READ_LEN + 15) // 16
    rows = eng._CHUNK_BATCHES * B + B
    sds = jax.ShapeDtypeStruct
    args = (sds(t.buf.shape, t.buf.dtype), sds(t.bufw.shape, t.bufw.dtype),
            sds((rows, Wp), jnp.uint32), sds((rows,), jnp.int32),
            sds((rows,), jnp.int32), sds((S,), jnp.int32),
            sds((S,), jnp.int32), sds((), jnp.int32), sds((), jnp.uint32))
    ma = fn.lower(*args).compile().memory_analysis()
    print(f"count step ({S} batches x {B} reads) memory_analysis: {ma} "
          f"[{card}]")


def phase_pipeline(card: str, tmp: str, n_shards: int = 1,
                   lane: dict = None) -> None:
    """The barcodes pipeline through the CLI vs the C stand-in."""
    import jax
    from hash10x_jax.cli.main import main as cli_main
    from hash10x_jax.core.encode import pack_2bit
    from hash10x_jax.io import fqb as FB

    lane = dict(LANE, **(lane or {}))
    t0 = time.monotonic()
    reads, bc = make_lane(**lane)
    fqb_path = os.path.join(tmp, "lane.fqb.npz")
    FB.save_fqb(fqb_path, FB.Fqb(
        packed=pack_2bit(reads), lengths=np.full(len(reads), READ_LEN,
                                                 np.int32),
        barcode_ids=bc, barcode_keys=np.arange(lane["n_barcodes"],
                                               dtype=np.uint32),
        read_len=READ_LEN))
    print(f"lane: {len(reads)} reads x {READ_LEN} bp, {lane['n_barcodes']} "
          f"barcodes, {lane['molecule_len']} bp molecules, "
          f"{lane['genome_len']} bp genome, made in "
          f"{time.monotonic() - t0:.1f}s")
    ref = run_c_ref(tmp, reads, bc)
    del reads
    print(f"C stand-in: {ref['summary']} (wall {ref['wall_s']:.2f}s)")

    metrics = os.path.join(tmp, f"metrics_{n_shards}.jsonl")
    clus = os.path.join(tmp, f"clusters_{n_shards}.txt")
    args = (["--shards", str(n_shards)] if n_shards > 1 else []) + [
        "-k", str(K), "-w", str(W), "-r", str(SEED),
        "--minCount", str(MIN_COUNT), "--maxCount", str(MAX_COUNT),
        "--metrics", metrics, "--devMem",
        "--readFQB", fqb_path, "--hashDist", "--codeClusters",
        "--writeClusters", clus, "--clusterReport", "--clusterSplit"]
    out, err = io.StringIO(), io.StringIO()
    compiled = compile_seconds()
    t0 = time.monotonic()
    rc = cli_main(args, out=out, err=err)
    wall = time.monotonic() - t0
    if rc != 0:
        raise AssertionError(f"CLI exited {rc}: {err.getvalue()[-2000:]}")
    staged = 0.0
    with open(metrics) as f:
        for line in f:
            rec = json.loads(line)
            staged += rec["wall_s"]
            print(f"stage {rec['stage'].split(':')[0]!r}: wall "
                  f"{rec['wall_s']}s since the previous stage [{card}]")
    print(f"after the last stage: wall {wall - staged:.4f}s [{card}]")
    print(f"pipeline --shards {n_shards}: first call {wall:.2f}s wall, of "
          f"which {compiled[0]:.2f}s trace+compile [{card}]")
    for d in jax.devices()[:max(n_shards, 1)]:
        peak = (d.memory_stats() or {}).get("peak_bytes_in_use",
                                            "not reported")
        print(f"device {d.id} peak_bytes_in_use {peak} [{card}]")
    with open(clus) as f:
        require_identical("cluster dump", f.read(), ref["clusters"])
    require_identical("hashDist + clusterReport", out.getvalue(),
                      ref["stdout"])
    print(f"pipeline --shards {n_shards}: cluster dump "
          f"({len(ref['clusters'])} B) and report "
          f"({len(ref['stdout'])} B) byte-identical to the C stand-in")


class _Tally:
    """pytest plugin counting outcomes, so a run that skipped counts as a
    failure of the phase."""

    def __init__(self):
        self.passed = self.skipped = 0

    def pytest_runtest_logreport(self, report):
        if report.when == "call" and report.passed:
            self.passed += 1
        elif report.skipped:
            self.skipped += 1


def phase_tests(card: str) -> None:
    import pytest
    tally = _Tally()
    rc = pytest.main(["-q", "-m", "chip", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests_chip")], plugins=[tally])
    if rc != 0 or tally.skipped or not tally.passed:
        raise AssertionError(f"chip tests: rc {rc}, {tally.passed} passed, "
                             f"{tally.skipped} skipped")
    print(f"chip tests: {tally.passed} passed [{card}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the --shards 4 pipeline on four cards")
    opts = ap.parse_args(argv)

    import hash10x_jax  # noqa: F401  (64-bit types before any jnp use)
    devs = require_gpu()
    if len(devs) < opts.cards:
        raise SystemExit(f"chip_smoke: --cards {opts.cards} needs "
                         f"{opts.cards} GPUs, JAX found {len(devs)}")
    card = card_line()
    print(card)
    card = card.splitlines()[0]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if opts.cards == 4:
            phase_pipeline(card, tmp, n_shards=4)
        else:
            phase_sketch(card)
            phase_pipeline(card, tmp)
            phase_tests(card)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
