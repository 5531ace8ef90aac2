"""Benchmark harness: the engine's count path and barcodes pipeline on an
NVIDIA GPU vs the C baseline.

    python bench.py                   # every point, within the budget
    python bench.py --sketch-share    # only the sketch's share of the count
                                      # step (traced under traces/)

Prints a compact JSON summary line after EVERY completed point (the last
printed line always parses, wherever a time budget lands):
  {"metric": "count_pass_reads_per_s", "value": N, "unit": "reads/s",
   "vs_baseline": N, "device": {...}, "card": "...", "points_brief": [...]}
Full point payloads go to BENCH_DETAIL.json next to this file.  The global
budget is H10X_BENCH_BUDGET_S (default 1200 s); points are gated on the
remaining budget and skipped points are named in the summary.  Without a
GPU the harness exits non-zero and measures nothing.

The headline is the ENGINE count pass (config #1 semantics: minimizer
occurrence counts, single barcode, k=21) — the same code ``--readFQB`` runs,
including host->device ingest, sketch, per-batch pre-reduction, and LSM
table flushes.  ``points`` carries the supporting measurements:

* ``engine_count``      — headline, measured end to end on the card
* ``sketch_share``      — the sketch's share of the count step
* ``engine_barcodes``   — barcodes-mode count+incidence+cluster+split+report
                          walls at config-#3 SCALE (50k barcodes, 800k reads)
* ``cluster_200k``      — the sparse cluster phase alone at 200k codes
* ``routing_ab_1chip``  — the n_shards=1 sharded path, and the same lane
                          forced through the n>1 routing code

vs_baseline is measured against ``native/c_ref/hash10x_ref.c`` — a
single-thread C implementation of the same hashing contract compiled with
gcc -O3 — standing in for the unavailable reference binary (BASELINE.md
"reference-side numbers still to capture").
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Global deadline: points are ordered by value, each is gated on the
# remaining budget against a warm-cache cost estimate, and a compact JSON
# summary line is (re)printed after EVERY completed point so the last line
# always parses no matter where a time limit lands.
BENCH_BUDGET_S = float(os.environ.get("H10X_BENCH_BUDGET_S", "1200"))
_T0 = time.monotonic()


def _remaining() -> float:
    return BENCH_BUDGET_S - (time.monotonic() - _T0)

N_READS = 1 << 18
READ_LEN = 150
BATCH = 1 << 12
K, W, SEED = 21, 11, 17
C_SUBSET = 1 << 14   # the C baseline runs a subset (it is much slower)

# barcodes-mode lane at BASELINE config-#3 scale (C. elegans, ~50k barcodes)
BC_READS = 800_000
BC_CODES = 50_000


def make_lane(n_reads=N_READS):
    rng = np.random.default_rng(7)
    # genome-derived reads (repeats matter for table contention realism)
    genome = rng.integers(0, 4, size=2_000_000).astype(np.uint8)
    starts = rng.integers(0, len(genome) - READ_LEN, size=n_reads)
    return np.stack([genome[s:s + READ_LEN] for s in starts])


def bench_engine(reads):
    """Headline: the Engine's occurrence-mode count pass.

    Measured twice: COLD (fresh engine — includes the host->device ingest)
    and HOT (``Engine.reset()`` + re-count — the lane's chunks are already
    device-resident via the engine's chunk cache, so this is the device
    compute path: sketch + pre-reduction + LSM flushes)."""
    import jax
    from hash10x_jax.hashspec import HashSpec
    from hash10x_jax.engine import Engine, EngineConfig
    from hash10x_jax.io.fqb import Fqb
    from hash10x_jax.core.encode import pack_2bit

    packed = pack_2bit(reads)
    n = len(reads)
    fqb = Fqb(packed=packed, lengths=np.full(n, READ_LEN, np.int32),
              barcode_ids=np.zeros(n, np.int32),
              barcode_keys=np.zeros(1, np.uint32), read_len=READ_LEN)

    cfg = EngineConfig(spec=HashSpec(k=K, w=W, seed=SEED),
                       count_mode="occurrences", table_bits=20,
                       batch_reads=BATCH)

    def run(eng):
        eng.reset()
        t0 = time.monotonic()
        eng.count(fqb)
        jax.block_until_ready(eng.table.hashes)
        return time.monotonic() - t0

    eng = Engine(cfg, log=None)
    run(eng)  # warm compiles (also transfers + caches chunks)
    eng._chunk_cache.clear()
    cold = run(eng)  # fresh transfer, warm compiles (re-caches)
    best = min(run(eng) for _ in range(3))  # device-resident chunks
    n_kmers = int(np.asarray(eng.table.n_filled))
    return n / best, n / cold, n_kmers, best


def bench_sketch_share(reads, trace_dir=None):
    """The sketch's share of the count step at the engine's shapes.

    Times ``Engine._fused_count_scan`` (barcodes mode, S=flush_batches
    batches of 4,096 reads carved from one device-resident chunk: unpack,
    sketch + emission packing, (hash, barcode) pre-reduction, buffer
    write) and the same scan reduced to the sketch alone.  With
    ``trace_dir`` it also traces three steps and sums the device time of
    the ops under the ``sketch`` named scope, against all of the step's
    device ops (``trace_scope_share``)."""
    import jax
    import jax.numpy as jnp
    from hash10x_jax.hashspec import HashSpec, U64MAX
    from hash10x_jax.engine import Engine, EngineConfig
    from hash10x_jax.core.encode import pack_2bit

    eng = Engine(
        EngineConfig(spec=HashSpec(k=K, w=W, seed=SEED),
                     count_mode="barcodes", batch_reads=BATCH), log=None)
    eng._read_len = READ_LEN
    S = eng.cfg.flush_batches
    rows = (S + 1) * BATCH
    packed = np.zeros((rows, (READ_LEN + 15) // 16), np.uint32)
    packed[:S * BATCH] = pack_2bit(reads[:S * BATCH])
    lens = np.zeros(rows, np.int32)
    lens[:S * BATCH] = READ_LEN
    bcs = np.full(rows, -1, np.int32)
    bcs[:S * BATCH] = np.arange(S * BATCH) // 16   # 16 reads per barcode
    dp, dl, dc = (jax.device_put(x) for x in (packed, lens, bcs))
    offs = jnp.asarray(np.arange(S, dtype=np.int32) * BATCH)
    ms = jnp.asarray(np.full(S, BATCH, np.int32))
    step = eng._fused_count_scan(rows, 0, S)
    eng._ensure_table(step.slots)
    state = [eng.table.buf, eng.table.bufw]

    def run_step():
        buf, bufw, over = step(state[0], state[1], dp, dl, dc, offs, ms,
                               jnp.int32(0), jnp.uint32(0))
        state[:] = [buf, bufw]
        return over

    @jax.jit
    def sketch_only(dp, dl, offs):
        def body(acc, off):
            pk = jax.lax.dynamic_slice(dp, (off, jnp.int32(0)),
                                       (BATCH, dp.shape[1]))
            ln = jax.lax.dynamic_slice(dl, (off,), (BATCH,))
            flat, _, ov = eng._sketch_packed(pk, None, ln)
            n = jnp.sum(flat != jnp.uint64(U64MAX)).astype(jnp.uint32)
            return acc + n + ov, None
        return jax.lax.scan(body, jnp.uint32(0), offs)[0]

    def timed(fn, reps=10):
        jax.block_until_ready(fn())   # compile + warm
        best = float("inf")
        for _ in range(3):
            t0 = time.monotonic()
            for _ in range(reps):
                r = fn()
            jax.block_until_ready(r)
            best = min(best, (time.monotonic() - t0) / reps)
        return best

    t_step = timed(run_step)
    t_sketch = timed(lambda: sketch_only(dp, dl, offs))
    point = {"name": "sketch_share_count_step",
             "batches_per_step": S,
             "batch_reads": BATCH, "compact_to": eng._compact_rows(
                 READ_LEN - K + 1),
             "step_ms": round(t_step * 1e3, 4),
             "step_ms_per_batch": round(t_step * 1e3 / S, 4),
             "sketch_only_ms": round(t_sketch * 1e3, 4),
             "sketch_share_by_isolation": round(t_sketch / t_step, 4)}
    if trace_dir:
        hlo = step.lower(state[0], state[1], dp, dl, dc, offs, ms,
                         jnp.int32(0), jnp.uint32(0)).compile().as_text()
        jax.profiler.start_trace(trace_dir)
        for _ in range(3):
            jax.block_until_ready(run_step())
        jax.profiler.stop_trace()
        point.update(trace_scope_share(trace_dir, hlo, "sketch"))
    return point


def trace_scope_share(trace_dir, hlo_text, scope):
    """Device time of one jitted program in a profiler trace, split by
    named scope: events on the ``/device:GPU`` planes whose ``hlo_module``
    is the program's module are summed, and those whose ``hlo_op`` carries
    ``/<scope>/`` in its compiled HLO ``op_name`` count as the scope's."""
    import glob
    import re
    from jax.profiler import ProfileData
    module = re.search(r"HloModule (\S+?),", hlo_text).group(1)
    op_names = dict(re.findall(
        r"^\s*(?:ROOT )?%?([\w.\-]+) = .*?metadata=\{op_name=\"([^\"]*)\"",
        hlo_text, re.M))
    total = in_scope = 0
    busy = []
    for path in glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                          recursive=True):
        for plane in ProfileData.from_file(path).planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                for ev in line.events:
                    st = dict(ev.stats)
                    if st.get("hlo_module") != module:
                        continue
                    total += ev.duration_ns
                    busy.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                    if f"/{scope}/" in op_names.get(st.get("hlo_op"), ""):
                        in_scope += ev.duration_ns
    busy.sort()
    union, end = 0.0, float("-inf")
    for a, b in busy:
        if b > end:
            union += b - max(a, end)
            end = b
    return {"trace_module": module, "trace_device_ns": total,
            "trace_busy_ns": union, f"trace_{scope}_ns": in_scope,
            f"trace_{scope}_share": round(in_scope / total, 4) if total
            else None}


def bench_barcodes(n_reads=BC_READS, n_codes=BC_CODES):
    """Config #3 SCALE: 50k barcodes / 800k reads, barcodes-mode count +
    incidence + cluster + split + report stage walls on the real chip.

    The WARM pass is the headline (chunk cache holds the lane on device,
    compiles cached — the steady-state number a production deployment
    sees); the first pass exists to warm those caches and its walls are
    recorded as the cold note."""
    import io
    import jax
    from hash10x_jax.hashspec import HashSpec
    from hash10x_jax.engine import Engine, EngineConfig
    from hash10x_jax.io.fqb import Fqb
    from hash10x_jax.core.encode import pack_2bit

    rng = np.random.default_rng(11)
    # C. elegans-sized genome (config #3): 50k x 30kb molecules over 100Mb is
    # ~15x molecule coverage — a realistic pileup.  (A 20Mb genome gave 75x:
    # every molecule overlapped ~150 others and the co-occurrence graph
    # collapsed into a handful of giant components — not what the config
    # measures.)
    genome = rng.integers(0, 4, size=100_000_000).astype(np.uint8)
    # each barcode covers a contiguous molecule; reads sample within it
    mol_starts = rng.integers(0, len(genome) - 30_000, size=n_codes)
    bc_ids = np.repeat(np.arange(n_codes, dtype=np.int32),
                       n_reads // n_codes)
    offs = rng.integers(0, 30_000 - READ_LEN, size=n_reads)
    starts = mol_starts[bc_ids] + offs
    reads = genome[starts[:, None] + np.arange(READ_LEN)[None, :]]
    fqb = Fqb(packed=pack_2bit(reads),
              lengths=np.full(n_reads, READ_LEN, np.int32),
              barcode_ids=bc_ids,
              barcode_keys=np.arange(n_codes, dtype=np.uint32),
              read_len=READ_LEN)

    cfg = EngineConfig(spec=HashSpec(k=K, w=W, seed=SEED),
                       count_mode="barcodes", table_bits=22,
                       batch_reads=BATCH, min_count=2, max_count=64)
    eng = Engine(cfg, log=None)

    # the C stand-in runs the SAME lane's FULL pipeline (barcodes count +
    # band filter + friend clustering) concurrently in a subprocess — the
    # single-thread C baseline for the full-pipeline vs_baseline (cluster
    # bit-equality vs the stand-in is pinned by tests/test_c_ref.py and
    # chip_smoke.py).  min_friend_share matches the engine default.
    c_proc = None
    try:
        exe = _c_ref_exe()
        rb = os.path.join(_scratch(), "bc_reads.bin")
        bb = os.path.join(_scratch(), "bc_codes.bin")
        with open(rb, "wb") as f:
            np.array([n_reads, READ_LEN], np.uint32).tofile(f)
            reads.astype(np.uint8).tofile(f)
        bc_ids.astype(np.uint32).tofile(bb)
        c_proc = subprocess.Popen(
            [exe, rb, str(K), str(W), str(SEED), "22", "--barcodes", bb,
             "--minCount", "2", "--maxCount", "64", "--friendShare",
             str(cfg.min_friend_share), "--cluster"],
            stdout=subprocess.PIPE, text=True)
    except Exception as e:
        print(f"bench: full-pipeline C baseline unavailable ({e})",
              file=sys.stderr)

    def pipeline():
        walls = {}
        eng.reset()  # keeps compiled steps + device-resident chunks
        t0 = time.monotonic()
        eng.count(fqb)
        jax.block_until_ready(eng.table.hashes)
        walls["count_s"] = round(time.monotonic() - t0, 3)
        walls["count_dispatches"] = eng.stats["dispatches"]
        walls["count_flushes"] = eng.stats["flushes"]
        eng.stats = {"dispatches": 0, "flushes": 0}
        t0 = time.monotonic()
        eng.filter()
        eng.incidence(fqb)
        walls["incidence_s"] = round(time.monotonic() - t0, 3)
        walls["incidence_dispatches"] = eng.stats["dispatches"]
        walls["incidence_flushes"] = eng.stats["flushes"]
        t0 = time.monotonic()
        eng.cluster()
        walls["cluster_s"] = round(time.monotonic() - t0, 3)
        t0 = time.monotonic()
        eng.split()
        walls["split_s"] = round(time.monotonic() - t0, 3)
        t0 = time.monotonic()
        eng.report(io.StringIO())
        walls["report_s"] = round(time.monotonic() - t0, 3)
        walls["reads_per_s_end_to_end"] = round(
            n_reads / sum(v for k, v in walls.items() if k.endswith("_s")), 1)
        return walls

    cold = pipeline()   # warms compiles + device chunk cache
    warm = pipeline()   # THE HEADLINE: steady-state device path
    tot = {k: v for k, v in warm.items() if k.endswith("_s")}
    dom = max(tot, key=tot.get)
    point = {"n_reads": n_reads, "n_codes": n_codes,
             "n_pairs": int(eng.inc.n_pairs), "cold": cold, "warm": warm,
             "dominant_stage": dom,
             "note": ("cold includes compilation and ingest; warm is the "
                      "steady-state device path and the headline")}
    if c_proc is not None:
        try:
            toks = c_proc.communicate(timeout=max(10.0, _remaining() - 60)
                                      )[0].split()
            vals = dict(zip(toks[::2], toks[1::2]))
            c_wall = float(vals["seconds"]) + float(vals["cluster_seconds"])
            c_rps = n_reads / c_wall
            point["c_full_pipeline_reads_per_s"] = round(c_rps, 1)
            point["vs_c_full_pipeline"] = round(
                warm["reads_per_s_end_to_end"] / c_rps, 3)
            point["c_molecules"] = int(vals["molecules"])
        except Exception as e:
            c_proc.kill()
            print(f"bench: C full-pipeline baseline failed ({e})",
                  file=sys.stderr)
    return point


def bench_cluster_200k():
    """The sparse cluster phase alone at 200k codes (BASELINE config-#3/#4
    scale signal; incidence synthesized directly)."""
    import jax
    from hash10x_jax.table.incidence import build_incidence
    from hash10x_jax.cluster import sparse as SP

    rng = np.random.default_rng(5)
    n_codes, n_kmers, per_code = 200_000, 2_000_000, 30
    spans = rng.integers(0, n_kmers - 64, size=(n_codes, 2))
    ks, cs = [], []
    for j in range(2):
        offs = rng.integers(0, 64, size=(n_codes, per_code // 2))
        ks.append((spans[:, j:j + 1] + offs).reshape(-1))
        cs.append(np.repeat(np.arange(n_codes), per_code // 2))
    inc = build_incidence(np.concatenate(ks).astype(np.int32),
                          np.concatenate(cs).astype(np.int32),
                          n_kmers=n_kmers, n_codes=n_codes)
    t0 = time.monotonic()
    labels = SP.cluster_codes_sparse(inc, min_friend_share=4, flat=True)
    cold = time.monotonic() - t0
    t0 = time.monotonic()
    labels2 = SP.cluster_codes_sparse(inc, min_friend_share=4, flat=True)
    warm = time.monotonic() - t0
    assert (labels == labels2).all()
    return {"name": "cluster_200k_codes", "n_codes": n_codes,
            "n_pairs": int(inc.n_pairs),
            "wall_cold_s": round(cold, 2), "wall_warm_s": round(warm, 2),
            "note": "cold includes compilation"}


def bench_sharded(reads, force_routing=False):
    """The sharded count path at n_shards=1 on the card (exercises the
    all_to_all routing + shard-parallel flush code).

    force_routing=True runs the SAME lane with H10X_FORCE_ROUTING=1: the
    n>1 routing code (dest sort, lane build, identity all_to_all) executes
    on the single card — the A/B against the specialized n=1 path measures
    the per-batch routing-machinery cost with no multi-device contention in
    the frame."""
    import jax
    from hash10x_jax.hashspec import HashSpec
    from hash10x_jax.engine import Engine, EngineConfig
    from hash10x_jax.io.fqb import Fqb
    from hash10x_jax.core.encode import pack_2bit

    packed = pack_2bit(reads)
    n = len(reads)
    fqb = Fqb(packed=packed, lengths=np.full(n, READ_LEN, np.int32),
              barcode_ids=np.zeros(n, np.int32),
              barcode_keys=np.zeros(1, np.uint32), read_len=READ_LEN)

    cfg = EngineConfig(spec=HashSpec(k=K, w=W, seed=SEED),
                       count_mode="occurrences", table_bits=20,
                       batch_reads=BATCH, n_shards=1)
    # ONE engine across runs, exactly like bench_engine: the chunk cache
    # keeps the lane device-resident and the step cache keeps the compiled
    # scan programs, so hot runs measure the device compute path (routing +
    # owner-side pre-reduction + sliced flushes), not the ingest
    if force_routing:
        os.environ["H10X_FORCE_ROUTING"] = "1"
    try:
        eng = Engine(cfg, log=None)

        def run():
            eng.reset()
            t0 = time.monotonic()
            # n_shards=1 takes the plain path in Engine.count; drive the
            # sharded step directly so this point measures the routing
            # machinery itself
            eng._count_sharded(fqb)
            jax.block_until_ready(eng._dt.hashes)
            return time.monotonic() - t0

        run()  # warm compiles + chunk transfer
        run()  # warm compiles, chunks cached
        best = min(run() for _ in range(3))
    finally:
        os.environ.pop("H10X_FORCE_ROUTING", None)
    return n / best, best


_SCRATCH = []


def _scratch() -> str:
    """This run's scratch directory (under TMPDIR, removed at exit)."""
    if not _SCRATCH:
        _SCRATCH.append(tempfile.TemporaryDirectory(prefix="h10x_bench_"))
    return _SCRATCH[0].name


def _c_ref_exe() -> str:
    exe = os.path.join(_scratch(), "hash10x_ref")
    if not os.path.exists(exe):
        src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "native", "c_ref", "hash10x_ref.c")
        subprocess.run(["gcc", "-O3", "-march=native", "-o", exe, src],
                       check=True, capture_output=True)
    return exe


def bench_c(reads):
    """Compile and run the C reference on a subset; returns reads/s (or 0)."""
    try:
        exe = _c_ref_exe()
        sub = reads[:C_SUBSET]
        binpath = os.path.join(_scratch(), "count_reads.bin")
        with open(binpath, "wb") as f:
            np.array([len(sub), READ_LEN], np.uint32).tofile(f)
            sub.astype(np.uint8).tofile(f)
        out = subprocess.run(
            [exe, binpath, str(K), str(W), str(SEED), "22"],
            check=True, capture_output=True, text=True, timeout=600).stdout
        toks = out.split()
        n, secs = int(toks[1]), float(toks[7])
        return n / secs
    except Exception as e:
        print(f"bench: C baseline unavailable ({e})", file=sys.stderr)
        return 0.0


def require_gpu():
    """(devices, card line): exits non-zero unless JAX's first device is a
    GPU — a measurement path never falls back to the CPU.  The card line is
    nvidia-smi's ``name, power.limit``, read by a child that stays off JAX."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench: no GPU found (JAX's first device is "
                         f"{devs[0].platform!r}); nothing measured")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return devs, card.strip().splitlines()[0]


# key numbers per point for the compact summary line (kept tiny: an
# over-long last line gets its head cut in a recorded output tail)
def _point_brief(p):
    b = {"name": p.get("name")}
    for k in ("reads_per_s", "wall_s", "step_ms_per_batch",
              "sketch_share_by_isolation", "trace_sketch_share",
              "wall_warm_s", "routing_ms_per_batch", "vs_c_full_pipeline"):
        if k in p:
            b[k] = p[k]
    if "warm" in p:
        b["warm_reads_per_s"] = p["warm"].get("reads_per_s_end_to_end")
    return b


def main():
    devs, card = require_gpu()
    points, skipped = [], []
    summary = {"metric": "count_pass_reads_per_s", "value": 0,
               "unit": "reads/s", "vs_baseline": 0,
               "device": {"platform": devs[0].platform,
                          "kind": devs[0].device_kind, "count": len(devs)},
               "card": card}

    def emit(final=False):
        """(Re)print the compact summary — the LAST printed line always
        parses, wherever a deadline lands."""
        line = dict(summary)
        line["points_brief"] = [_point_brief(p) for p in points]
        if skipped:
            line["skipped"] = skipped
        line["budget_s"] = BENCH_BUDGET_S
        line["elapsed_s"] = round(time.monotonic() - _T0, 1)
        if final:
            line["final"] = True
        print(json.dumps(line), flush=True)
        # full payload to a side file (never printed whole)
        try:
            with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "BENCH_DETAIL.json"), "w") as f:
                json.dump(dict(line, points=points), f, indent=1)
        except OSError:
            pass

    reads = make_lane()
    c_rps = bench_c(reads)
    eng_rps, cold_rps, n_kmers, eng_dt = bench_engine(reads)
    vs = eng_rps / c_rps if c_rps else 0.0
    summary.update(value=round(eng_rps, 1), vs_baseline=round(vs, 3))
    points.append(
        {"name": "engine_count_hot", "reads_per_s": round(eng_rps, 1),
         "wall_s": round(eng_dt, 3), "n_kmers": n_kmers, "n_reads": N_READS,
         "note": "device-resident lane (chunk cache); the compute path"})
    points.append(
        {"name": "engine_count_cold", "reads_per_s": round(cold_rps, 1),
         "note": "includes the host->device ingest"})
    print(f"bench: engine {eng_rps:,.0f} reads/s ({N_READS} reads, {n_kmers} "
          f"kmers, {eng_dt:.2f}s); C ref {c_rps:,.0f} reads/s [{card}]",
          file=sys.stderr)
    emit()  # headline survives from this moment on

    def barcodes_point():
        # scale the lane to the remaining budget: a quarter lane answers
        # the same attribution question when time is short
        if _remaining() > 700:
            p = bench_barcodes()
            p["name"] = "engine_barcodes_800k_reads_50k_codes"
        else:
            p = bench_barcodes(BC_READS // 4, BC_CODES // 4)
            p["name"] = "engine_barcodes_200k_reads_12k_codes_reduced"
            p["reduced"] = "quarter lane: bench budget was short"
        return p

    def routing_ab_point():
        sh_rps, sh_dt = bench_sharded(reads)
        shf_rps, shf_dt = bench_sharded(reads, force_routing=True)
        n_batches = N_READS // BATCH
        per_batch_ms = (shf_dt - sh_dt) * 1e3 / n_batches
        return {"name": "routing_ab_1chip",
                "reads_per_s": round(sh_rps, 1), "wall_s": round(sh_dt, 3),
                "forced_routing_reads_per_s": round(shf_rps, 1),
                "forced_routing_wall_s": round(shf_dt, 3),
                "routing_ms_per_batch": round(per_batch_ms, 3),
                "note": ("A/B on ONE card: n=1 specialized path vs the same "
                         "lane forced through the n>1 routing code "
                         "(H10X_FORCE_ROUTING=1: dest sort + lane build + "
                         "identity all_to_all) — the routing-machinery cost "
                         "with no multi-device contention in the frame")}

    # ordered by value; (est warm-cache cost, fn) — skipped points are NAMED
    plan = [
        ("engine_barcodes", 420, barcodes_point),
        ("sketch_share", 60, lambda: bench_sketch_share(reads)),
        ("routing_ab_1chip", 120, routing_ab_point),
        ("cluster_200k_codes", 110, bench_cluster_200k),
    ]
    for name, est, fn in plan:
        if _remaining() < est:
            skipped.append({"name": name, "reason":
                            f"budget: {_remaining():.0f}s left < ~{est}s"})
            print(f"bench: {name} skipped ({_remaining():.0f}s left)",
                  file=sys.stderr)
            emit()
            continue
        try:
            points.append(fn())
        except Exception as e:
            import traceback
            traceback.print_exc()
            skipped.append({"name": name,
                            "reason": f"{type(e).__name__}: {e}"[:200]})
        emit()
    emit(final=True)


def sketch_share_main():
    """``--sketch-share``: the sketch-share point alone, traced into
    traces/sketch_share, as one JSON line naming the card."""
    devs, card = require_gpu()
    trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "traces", "sketch_share")
    point = bench_sketch_share(make_lane(), trace_dir=trace_dir)
    point.update(device={"platform": devs[0].platform,
                         "kind": devs[0].device_kind, "count": len(devs)},
                 card=card)
    print(json.dumps(point), flush=True)


if __name__ == "__main__":
    if "--sketch-share" in sys.argv:
        sketch_share_main()
        sys.exit(0)
    try:
        main()
    except Exception as e:  # always leave ONE honest JSON line
        import traceback
        traceback.print_exc()
        print(json.dumps({"metric": "count_pass_reads_per_s", "value": 0,
                          "unit": "reads/s", "vs_baseline": 0,
                          "note": f"bench failed: {type(e).__name__}: "
                                  f"{e}"[:300]}))
        sys.exit(1)
