"""hash10x-compatible sequential command-language CLI.

The reference's API surface is a CLI where each flag is a command executed
immediately, in order, against shared state (``hash10x.c:~main`` + usage block,
SURVEY.md §3.1 #1, §6 config row: "preserve this exact UX").  Flag names are
reconstructed ([M/L] — re-check against the usage block when the reference mount is
readable); parameters must precede the commands that use them, exactly as in the
reference.

Usage: python -m hash10x_jax.cli [commands...]

Parameters (take effect for later commands):
  -k <int>             k-mer size (default 21)
  -w <int>             minimizer window / modimizer modulus (default 11)
  -r <int>             hash seed (default 17)
  -B | --tableBits <b> count table has 2^b slots (default 22)
  --hosts <n>          multi-process run over n hosts (DP input sharding +
                       hash-sharded table over the global mesh); pair with
                       --hostId and --coordinator (or H10X_* env vars);
                       stdout/report files are written by host 0 only
  --hostId <i>         this process's id in [0, hosts)
  --coordinator <a:p>  jax.distributed coordinator address
  --minimizer | --modimizer | --allKmers | --syncmer <s>   sketch mode
  --minCount <n> --maxCount <n>              count band for good k-mers
  --minShare <n>       pair-mode support threshold
  --friendShare <n>    friend-mode barcode share threshold
  --clusterMode <pair|friend>
  --countMode <barcodes|occurrences>
  --batchReads <n>
  --shards <n>         shard the count pass over n mesh devices
  --laneCapacity <n>   sharded paths: send-lane slots per destination shard
                       (0 = auto-size to expected load; raise after a
                       "lane overflow" error on a skewed lane)
  --labelBlocks <n>    distributed clustering: propagate labels in
                       barcode-aligned blocks of ~n pairs (full-lane scale)
  -t <n>               thread count (accepted for compatibility; device batching
                       replaces host threads)

Commands (executed in order):
  --readFastq <fq>     parse FASTQ (16bp GEM barcode prefix) and run the count pass
  --readFastqPair <r1> <r2>   paired lane: R1 = barcode+genomic, R2 = genomic
  --readFQB <fqb>      load packed reads and run the count pass
  --readFQBShard <fqb> multi-host: each process loads only its own
                       barcode-disjoint shard file ("{host}" -> process id)
  --writeFQB <out>     write the last-read lane as packed fqb
  --hashInfo           table summary to stdout
  --hashDist           count histogram to stdout
  --writeHash <out>    save table checkpoint
  --readHash <in>      load table checkpoint
  --errorFix <max>     drop error-band k-mers with count <= max; with
                       --errorFixReads and loaded reads (barcodes mode),
                       error-band k-mers occurring in >= that many reads are
                       rescued (barcode-context reading of SURVEY §3.1 #12)
  --errorFixReads <m>  rescue threshold for --errorFix (0 = drop-only)
  --writeCounts <f>    dump (hash, count) table as text (diffable vs oracle)
  --writeClusters <f>  dump (code, kmer hash, cluster) assignments as text
  --metrics <file>     append per-command JSONL metrics
  --devMem             add device HBM bytes-in-use to the per-command lines
  --profile <dir>      jax.profiler trace of all later commands (TensorBoard)
  --cluster | --codeClusters   count-band filter + incidence + per-barcode clusters
  --clusterSplit       remap (code, cluster) -> new molecule codes
  --clusterReport      per-code cluster report to stdout
  --cribBuild <fa> [<fa2>]     build truth labels from haplotype FASTA(s)
  --cribReport         cluster purity vs crib to stdout
  --simulate <spec>    generate a simulated lane (key=val,...; for tests/benches)
  --help

Every command is followed by a timing/RSS line on stderr (timeUpdate analog).
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

# NOTE: engine/io imports happen inside main(), AFTER the multi-host
# bootstrap — several modules create jnp constants at import, which would
# initialize the XLA backend and break jax.distributed.initialize.

__all__ = ["main"]


def _bootstrap_multihost(argv: List[str]):
    """Pre-scan for --hosts/--hostId/--coordinator (consumed here, before any
    backend-touching import) and bootstrap jax.distributed if requested;
    returns (remaining argv, is_coordinator)."""
    hosts = int(os.environ.get("H10X_NUM_PROCESSES", "1"))
    host_id = int(os.environ.get("H10X_PROCESS_ID", "0"))
    coord = os.environ.get("H10X_COORDINATOR")
    rest = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("--hosts", "--hostId", "--coordinator"):
            if i + 1 >= len(argv):
                raise SystemExit(f"{a} requires an argument")
            v = argv[i + 1]
            if a == "--hosts":
                hosts = int(v)
            elif a == "--hostId":
                host_id = int(v)
            else:
                coord = v
            i += 2
            continue
        rest.append(a)
        i += 1
    if hosts > 1:
        from ..dist import multihost
        multihost.initialize(coord, hosts, host_id)
        return rest, host_id == 0
    return rest, True


class _State:
    def __init__(self, err=None):
        self.err = err
        self.k = 21
        self.w = 11
        self.seed = 17
        self.table_bits = 22
        self.mode = "minimizer"
        self.min_count = 2
        self.max_count = 64
        self.min_share = 2
        self.min_friend_share = 8
        self.max_friends = 0
        self.cluster_mode = "friend"
        self.count_mode = "barcodes"
        self.batch_reads = 4096
        self.syncmer_s = 0
        self.n_shards = 1
        self.lane_capacity = 0
        self.label_blocks = 0
        self.error_fix_min_reads = 0
        self.metrics_path = None
        self.device_mem = False
        self.engine: Optional[Engine] = None
        self.fqb = None
        self.fqb_is_local = False
        self.crib = None

    def get_engine(self) -> Engine:
        if self.engine is None:
            cfg = EngineConfig(
                spec=HashSpec(k=self.k, w=self.w, seed=self.seed),
                mode=self.mode, table_bits=self.table_bits,
                batch_reads=self.batch_reads, count_mode=self.count_mode,
                min_count=self.min_count, max_count=self.max_count,
                cluster_mode=self.cluster_mode, min_share=self.min_share,
                min_friend_share=self.min_friend_share, syncmer_s=self.syncmer_s,
                max_friends=self.max_friends, n_shards=self.n_shards,
                lane_capacity=self.lane_capacity,
                cluster_label_blocks=self.label_blocks,
                error_fix_min_reads=self.error_fix_min_reads)
            self.engine = Engine(cfg, log=self.err)
            if self.metrics_path or self.device_mem:
                from ..utils.timing import StageTimer
                self.engine.timer = StageTimer(self.err, self.metrics_path,
                                               device_mem=self.device_mem)
        else:
            # the sequential command language allows tunables to change between
            # commands ("parameters take effect for later commands"); sync them
            # into the live engine so a flag after the first read command is
            # never silently ignored (hash/table/count params stay guarded)
            cfg = self.engine.cfg
            cfg.min_count = self.min_count
            cfg.max_count = self.max_count
            cfg.min_share = self.min_share
            cfg.min_friend_share = self.min_friend_share
            cfg.max_friends = self.max_friends
            cfg.cluster_mode = self.cluster_mode
            cfg.batch_reads = self.batch_reads
            cfg.error_fix_min_reads = self.error_fix_min_reads
        return self.engine

    def param_change_guard(self):
        if self.engine is not None and int(self.engine.n_reads_counted) > 0:
            raise SystemExit("hash parameters must be set before reading data "
                             "(tables are only comparable with identical k/w/seed)")


def _parse_sim(spec: str) -> SimConfig:
    kwargs = {}
    if spec:
        for kv in spec.split(","):
            key, val = kv.split("=")
            kwargs[key] = float(val) if "." in val else int(val)
    return SimConfig(**kwargs)


def main(argv: List[str] = None, out=None, err=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or "--help" in argv or "-h" in argv:
        (out or sys.stdout).write(__doc__)
        return 0
    argv, is_coord = _bootstrap_multihost(argv)
    import jax
    multi = jax.process_count() > 1
    if multi and not is_coord:
        # non-coordinator processes participate in every collective but write
        # no user-facing output (reports and files come from host 0)
        out = open(os.devnull, "w")
    out = out or sys.stdout
    err = err or sys.stderr

    global Engine, EngineConfig, FB, HashSpec, SimConfig, simulate
    from ..hashspec import HashSpec
    from ..engine import Engine, EngineConfig
    from ..io import fqb as FB
    from ..io.sim import SimConfig, simulate

    st = _State(err)
    if multi and st.n_shards == 1:
        st.n_shards = jax.device_count()
    st.is_coord = is_coord
    profile_dir = None
    i = 0

    def need(n: int, flag: str) -> List[str]:
        nonlocal i
        if i + n > len(argv) - 1:
            raise SystemExit(f"{flag} requires {n} argument(s)")
        args = argv[i + 1:i + 1 + n]
        i += n
        return args

    while i < len(argv):
        a = argv[i]
        # ---- parameters ----
        if a == "-k":
            st.param_change_guard(); st.k = int(need(1, a)[0]); st.engine = None
        elif a == "-w":
            st.param_change_guard(); st.w = int(need(1, a)[0]); st.engine = None
        elif a == "-r":
            st.param_change_guard(); st.seed = int(need(1, a)[0]); st.engine = None
        elif a in ("-B", "--tableBits"):
            st.param_change_guard(); st.table_bits = int(need(1, a)[0]); st.engine = None
        elif a == "--minimizer":
            st.param_change_guard(); st.mode = "minimizer"; st.engine = None
        elif a == "--modimizer":
            st.param_change_guard(); st.mode = "modimizer"; st.engine = None
        elif a == "--allKmers":
            st.param_change_guard(); st.mode = "kmer"; st.engine = None
        elif a == "--syncmer":
            st.param_change_guard(); st.mode = "syncmer"; st.engine = None
            st.syncmer_s = int(need(1, a)[0])
        elif a == "--minCount":
            st.min_count = int(need(1, a)[0])
        elif a == "--maxCount":
            st.max_count = int(need(1, a)[0])
        elif a == "--minShare":
            st.min_share = int(need(1, a)[0])
        elif a == "--friendShare":
            st.min_friend_share = int(need(1, a)[0])
        elif a == "--maxFriends":
            st.max_friends = int(need(1, a)[0])
        elif a == "--clusterMode":
            st.cluster_mode = need(1, a)[0]
        elif a == "--countMode":
            st.param_change_guard(); st.count_mode = need(1, a)[0]
            st.engine = None
        elif a == "--batchReads":
            st.batch_reads = int(need(1, a)[0])
        elif a == "--shards":
            st.param_change_guard(); st.n_shards = int(need(1, a)[0])
            st.engine = None
        elif a == "--laneCapacity":
            st.lane_capacity = int(need(1, a)[0])
            if st.engine is not None:
                st.engine.cfg.lane_capacity = st.lane_capacity
        elif a == "--labelBlocks":
            st.label_blocks = int(need(1, a)[0])
        elif a == "--errorFixReads":
            st.error_fix_min_reads = int(need(1, a)[0])
        elif a == "--metrics":
            st.metrics_path = need(1, a)[0]
        elif a == "--devMem":
            st.device_mem = True
        elif a == "--profile":
            # jax.profiler trace of everything after this flag (TensorBoard/
            # Perfetto-readable) — SURVEY.md §6 tracing row
            if profile_dir is None:
                profile_dir = need(1, a)[0]
                jax.profiler.start_trace(profile_dir)
            else:
                need(1, a)
        elif a == "-t":
            need(1, a)  # accepted for compatibility; XLA owns parallelism
        # ---- commands ----
        elif a == "--readFastq":
            st.fqb = FB.fastq_to_fqb(need(1, a)[0])
            st.get_engine().count(st.fqb)
        elif a == "--readFastqPair":
            r1, r2 = need(2, a)
            st.fqb = FB.paired_fastq_to_fqb(r1, r2)
            st.get_engine().count(st.fqb)
        elif a == "--readFQB":
            st.fqb = FB.load_fqb(need(1, a)[0])
            st.fqb_is_local = False
            st.get_engine().count(st.fqb)
        elif a == "--readFQBShard":
            # per-process input shards (SURVEY.md §3.2 DP row): each process
            # loads ONLY its own barcode-disjoint fqb file; "{host}" in the
            # path expands to the process id
            path = need(1, a)[0].replace("{host}", str(jax.process_index()))
            st.fqb = FB.load_fqb(path)
            st.fqb_is_local = True
            st.get_engine().count(st.fqb, local_shard=True)
        elif a == "--writeFQB":
            if st.fqb is None:
                raise SystemExit("--writeFQB: no reads loaded")
            path = need(1, a)[0]
            if st.is_coord:
                FB.save_fqb(path, st.fqb)
        elif a == "--simulate":
            sim = simulate(_parse_sim(need(1, a)[0]))
            st.fqb = FB.from_read_batch(sim.reads)
            st.get_engine().count(st.fqb)
        elif a == "--hashInfo":
            st.get_engine().info(out)
        elif a == "--hashDist":
            st.get_engine().write_histogram(out)
        elif a == "--writeHash":
            path = need(1, a)[0]
            eng = st.get_engine()
            eng.host_materialize()  # collectives: ALL processes must enter
            if st.is_coord:
                eng.save(path)
        elif a == "--readHash":
            st.get_engine().load(need(1, a)[0])
        elif a == "--errorFix":
            st.get_engine().error_fix(int(need(1, a)[0]), fqb=st.fqb)
        elif a == "--writeCounts":
            path = need(1, a)[0]
            eng = st.get_engine()
            eng.host_materialize()  # collectives: ALL processes must enter
            if st.is_coord:
                with open(path, "w") as f:
                    eng.write_counts(f)
        elif a == "--writeClusters":
            path = need(1, a)[0]
            eng = st.get_engine()
            eng.host_materialize()
            if st.is_coord:
                with open(path, "w") as f:
                    eng.write_clusters(f)
        elif a in ("--cluster", "--codeClusters"):
            eng = st.get_engine()
            if st.fqb is not None:
                eng.filter(st.min_count, st.max_count)
                eng.incidence(st.fqb, local_shard=st.fqb_is_local)
            elif eng.inc is None:
                raise SystemExit("--codeClusters: no reads loaded for incidence "
                                 "(and no incidence in a loaded checkpoint)")
            eng.cluster()
        elif a == "--clusterSplit":
            st.get_engine().split()
        elif a == "--clusterReport":
            st.get_engine().report(out)
        elif a == "--cribBuild":
            from ..crib.crib import build_crib
            paths = [need(1, a)[0]]
            # the optional second haplotype is taken iff the next token IS an
            # existing file — "does it start with '-'" misparsed paths that
            # begin with a dash and numeric params that follow
            if i + 1 < len(argv) and os.path.isfile(argv[i + 1]):
                paths.append(need(1, a)[0])
            eng = st.get_engine()
            if eng.retained_hashes is None:
                eng.filter(st.min_count, st.max_count)
            st.crib = build_crib(eng.cfg.spec, eng.retained_hashes, paths)
            eng.timer.stage(f"cribBuild: {len(paths)} haplotype(s)")
        elif a == "--cribReport":
            from ..crib.crib import crib_report
            eng = st.get_engine()
            if st.crib is None or eng.cluster_labels is None:
                raise SystemExit("--cribReport requires --cribBuild and --codeClusters")
            crib_report(eng.inc, eng.cluster_labels, st.crib, out)
        else:
            raise SystemExit(f"unknown argument {a!r} (see --help)")
        i += 1
    if profile_dir is not None:
        jax.profiler.stop_trace()
        err.write(f"[profile] trace written to {profile_dir}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
