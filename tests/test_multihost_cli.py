"""Multi-host CLI (--hosts): a 2-process CLI run over
loopback must produce byte-identical --hashDist and --writeCounts output to a
1-process run on the same lane."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def make_lane(path):
    import hash10x_jax  # noqa: F401
    from hash10x_jax.io.fqb import Fqb, save_fqb
    from hash10x_jax.core.encode import pack_2bit
    rng = np.random.default_rng(21)
    genome = rng.integers(0, 4, size=50_000).astype(np.uint8)
    N, n_codes = 512, 32
    bc = np.repeat(np.arange(n_codes, dtype=np.int32), N // n_codes)
    starts = rng.integers(0, len(genome) - 100, size=N)
    reads = np.stack([genome[s:s + 100] for s in starts])
    fqb = Fqb(packed=pack_2bit(reads), lengths=np.full(N, 100, np.int32),
              barcode_ids=bc, barcode_keys=np.arange(n_codes, dtype=np.uint32),
              read_len=100)
    save_fqb(path, fqb)


def run_cli(args, env_extra, cwd=REPO):
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
    })
    env.update(env_extra)
    return subprocess.Popen(
        [sys.executable, "-m", "hash10x_jax.cli"] + args, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=str(cwd))


@pytest.mark.slow
def test_two_process_cli_matches_single(tmp_path):
    lane = tmp_path / "lane.fqb.npz"
    make_lane(str(lane))
    counts1 = tmp_path / "counts1.txt"
    counts2 = tmp_path / "counts2.txt"
    params = ["-k", "13", "-w", "5", "-r", "17", "--batchReads", "128",
              "--minCount", "2", "--maxCount", "60", "--friendShare", "2"]
    # full pipeline: sharded count + sharded incidence + distributed cluster
    cmds = ["--readFQB", str(lane), "--hashDist", "--codeClusters",
            "--clusterReport"]

    # single process, sharded over 2 virtual CPU devices
    p = run_cli(params + ["--shards", "2"] + cmds
                + ["--writeCounts", str(counts1)],
                {"XLA_FLAGS": "--xla_force_host_platform_device_count=2"})
    out1, err1 = p.communicate(timeout=600)
    assert p.returncode == 0, err1[-2000:]

    # two processes x 1 device each over loopback DCN
    port = free_port()
    procs = []
    for pid in range(2):
        procs.append(run_cli(
            ["--hosts", "2", "--hostId", str(pid),
             "--coordinator", f"127.0.0.1:{port}"] + params + cmds
            + ["--writeCounts", str(counts2)],
            {"XLA_FLAGS": "--xla_force_host_platform_device_count=1"}))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-2000:]
        outs.append(out)

    def clean(s):
        # the gloo backend prints a "[Gloo] Rank ..." banner to stdout
        return [l for l in s.splitlines() if not l.startswith("[Gloo]")]

    assert clean(outs[0]) == clean(out1)  # coordinator stdout == single-process
    assert clean(outs[1]) == []           # non-coordinator writes nothing
    assert counts1.read_text() == counts2.read_text()


@pytest.mark.slow
def test_per_process_shard_files_match_full_lane(tmp_path):
    """--readFQBShard (SURVEY.md §3.2 DP row "per-host input shards"): two
    processes each loading HALF the lane (split by barcode) must reproduce the
    single-process full-lane run byte-for-byte — counts, histogram, and
    cluster report (global barcode ids are ranks in the global key set)."""
    import hash10x_jax  # noqa: F401
    from hash10x_jax.io.fqb import load_fqb, save_fqb, Fqb
    lane = tmp_path / "lane.fqb.npz"
    make_lane(str(lane))
    fqb = load_fqb(str(lane))
    # split by barcode key parity (NOT by rank ranges: ids must still match)
    for pid in range(2):
        sel = np.isin(fqb.barcode_ids,
                      np.nonzero(fqb.barcode_keys.astype(np.int64) % 2 == pid)[0])
        keys = np.unique(fqb.barcode_keys[fqb.barcode_ids[sel]])
        ids = np.searchsorted(keys, fqb.barcode_keys[fqb.barcode_ids[sel]])
        save_fqb(str(tmp_path / f"shard{pid}.fqb.npz"), Fqb(
            packed=fqb.packed[sel], lengths=fqb.lengths[sel],
            barcode_ids=ids.astype(np.int32), barcode_keys=keys,
            read_len=fqb.read_len,
            nmask=fqb.nmask[sel] if fqb.nmask is not None else None))

    params = ["-k", "13", "-w", "5", "-r", "17", "--batchReads", "128",
              "--minCount", "2", "--maxCount", "60", "--friendShare", "2"]
    tail = ["--hashDist", "--codeClusters", "--clusterReport"]
    counts1 = tmp_path / "c1.txt"
    counts2 = tmp_path / "c2.txt"

    p = run_cli(params + ["--shards", "2", "--readFQB", str(lane)] + tail
                + ["--writeCounts", str(counts1)],
                {"XLA_FLAGS": "--xla_force_host_platform_device_count=2"})
    out1, err1 = p.communicate(timeout=600)
    assert p.returncode == 0, err1[-2000:]

    port = free_port()
    procs = [run_cli(
        ["--hosts", "2", "--hostId", str(pid),
         "--coordinator", f"127.0.0.1:{port}"] + params
        + ["--readFQBShard", str(tmp_path / "shard{host}.fqb.npz")] + tail
        + ["--writeCounts", str(counts2)],
        {"XLA_FLAGS": "--xla_force_host_platform_device_count=1"})
        for pid in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-2000:]
        outs.append(out)

    def clean(s):
        return [l for l in s.splitlines() if not l.startswith("[Gloo]")]

    assert clean(outs[0]) == clean(out1)
    assert counts1.read_text() == counts2.read_text()


def make_lane_oversized(path, n_codes=8, big_reads=200):
    """A lane whose barcode 0 has more reads than a per-process batch block
    (batchReads 128 / 2 processes => 64-row blocks): the multi-process
    sharded count must stream it through the side dedup table."""
    import hash10x_jax  # noqa: F401
    from hash10x_jax.io.fqb import Fqb, save_fqb
    from hash10x_jax.core.encode import pack_2bit
    rng = np.random.default_rng(33)
    genome = rng.integers(0, 4, size=30_000).astype(np.uint8)
    n_small = 16 * (n_codes - 1)
    bc = np.concatenate([np.zeros(big_reads, np.int32),
                         1 + np.repeat(np.arange(n_codes - 1, dtype=np.int32),
                                       16)])
    N = len(bc)
    starts = rng.integers(0, len(genome) - 100, size=N)
    reads = np.stack([genome[s:s + 100] for s in starts])
    fqb = Fqb(packed=pack_2bit(reads), lengths=np.full(N, 100, np.int32),
              barcode_ids=bc, barcode_keys=np.arange(n_codes, dtype=np.uint32),
              read_len=100)
    save_fqb(path, fqb)
    return N


@pytest.mark.slow
def test_two_process_oversized_barcode_matches_single(tmp_path):
    """One barcode with 200 reads (> the 64-row per-process block): the
    2-process loopback CLI must complete and write counts byte-identical to
    the plain single-process engine (side-table group streaming)."""
    lane = tmp_path / "lane.fqb.npz"
    make_lane_oversized(str(lane))
    counts1 = tmp_path / "c1.txt"
    counts2 = tmp_path / "c2.txt"
    counts3 = tmp_path / "c3.txt"
    params = ["-k", "13", "-w", "5", "-r", "17", "--batchReads", "128",
              "--minCount", "1", "--maxCount", "60"]
    cmds = ["--readFQB", str(lane), "--hashDist"]

    # plain single-process engine (unsharded reference)
    p = run_cli(params + cmds + ["--writeCounts", str(counts1)],
                {"XLA_FLAGS": "--xla_force_host_platform_device_count=1"})
    out1, err1 = p.communicate(timeout=600)
    assert p.returncode == 0, err1[-2000:]

    # single process sharded over 2 devices (side-table path, 1 process)
    p = run_cli(params + ["--shards", "2"] + cmds
                + ["--writeCounts", str(counts3)],
                {"XLA_FLAGS": "--xla_force_host_platform_device_count=2"})
    out3, err3 = p.communicate(timeout=600)
    assert p.returncode == 0, err3[-2000:]

    # two processes over loopback DCN (the branch that used to raise)
    port = free_port()
    procs = [run_cli(
        ["--hosts", "2", "--hostId", str(pid),
         "--coordinator", f"127.0.0.1:{port}"] + params + cmds
        + ["--writeCounts", str(counts2)],
        {"XLA_FLAGS": "--xla_force_host_platform_device_count=1"})
        for pid in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-2000:]

    assert counts1.read_text() == counts3.read_text()
    assert counts1.read_text() == counts2.read_text()


@pytest.mark.slow
def test_shard_files_with_oversized_barcode(tmp_path):
    """--readFQBShard where ONE process's shard holds a 200-read barcode:
    its group batches become process-exclusive global steps (the other
    process contributes empty blocks) so side-table dedup sees only that
    barcode's reads; counts must match the plain single-process run."""
    import hash10x_jax  # noqa: F401
    from hash10x_jax.io.fqb import load_fqb, save_fqb, Fqb
    lane = tmp_path / "lane.fqb.npz"
    make_lane_oversized(str(lane))
    fqb = load_fqb(str(lane))
    # shard 0: barcodes {0 (oversized), 2, 4, ...}; shard 1: odd barcodes
    for pid in range(2):
        sel = np.isin(fqb.barcode_ids,
                      np.nonzero(fqb.barcode_keys.astype(np.int64) % 2 == pid)[0])
        keys = np.unique(fqb.barcode_keys[fqb.barcode_ids[sel]])
        ids = np.searchsorted(keys, fqb.barcode_keys[fqb.barcode_ids[sel]])
        save_fqb(str(tmp_path / f"shard{pid}.fqb.npz"), Fqb(
            packed=fqb.packed[sel], lengths=fqb.lengths[sel],
            barcode_ids=ids.astype(np.int32), barcode_keys=keys,
            read_len=fqb.read_len))

    params = ["-k", "13", "-w", "5", "-r", "17", "--batchReads", "128",
              "--minCount", "1", "--maxCount", "60"]
    counts1 = tmp_path / "c1.txt"
    counts2 = tmp_path / "c2.txt"

    p = run_cli(params + ["--readFQB", str(lane), "--hashDist",
                          "--writeCounts", str(counts1)],
                {"XLA_FLAGS": "--xla_force_host_platform_device_count=1"})
    out1, err1 = p.communicate(timeout=600)
    assert p.returncode == 0, err1[-2000:]

    port = free_port()
    procs = [run_cli(
        ["--hosts", "2", "--hostId", str(pid),
         "--coordinator", f"127.0.0.1:{port}"] + params
        + ["--readFQBShard", str(tmp_path / "shard{host}.fqb.npz"),
           "--hashDist", "--writeCounts", str(counts2)],
        {"XLA_FLAGS": "--xla_force_host_platform_device_count=1"})
        for pid in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-2000:]

    assert counts1.read_text() == counts2.read_text()
