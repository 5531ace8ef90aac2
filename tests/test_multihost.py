"""2-process jax.distributed DCN-path test over loopback TCP (SURVEY.md §5 item
4): the sharded count step must produce the same psum-merged histogram as a
single-device run, across process boundaries."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent

_WORKER = r"""
import os, sys, json
import jax
import numpy as np
sys.path.insert(0, os.environ["H10X_REPO"])
import hash10x_jax
from hash10x_jax.dist import multihost

# initialize BEFORE importing modules with jnp module-level constants (they
# would initialize the XLA backend and break jax.distributed)
multihost.initialize()

from hash10x_jax.dist import sharded_sorted as DS
from hash10x_jax.hashspec import HashSpec
mesh = multihost.global_mesh()
assert jax.device_count() == 4, jax.device_count()
spec = HashSpec(k=13, w=5, seed=17)

rng = np.random.default_rng(3)
n_reads = 64
codes = rng.integers(0, 4, size=(n_reads, 80)).astype(np.uint8)
lengths = np.full(n_reads, 80, np.int32)
bcs = (np.arange(n_reads) % 4).astype(np.int32)

# each process feeds its local slice of the global batch
from jax.sharding import NamedSharding, PartitionSpec as P
sh = NamedSharding(mesh, P("d"))
def to_global(x):
    return jax.make_array_from_process_local_data(sh, np.ascontiguousarray(
        x[jax.process_index() * (len(x) // 2):(jax.process_index() + 1) * (len(x) // 2)]))

t = DS.ShardedSortedTable(mesh, capacity=1 << 12, buf_capacity=1 << 14, spec=spec)
step = DS.make_sorted_count_step(spec, mesh)
t = step(t, to_global(codes), to_global(lengths), to_global(bcs))
t = step.finish(t)
hist = DS.sorted_histogram(t, 16)
print("HIST", json.dumps(np.asarray(hist).tolist()), flush=True)
"""


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


@pytest.mark.slow
def test_two_process_dcn_path(tmp_path):
    port = free_port()
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update({
            "H10X_REPO": str(REPO),
            "H10X_COORDINATOR": f"127.0.0.1:{port}",
            "H10X_NUM_PROCESSES": "2",
            "H10X_PROCESS_ID": str(pid),
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
        })
        procs.append(subprocess.Popen([sys.executable, str(worker)], env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True,
                                      cwd=str(REPO)))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"worker failed:\n{err[-2000:]}"
        outs.append(out)

    import json as _json
    hists = []
    for out in outs:
        line = [l for l in out.splitlines() if l.startswith("HIST ")][0]
        hists.append(_json.loads(line[5:]))
    assert hists[0] == hists[1]

    # single-device truth
    import jax
    from hash10x_jax.hashspec import HashSpec
    from hash10x_jax.core import seqhash_jnp as J
    from hash10x_jax.table import sorted_table as ST
    from hash10x_jax.hashspec import U64MAX
    spec = HashSpec(k=13, w=5, seed=17)
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=(64, 80)).astype(np.uint8)
    lengths = np.full(64, 80, np.int32)
    h, _, e = J.sketch(spec, codes, lengths, mode="minimizer")
    flat = np.where(np.asarray(e), np.asarray(h), U64MAX).reshape(-1)
    t = ST.flush(ST.append(ST.make_sorted_table(1 << 14, 1 << 15), flat))
    hist = np.asarray(ST.count_histogram(t.hashes, t.counts, 16)).tolist()
    assert hists[0] == hist
