"""Multi-host bootstrap and fail-fast (SURVEY.md §3.2 collective backend row,
§6 failure-detection row).

The reference is single-process; the rebuild scales over hosts via
``jax.distributed.initialize`` (the network between hosts, NVLink within
one).  This
module wraps bootstrap with environment detection, gives every process the
global mesh, and documents the recovery contract: failure = fail-fast (the
jax.distributed heartbeat kills the job) and recovery = reload the sharded table
snapshot (``sharded_sorted.save_snapshot``/``load_snapshot``) — no elasticity
(BASELINE requires none).

Tested without a cluster by spawning two local processes over loopback TCP
(tests/test_multihost.py — SURVEY.md §5 item 4's DCN-path test).
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["initialize", "global_mesh", "is_coordinator", "process_summary"]


def initialize(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Bootstrap jax.distributed from args or H10X_* env vars; no-op when
    single-process (num_processes absent or 1).

    Processes that meet at a loopback coordinator share one machine, so each
    takes one card of it (card = process id) rather than every process
    opening every card; ``JAX_LOCAL_DEVICE_IDS`` overrides the choice."""
    coordinator = coordinator or os.environ.get("H10X_COORDINATOR")
    num_processes = num_processes or int(os.environ.get("H10X_NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else \
        int(os.environ.get("H10X_PROCESS_ID", "0"))
    if num_processes <= 1:
        return
    if not coordinator:
        raise ValueError("multi-process run needs a coordinator address "
                         "(H10X_COORDINATOR=host:port)")
    local_ids = None
    host = coordinator.rsplit(":", 1)[0]
    if (host in ("localhost", "127.0.0.1", "[::1]")
            and not os.environ.get("JAX_LOCAL_DEVICE_IDS")):
        local_ids = [process_id]
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_ids)


def global_mesh(n_devices: int = 0) -> Mesh:
    """1D mesh over all global devices (every process sees the same order)."""
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), ("d",))


def is_coordinator() -> bool:
    return jax.process_index() == 0


def process_summary() -> str:
    return (f"process {jax.process_index()}/{jax.process_count()} "
            f"local devices {jax.local_device_count()} "
            f"global devices {jax.device_count()}")
