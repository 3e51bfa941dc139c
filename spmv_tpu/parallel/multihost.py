"""Multi-host entry points — `jax.distributed` across processes.

The reference's closest analog is the NUMA sample's per-node partitioning
(src/samples/numa.c:268-439, one process, pinned threads); the framework
scales the same row-partitioned design across HOSTS: every process calls
:func:`init_distributed`, builds the identical plan from the same matrix
(deterministic builders + `make_array_from_callback` placement in
parallel/mesh.py `_put_sharded`), and executes one jitted shard_map program
whose collectives ride NVLink within a host and the network across hosts.

The tests run it with two CPU processes (tests/test_multihost.py); the same
code path serves GPU hosts — `jax.distributed.initialize` with an explicit
coordinator address, process count and process id.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["init_distributed", "global_mesh_1d", "is_multiprocess"]


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids=None) -> None:
    """Initialize `jax.distributed` (idempotent).

    With no arguments, reads the standard env (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID); nothing is autodetected on a
    machine that no cluster manager describes.  MUST run before any
    other jax call in the process.
    """
    import jax
    kwargs = {}
    if coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS"):
        kwargs["coordinator_address"] = (
            coordinator_address or os.environ["JAX_COORDINATOR_ADDRESS"])
        kwargs["num_processes"] = (
            num_processes
            if num_processes is not None
            else int(os.environ["JAX_NUM_PROCESSES"]))
        kwargs["process_id"] = (
            process_id
            if process_id is not None
            else int(os.environ["JAX_PROCESS_ID"]))
        if local_device_ids is not None:
            kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)


def is_multiprocess() -> bool:
    import jax
    return jax.process_count() > 1


def global_mesh_1d(axis: str = "rows"):
    """A 1-D mesh over ALL devices of ALL processes, ordered by process
    (so contiguous row blocks map to hosts — DCN traffic stays on the ring
    ends, the bulk rides intra-host ICI)."""
    import jax
    import numpy as np
    from jax.sharding import Mesh
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.array(devs), (axis,))
