"""2-process jax.distributed test.

Spawns two CPU processes (4 virtual devices each → 8 global), builds the
SAME distributed plan in both, executes, and checks process 0's addressable
shards against the golden oracle.  Exercises `init_distributed`,
`global_mesh_1d`, the multi-process `_put_sharded` placement, and the
shard_map execution across process boundaries.
"""

import os
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys
import numpy as np

pid = int(sys.argv[1])
port = sys.argv[2]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

from spmv_tpu.parallel.multihost import (init_distributed, global_mesh_1d,
                                         is_multiprocess)
init_distributed(coordinator_address=f"localhost:{port}",
                 num_processes=2, process_id=pid)
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
assert jax.process_count() == 2, jax.process_count()
assert is_multiprocess()
assert len(jax.devices()) == 8

from spmv_tpu.io import generate
from spmv_tpu.oracle import spmv_golden
from spmv_tpu.parallel import build_dist_plan, dist_spmv

mesh = global_mesh_1d()
a = generate.banded(4096, 4096, 8, dtype=np.float64, seed=3)
x = generate.make_x(a.n, np.float64, kind="normal", seed=4)

for x_mode in ("replicated", "halo"):
    plan = build_dist_plan(a, mesh, x_mode=x_mode)
    y = dist_spmv(plan, x)
    g = spmv_golden(a, x)
    # check every shard this process can address
    ok = True
    for shard in y.addressable_shards:
        sl = shard.index[0]
        ok &= bool(np.allclose(np.asarray(shard.data), g[sl], rtol=1e-9))
    print(f"proc{pid} {x_mode} ok={ok}", flush=True)
    assert ok

print(f"proc{pid} DONE", flush=True)
"""


def test_two_process_dist_spmv(tmp_path):
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(__file__))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, str(script), str(i),
                               str(port)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env)
             for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=280)
        outs.append(out.decode())
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc{i} failed:\n{out[-3000:]}"
        assert f"proc{i} DONE" in out
