"""Multi-host bring-up on the fake cluster: 2 PROCESSES x 4 CPU devices each
via ``jax.distributed`` (gloo), running the explicit-collective sharded
drivers over the global 8-device mesh. This is the multi-host programming
surface (tpulp.comm) exercised end-to-end without a pod — VERDICT round-1
missing item 2 (SURVEY §4's "fake cluster" test plan).
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, %(repo)r)
from tpulp.comm import init_distributed, global_device_mesh, process_local_lanes
init_distributed(f"localhost:{port}", nproc, pid)
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 4 * nproc, len(jax.devices())

import numpy as np, jax.numpy as jnp
from jax.sharding import Mesh
from tpulp.core import make_state, Status
from tpulp.shard import (to_sharded_state, run_simplex_sharded,
                         run_simplex_sharded_blocked)

# bounded instance: c >= 0 so the minimum exists
rng = np.random.default_rng(1)
m, n = 24, 48
A = rng.normal(size=(m, n)); x0 = np.abs(rng.normal(size=n))
b = A @ x0 + np.abs(rng.normal(size=m)); c = np.abs(rng.normal(size=n))
Afull = np.concatenate([A, np.eye(m)], axis=1)
cfull = np.concatenate([c, np.zeros(m)])
st = make_state(cfull, Afull, b, list(range(n, n + m)), dtype=jnp.float64)

mesh2d = global_device_mesh()
assert mesh2d.axis_names == ("hosts", "cols"), mesh2d.axis_names
lo, hi = process_local_lanes(mesh2d)
assert (hi - lo) == 4, (lo, hi)

mesh = Mesh(mesh2d.devices.reshape(-1), ("cols",))
out = run_simplex_sharded(to_sharded_state(st, mesh), mesh)
z = -float(jax.device_get(out.rhs)[0])      # replicated leaves: addressable
status = int(jax.device_get(out.status))
out2 = run_simplex_sharded_blocked(to_sharded_state(st, mesh), mesh, block=8)
z2 = -float(jax.device_get(out2.rhs)[0])
s2 = int(jax.device_get(out2.status))
assert status == Status.OPTIMAL, status
assert s2 == Status.OPTIMAL, s2
assert abs(z - z2) < 1e-8, (z, z2)

# the TRUE multi-host layout: tuple axis over the (hosts, cols) hybrid mesh
# (column split host-major; intra-host collectives stay on the host's
# interconnect, only the final reductions cross hosts — here gloo)
ax = ("hosts", "cols")
out3 = run_simplex_sharded(
    to_sharded_state(st, mesh2d, axis=ax), mesh2d, axis=ax)
z3 = -float(jax.device_get(out3.rhs)[0])
s3 = int(jax.device_get(out3.status))
assert s3 == Status.OPTIMAL, s3
assert abs(z - z3) < 1e-8, (z, z3)
if pid == 0:
    print(f"RESULT obj={z:.12f}", flush=True)
"""


def _single_process_objective():
    """Oracle: the same LP on the in-process (single-host) driver."""
    import numpy as np
    import jax.numpy as jnp

    from tpulp.core import Status, make_state
    from tpulp.solve import run_simplex

    rng = np.random.default_rng(1)
    m, n = 24, 48
    A = rng.normal(size=(m, n))
    x0 = np.abs(rng.normal(size=n))
    b = A @ x0 + np.abs(rng.normal(size=m))
    c = np.abs(rng.normal(size=n))
    Afull = np.concatenate([A, np.eye(m)], axis=1)
    cfull = np.concatenate([c, np.zeros(m)])
    st = make_state(cfull, Afull, b, list(range(n, n + m)),
                    dtype=jnp.float64)
    out = run_simplex(st)
    assert int(out.status) == Status.OPTIMAL
    return float(out.objective())


@pytest.mark.slow
def test_two_process_gloo_sharded_solve():
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER % {"repo": REPO},
             str(i), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=REPO)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=180)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i}:\n{out[-3000:]}"
    line = next(ln for ln in outs[0].splitlines() if ln.startswith("RESULT"))
    z = float(line.split("obj=")[1])
    assert abs(z - _single_process_objective()) < 1e-8
