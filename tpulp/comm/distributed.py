"""Multi-host bring-up: ``jax.distributed`` initialization + hybrid meshes.

The reference has no distributed backend at all (pure single-process Python,
SURVEY.md §2.8); this module is the planned comm component's programming
surface (VERDICT round-1 missing item 2). It wraps the three things every
multi-host tpulp run needs:

1. ``init_distributed()`` — process bring-up. Wraps
   ``jax.distributed.initialize`` with environment autodetection (explicit
   args > JAX_COORDINATOR_ADDRESS-style env vars > whatever
   ``jax.distributed`` resolves itself, e.g. under SLURM). Idempotent.
2. ``global_device_mesh()`` — a Mesh over ALL processes' devices with the
   cross-host axis OUTERMOST: collectives along the inner axes then ride
   NVLink within a host, and only the outer-axis reductions cross the
   network between hosts.
   This is the layout the sharded drivers assume: the "cols" axis maps
   hosts x chips so each host owns a contiguous column block.
3. ``process_local_lanes()`` — which global column shards this process owns
   (for host-side data loading of column-partitioned tableaus).

Single-process fallback everywhere: on one process these return the same
meshes the single-host paths use, so code written against this module runs
unchanged from a laptop CPU to a pod slice.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = [
    "init_distributed",
    "is_distributed",
    "global_device_mesh",
    "process_local_lanes",
]

_initialized = False


def is_distributed() -> bool:
    """True once multi-process bring-up has run (or on a pre-initialized
    pod runtime)."""
    return _initialized or jax.process_count() > 1


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> int:
    """Bring up ``jax.distributed`` for a multi-process run; returns the
    process id (0 on single-process runs).

    Argument resolution order: explicit args > ``TPULP_COORDINATOR`` /
    ``TPULP_NUM_PROCESSES`` / ``TPULP_PROCESS_ID`` env vars > whatever
    ``jax.distributed.initialize`` can autodetect (SLURM, etc.). With no configuration at all this is a no-op single-process
    bring-up — safe to call unconditionally at program start. Idempotent:
    calling twice is a no-op.
    """
    global _initialized
    if _initialized:
        return jax.process_index()

    coordinator_address = coordinator_address or os.environ.get(
        "TPULP_COORDINATOR")
    if num_processes is None and "TPULP_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["TPULP_NUM_PROCESSES"])
    if process_id is None and "TPULP_PROCESS_ID" in os.environ:
        process_id = int(os.environ["TPULP_PROCESS_ID"])

    if coordinator_address is None and num_processes in (None, 1):
        # single-process run: nothing to bring up
        _initialized = True
        return 0

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    _initialized = True
    return jax.process_index()


def global_device_mesh(
    axis: str = "cols",
    dcn_axis: str = "hosts",
    devices=None,
) -> Mesh:
    """A mesh over every device of every process.

    Multi-process: a 2D ``(hosts, cols)`` mesh with the cross-host axis
    OUTERMOST — device order within each row is the process's own devices,
    so "cols" collectives (the per-pivot psum/all_gather of the sharded
    drivers) stay on NVLink within a host and only cross-host reductions
    touch the network. Callers that want a
    flat 1D column mesh over everything (2-host column partitioning,
    BASELINE config 5) can reshape with ``.flatten()`` semantics by passing
    the mesh's device array to ``Mesh(arr.reshape(-1), (axis,))``.

    Single-process: the familiar 1D ``(cols,)`` mesh.
    """
    devs = devices if devices is not None else jax.devices()
    n_proc = jax.process_count()
    if n_proc <= 1:
        return Mesh(np.array(devs), (axis,))
    per_proc = len(devs) // n_proc
    arr = np.empty((n_proc, per_proc), dtype=object)
    for d in devs:
        # jax orders devices by process; place each in its process row in
        # local order so the in-host axis is contiguous per host
        arr[d.process_index][d.id % per_proc] = d
    return Mesh(arr, (dcn_axis, axis))


def process_local_lanes(mesh: Mesh, axis: str = "cols"
                        ) -> Tuple[int, int]:
    """(start, stop) shard indices of ``axis`` owned by THIS process —
    the host-side loading window for column-partitioned tableau data."""
    size = mesh.shape[axis]
    axis_idx = list(mesh.axis_names).index(axis)
    me = jax.process_index()
    mine = []
    it = np.ndindex(*mesh.devices.shape)
    for idx in it:
        if mesh.devices[idx].process_index == me:
            mine.append(idx[axis_idx])
    if not mine:
        return (0, 0)
    return (min(mine), max(mine) + 1)
