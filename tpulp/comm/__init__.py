"""Distributed communication backend: multi-host bring-up + mesh layout.

The in-program collectives (pricing all_gather, entering-column psum, pmin)
live with the drivers in ``tpulp.shard``; this package owns the process
bring-up and host-aware mesh construction around them.
"""

from .distributed import (
    global_device_mesh,
    init_distributed,
    is_distributed,
    process_local_lanes,
)

__all__ = [
    "init_distributed",
    "is_distributed",
    "global_device_mesh",
    "process_local_lanes",
]
