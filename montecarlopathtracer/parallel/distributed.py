"""Multi-host process bootstrap.

The reference is strictly single-process/single-device
(``cudaSetDevice(0)``, CUTracer.cu:222). Across hosts, one Python
process runs per host; `jax.distributed.initialize` wires them into one
runtime so `jax.devices()` spans every host and a single `Mesh` covers
every device (SURVEY.md §5 communication backend).

Usage (same script on every host, with JAX_COORDINATOR_ADDRESS /
JAX_NUM_PROCESSES / JAX_PROCESS_ID set, or the arguments passed):

    from montecarlopathtracer.parallel import distributed
    distributed.ensure_initialized()           # no-op single-process
    mesh = make_mesh()                         # all chips, all hosts
"""

from __future__ import annotations

import os
from typing import Optional

import jax

_initialized = False


def ensure_initialized(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize the multi-host runtime when running multi-process.

    Returns True if `jax.distributed.initialize` was called. Pass the
    coordinator/process arguments or set JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID; nothing is autodetected.
    Single-process runs (no env, no args) are a no-op.
    """
    global _initialized
    if _initialized:
        return True
    address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not address:
        return False
    jax.distributed.initialize(
        coordinator_address=address,
        num_processes=int(
            num_processes
            if num_processes is not None
            else os.environ.get("JAX_NUM_PROCESSES", "1")
        ),
        process_id=int(
            process_id
            if process_id is not None
            else os.environ.get("JAX_PROCESS_ID", "0")
        ),
    )
    _initialized = True
    return True


def process_info() -> dict:
    """Host-level topology summary for logs."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
