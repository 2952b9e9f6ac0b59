"""Multi-host scaling helpers.

The reference is strictly single-process (SURVEY.md §2.4: no distributed
backend).  This framework scales across hosts with `jax.distributed`:
every process runs the same receiver program on its channel shard of a
global ``(hosts*devices,)`` mesh; the IF block is broadcast (each host
reads the same file/stream), and observable fan-in happens on process 0
(the sync-thread role).
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize jax.distributed (no-op for single-process runs).

    With no arguments, relies on a cluster environment that JAX can
    detect; pass coordinator/num_processes/process_id explicitly where
    there is none (CPU processes, GPU hosts without a cluster manager).
    """
    if num_processes is None and coordinator is None:
        try:
            jax.distributed.initialize()
        except Exception:
            return                       # single-process fallback
    else:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)


def global_mesh(axis: str = "ch") -> Mesh:
    """1-D mesh over every device of every process."""
    return Mesh(np.array(jax.devices()), (axis,))


def is_output_host() -> bool:
    """True on the process that runs observable fan-in + RINEX/RTCM
    output (the reference sync thread's role, src/sdrsync.c)."""
    return jax.process_index() == 0
