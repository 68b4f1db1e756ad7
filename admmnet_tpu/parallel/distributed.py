"""Multi-host runtime bootstrap.

The reference has no distributed story at all (SURVEY.md 2.2); this is the
multi-host layer: one controller process per host, meshes that span all
hosts' GPUs, collectives handed to NCCL by XLA.

``init_distributed()`` wraps ``jax.distributed.initialize`` with the usual
environment conventions (coordinator/num_processes/process_id passed
explicitly or via env).  It is a no-op
when the runtime is already initialized or when running single-process, so
library code and CLIs can call it unconditionally.

Typical multi-host run (one command per host, then call
``init_distributed()`` before any jax use):

    COORDINATOR=host0:9999 NPROC=4 PROC_ID=$i python my_driver.py

after which ``jax.devices()`` is the global device list, ``data_mesh()``
spans all hosts, ``sharded_solver`` shards the instance axis globally, and
per-host input feeding goes through ``host_local_batch`` below.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import jax
import numpy as np


@dataclass(frozen=True)
class DistributedInfo:
    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int

    @property
    def is_main(self) -> bool:
        return self.process_index == 0


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> DistributedInfo:
    """Initialize the multi-host runtime (idempotent).

    Args default from env: COORDINATOR / NPROC / PROC_ID.  GPU fleets must
    pass all three (nothing auto-discovers them).  Single-process (no
    coordinator anywhere): no-op.
    """
    coordinator_address = coordinator_address or os.environ.get("COORDINATOR")
    num_processes = num_processes or _int_env("NPROC")
    process_id = process_id if process_id is not None else _int_env("PROC_ID")

    already = getattr(jax._src.distributed.global_state, "client", None) is not None
    if not already and (coordinator_address is not None or num_processes is not None):
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return DistributedInfo(
        process_index=jax.process_index(),
        process_count=jax.process_count(),
        local_device_count=jax.local_device_count(),
        global_device_count=jax.device_count(),
    )


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def host_local_batch(global_batch: int, info: Optional[DistributedInfo] = None):
    """(start, count) slice of a global batch this host should feed.

    Instances are embarrassingly parallel, so each host generates/loads its
    contiguous shard and ``jax.make_array_from_process_local_data`` (or
    ``shard_batch`` on a host-spanning mesh) assembles the global array.
    """
    if info is None:
        info = DistributedInfo(
            jax.process_index(), jax.process_count(),
            jax.local_device_count(), jax.device_count(),
        )
    per = global_batch // info.process_count
    extra = global_batch % info.process_count
    start = info.process_index * per + min(info.process_index, extra)
    count = per + (1 if info.process_index < extra else 0)
    return start, count
