"""Scaling-efficiency harness: instance-throughput vs device count.

The north-star protocol (BASELINE.md): ADMM iterations/s per chip at 1 chip /
1 host / >=2 hosts, with >=95% per-chip scaling efficiency on 10k batched
instances.  The workload is embarrassingly parallel over instances (zero
cross-device communication in the solve), so scaling is bounded only by
dispatch overheads; this harness measures it directly on whatever devices are
visible (GPUs, or the virtual CPU mesh in CI).  Inputs are placed sharded
before timing, and every timed call ends in ``jax.block_until_ready``.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np

from admmnet_tpu.core.config import ADMMOptions


def measure_throughput(
    n_devices: int,
    batch_per_device: int = 512,
    iters: int = 20,
    opts: Optional[ADMMOptions] = None,
    repeats: int = 2,
    seed: int = 0,
    total_batch: Optional[int] = None,
) -> float:
    """Instance-iterations/s of the batched solve over an n-device mesh.

    ``total_batch`` switches from weak scaling (B = batch_per_device * n,
    the pod protocol) to strong scaling (fixed B sharded over n devices --
    the right shape on oversubscribed virtual-device CPU meshes, where weak
    scaling measures host-core contention, not sharding overhead)."""
    import jax
    import jax.numpy as jnp

    from admmnet_tpu.data.anchor import make_anchor_batch
    from admmnet_tpu.parallel import data_mesh
    from admmnet_tpu.solver import admm_solve_fixed
    from jax.sharding import NamedSharding, PartitionSpec as P

    opts = opts or ADMMOptions(g_update="polar")
    B = total_batch if total_batch is not None else batch_per_device * n_devices
    if B % n_devices:
        raise ValueError(f"total_batch {B} not divisible by {n_devices} devices")
    y, b, sigma = make_anchor_batch(B, mode="redemod", seed=seed)
    mesh = data_mesh(n_devices)

    dsh = NamedSharding(mesh, P("data"))
    fn = jax.jit(
        lambda y, b, s: jnp.sum(
            jnp.abs(admm_solve_fixed(y, b, s, iters, 1.0, opts))
        ),
        in_shardings=dsh,
    )
    args = jax.device_put((y, b, sigma), dsh)
    jax.block_until_ready(fn(*args))  # compile
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return B * iters / best


def scaling_report(
    device_counts: Sequence[int],
    batch_per_device: int = 512,
    iters: int = 20,
    opts: Optional[ADMMOptions] = None,
    total_batch: Optional[int] = None,
) -> List[dict]:
    """Throughput + per-chip efficiency table across device counts.

    Weak scaling (default): efficiency = throughput / (n * base_per_device);
    strong scaling (``total_batch``): efficiency = throughput / base, i.e.
    fixed work should keep total throughput flat (the host cores, not the
    mesh, are the roof on a virtual-device CPU run)."""
    rows = []
    base = None
    for n in device_counts:
        tput = measure_throughput(
            n, batch_per_device, iters, opts, total_batch=total_batch
        )
        if base is None:
            base = tput / (1 if total_batch is not None else device_counts[0])
        eff = tput / base if total_batch is not None else tput / (n * base)
        rows.append(
            {
                "devices": n,
                "throughput_iters_per_s": tput,
                "per_device": tput / n,
                "efficiency": eff,
            }
        )
    return rows
