"""Mesh and sharding utilities: scenario/data parallelism over devices.

The reference is strictly single-process/single-device (SURVEY.md 2.2: no
torch.distributed, no NCCL/MPI anywhere), so all parallelism here is
first-class new design:

- the instance (scenario) axis is THE parallel axis: thousands of
  independent MN=100 recovery problems shard over the ``data`` mesh axis;
  every solver/model op is batched, so jit auto-partitions the whole program
  with zero communication except where semantics demand it (the ZLayer's
  batch-mean feature becomes one psum; training grads reduce via psum);
- TP/PP/SP/EP have no referent in this workload (101x101 lifted matrices, no
  sequence dim, no experts -- SURVEY.md 2.2); the mesh is built with a
  ``model`` axis of size 1 so a second axis can be introduced without API
  change if MN is ever scaled;
- multi-host: the same code runs under ``jax.distributed.initialize`` where
  the mesh spans hosts' GPUs and XLA hands collectives to NCCL.  This module
  only touches ``jax.sharding`` primitives, so nothing changes shape-wise.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def data_mesh(n_devices: Optional[int] = None, model_axis: int = 1) -> Mesh:
    """1-D (data) x (model=1) mesh over the first n_devices devices."""
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    arr = np.array(devs[:n]).reshape(n // model_axis, model_axis)
    return Mesh(arr, ("data", "model"))


def batch_spec(tree):
    """PartitionSpec pytree: shard the leading axis of every leaf on 'data'."""
    return jax.tree.map(lambda _: P("data"), tree)


def shard_batch(tree, mesh: Mesh):
    """Place a host pytree with its leading axis sharded over 'data'."""

    def put(x):
        sh = NamedSharding(mesh, P("data", *([None] * (np.ndim(x) - 1))))
        return jax.device_put(x, sh)

    return jax.tree.map(put, tree)


def replicate(tree, mesh: Mesh):
    """Fully replicate a pytree over the mesh."""
    sh = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, sh), tree)


def sharded_solver(mesh: Mesh, num_iters: int, lambda_val: float = 1.0, opts=None):
    """Batched fixed-iteration classical solve with the instance axis sharded
    over the mesh.  Returns a callable (y, b, sigma) -> phi; inputs (host
    numpy or device arrays) are placed row-sharded over 'data' before the
    solve, so each device holds and solves B / n_devices instances, and the
    output stays on device with the same sharding.  B must divide evenly."""
    from admmnet_tpu.core.config import ADMMOptions
    from admmnet_tpu.solver import admm_solve_fixed

    opts = opts or ADMMOptions()
    dsh = NamedSharding(mesh, P("data"))

    def run(y, b, sigma):
        return admm_solve_fixed(y, b, sigma, num_iters, lambda_val, opts)

    jitted = jax.jit(
        run, in_shardings=dsh, out_shardings=NamedSharding(mesh, P("data", None))
    )

    def call(y, b, sigma):
        return jitted(*jax.device_put((y, b, sigma), dsh))

    return call
