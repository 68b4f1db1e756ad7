"""Mesh/sharding tests on the 8-virtual-device CPU backend."""

import numpy as np
import jax
import jax.numpy as jnp

from admmnet_tpu.core.config import ADMMOptions
from admmnet_tpu.data.anchor import make_anchor_batch
from admmnet_tpu.parallel import data_mesh, shard_batch, sharded_solver
from admmnet_tpu.solver import admm_solve_fixed


def test_eight_virtual_devices_present():
    assert len(jax.devices()) == 8


def test_sharded_solver_matches_single_device():
    B = 16
    y, b, sigma = make_anchor_batch(B, mode="redemod", seed=0)
    mesh = data_mesh(8)
    solve = sharded_solver(mesh, num_iters=5)
    phi_sharded = np.asarray(solve(y, b, sigma))
    phi_single = np.asarray(
        admm_solve_fixed(
            jnp.asarray(y), jnp.asarray(b), jnp.asarray(sigma), 5, 1.0, ADMMOptions()
        )
    )
    np.testing.assert_allclose(phi_sharded, phi_single, atol=2e-5)


def test_shard_batch_places_on_mesh():
    mesh = data_mesh(8)
    y, b, sigma = make_anchor_batch(8, seed=1)
    tree = shard_batch({"y": y, "sigma": sigma}, mesh)
    assert tree["y"].sharding.num_devices == 8
    assert jnp.iscomplexobj(tree["y"])
    np.testing.assert_allclose(np.asarray(tree["y"]), y, atol=1e-6)


def test_graft_entry_single_chip():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    jitted = jax.jit(fn)
    out = jitted(*args)
    tau, f, conf, phi_re, phi_im = out
    assert tau.shape == (8, 3) and phi_re.shape == (8, 100)
    assert np.isfinite(np.asarray(tau)).all()


def test_graft_entry_multichip_dryrun():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_init_distributed_single_process_noop():
    from admmnet_tpu.parallel import host_local_batch, init_distributed

    info = init_distributed()
    assert info.process_count == 1 and info.is_main
    assert info.global_device_count == 8  # virtual CPU mesh (conftest)
    start, count = host_local_batch(100, info)
    assert (start, count) == (0, 100)


def test_host_local_batch_partition():
    from admmnet_tpu.parallel import DistributedInfo, host_local_batch

    total = 0
    for pid in range(3):
        info = DistributedInfo(pid, 3, 4, 12)
        start, count = host_local_batch(10, info)
        assert start == total
        total += count
    assert total == 10


def test_sharded_deploy_pipeline_matches_single_device():
    """The round-5 deployment surface (budget-10 solve + PRODUCTION_PEAKS)
    shards over the data mesh like the full-budget solve: peak lists from
    the 8-way-sharded pipeline equal the single-device ones."""
    from admmnet_tpu.core.config import (
        DETECTION_BUDGET_ITERS,
        PRODUCTION_PEAKS,
    )
    from admmnet_tpu.parallel import shard_batch
    from admmnet_tpu.peaks import find_peaks

    B = 16
    y, b, sigma = make_anchor_batch(B, mode="redemod", seed=1)
    opts = ADMMOptions(g_update="polar_fast")

    def pipe(yy, bb, ss):
        return find_peaks(
            admm_solve_fixed(yy, bb, ss, DETECTION_BUDGET_ITERS, 1.0, opts),
            10, 10, PRODUCTION_PEAKS,
        )

    mesh = data_mesh(8)
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharded = jax.jit(pipe, out_shardings=NamedSharding(mesh, P("data", None)))
    batch = shard_batch({"y": y, "b": b, "s": sigma}, mesh)
    pk_sh = jax.device_get(sharded(batch["y"], batch["b"], batch["s"]))
    pk_1 = jax.device_get(jax.jit(pipe)(y, b, sigma))
    np.testing.assert_allclose(np.asarray(pk_sh.tau), np.asarray(pk_1.tau),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(pk_sh.f), np.asarray(pk_1.f),
                               atol=1e-5)
