"""Worker process for the 2-process x 4-CPU-device distributed test
(tests/test_multiprocess.py).  Each worker:

1. forces the CPU backend with 4 local devices,
2. joins the jax.distributed fleet via ``parallel.init_distributed``,
3. runs the sharded classical solver over the GLOBAL 8-device mesh and
   prints a replicated checksum,
4. runs one real data-parallel training epoch through
   ``train.trainer.train_phinet`` with the mesh spanning both processes
   (process-0-gated checkpoint/metric writes),
5. prints machine-readable RESULT lines the parent asserts on.

Usage: python _multiproc_worker.py <coordinator> <num_procs> <pid> <workdir>
"""

import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)

import numpy as np  # noqa: E402


def main():
    coordinator, nproc, pid, workdir = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )

    from admmnet_tpu.parallel import (
        data_mesh, host_local_batch, init_distributed, shard_batch,
        sharded_solver,
    )

    info = init_distributed(coordinator, nproc, pid)
    assert info.process_count == nproc, info
    assert info.process_index == pid, info
    assert info.local_device_count == 4, info
    assert info.global_device_count == 4 * nproc, info
    print(f"RESULT devices {info.global_device_count}", flush=True)

    # --- sharded solve over the host-spanning mesh -----------------------
    from admmnet_tpu.data.anchor import make_anchor_batch
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    B = 16
    y, b, sigma = make_anchor_batch(B, mode="redemod", seed=0)
    mesh = data_mesh(info.global_device_count)
    solve = sharded_solver(mesh, num_iters=5)
    phi = solve(y, b, sigma)  # sharded over both processes' devices
    rep = NamedSharding(mesh, P())
    checksum = float(
        jax.jit(lambda p: jnp.sum(jnp.abs(p)), out_shardings=rep)(phi)
    )
    print(f"RESULT solver_checksum {checksum:.6f}", flush=True)

    # host_local_batch covers the global batch exactly once across processes
    start, count = host_local_batch(B, info)
    print(f"RESULT local_slice {start} {count}", flush=True)

    # --- one real mesh-trainer epoch across processes ---------------------
    from admmnet_tpu.core.config import (
        DataConfig, ModelConfig, ProblemSpec, TrainConfig,
    )
    from admmnet_tpu.data.generator import generate_batch
    from admmnet_tpu.train.trainer import train_phinet

    spec = ProblemSpec(Nb=4, Nd=4, L_max=2)
    data = generate_batch(jax.random.PRNGKey(0), DataConfig(spec=spec), 16)
    rng = np.random.default_rng(0)
    data["phi"] = (
        rng.normal(size=(16, spec.n)) + 1j * rng.normal(size=(16, spec.n))
    ).astype(np.complex64)

    mcfg = ModelConfig(spec=spec, num_layers=2, hidden_dim=32)
    tcfg = TrainConfig(batch_size=8, epochs=1, patience=5)
    r = train_phinet(
        mcfg, tcfg, data, data, workdir=workdir,
        log_fn=lambda *_: None, mesh=mesh,
    )
    print(f"RESULT train_loss {r.history['train_loss'][-1]:.8f}", flush=True)
    print(f"RESULT val_loss {r.history['val_loss'][-1]:.8f}", flush=True)
    print("RESULT ok", flush=True)


if __name__ == "__main__":
    main()
