"""Timing-benchmark CLI (reference test/test_time_admm.py + test_time_net.py).

Replicates the reference metric protocol -- N repeated solves on the anchor
scenario with fresh noise per run, wall-clock per solve appended to a text
file -- but batched: all runs execute as ONE device program and the per-solve
time is total/batch (amortized), which is the honest figure for a
throughput-oriented deployment.  A --sequential mode times true single-solve
latency.

Usage:
  python -m admmnet_tpu.cli.bench_time --what admm --runs 1000 --out results/time/time.txt
  python -m admmnet_tpu.cli.bench_time --what net --layers 5 --runs 1000
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--what", choices=["admm", "net", "e2e"], default="admm",
                   help="admm: classical solver; net: PhiEstADMMNet trunk "
                        "forward (reference test_time_net.py); e2e: full "
                        "ADMMNet observation -> (tau, f, conf) peak list")
    p.add_argument("--runs", type=int, default=1000)
    p.add_argument("--iters", type=int, default=100, help="ADMM iterations")
    p.add_argument("--layers", type=int, default=10, help="net depth")
    p.add_argument("--g-update", default="newton_schulz")
    p.add_argument("--g-mode", default="eigh", choices=["eigh", "chebyshev"],
                   help="net GLayer mode (--what net / e2e)")
    p.add_argument("--cheb-degree", type=int, default=48)
    p.add_argument("--cheb-precision", default="highest",
                   choices=["highest", "default"],
                   help="Clenshaw matmul precision (default = TF32 on GPU)")
    p.add_argument("--head", default="spectrum",
                   choices=["attention", "spectrum"],
                   help="peak head (--what e2e)")
    p.add_argument("--ckpt", default=None, help="net checkpoint (else fresh init)")
    p.add_argument("--sequential", action="store_true",
                   help="time one solve at a time (latency, not throughput)")
    p.add_argument("--adaptive", action="store_true",
                   help="--what admm: use the adaptive early-exit solve "
                        "(lax.while_loop + per-instance converged mask -- the "
                        "reference's actual stopping protocol, admm.py:98-112)"
                        " and report the iterations-to-convergence histogram")
    p.add_argument("--eta", type=float, default=1e-7,
                   help="eta_abs = eta_rel for --adaptive (reference 1e-7)")
    p.add_argument("--out", default=None, help="output txt (one time per row)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import jax
    import jax.numpy as jnp

    from admmnet_tpu.core.config import ADMMOptions, ModelConfig, ProblemSpec
    from admmnet_tpu.data.anchor import make_anchor_batch
    from admmnet_tpu.utils import enable_compile_cache

    enable_compile_cache()

    y, b, sigma = make_anchor_batch(args.runs, mode="redemod", seed=0)

    if args.what == "admm":
        from admmnet_tpu.solver import admm_solve, admm_solve_fixed

        if args.adaptive:
            # reference protocol: stop per instance at eta, floor min_iter=5,
            # cap max_iter (reference admm.py:95-112).
            opts = ADMMOptions(g_update=args.g_update, max_iter=args.iters,
                               eta_abs=args.eta, eta_rel=args.eta)

            def _run(y, b, s):
                res = admm_solve(y, b, s, 1.0, opts)
                return (jnp.sum(jnp.abs(res.phi)),
                        res.iterations,
                        res.converged.astype(jnp.int32))

            inner = jax.jit(_run)

            def fn(y, b, s):
                total, iters, conv = inner(y, b, s)
                fn.last_iters = np.asarray(iters)
                fn.last_converged = np.asarray(conv)
                return total

            label = (f"classical ADMM adaptive (eta={args.eta:g}, "
                     f"max {args.iters}, {args.g_update})")
        else:
            opts = ADMMOptions(g_update=args.g_update)
            fn = jax.jit(
                lambda y, b, s: jnp.sum(
                    jnp.abs(admm_solve_fixed(y, b, s, args.iters, 1.0, opts))
                )
            )
            label = f"classical ADMM ({args.iters} iters, {args.g_update})"
    else:
        from admmnet_tpu.models import ADMMNet, PhiEstADMMNet
        from admmnet_tpu.train.checkpoint import restore_checkpoint

        e2e = args.what == "e2e"
        mcfg = ModelConfig(spec=ProblemSpec(), num_layers=args.layers,
                           g_mode=args.g_mode, head=args.head,
                       cheb_degree=args.cheb_degree,
                       cheb_precision=args.cheb_precision)
        model = (ADMMNet if e2e else PhiEstADMMNet)(cfg=mcfg)
        params = jax.jit(lambda k, y, b, s: model.init(k, y, b, s))(
            jax.random.PRNGKey(0), y[:1], b[:1], sigma[:1]
        )
        if args.ckpt:
            restored = restore_checkpoint(args.ckpt, {"params": params, "opt_state": None})
            if restored is not None:
                params = restored[0]["params"]
        if e2e:
            # full pipeline: observation -> (tau, f, conf); touch every output
            def _run(y, b, s):
                tau, f, conf, _phi = model.apply(params, y, b, s)
                return jnp.sum(tau) + jnp.sum(f) + jnp.sum(conf)

            fn = jax.jit(_run)
            label = (f"ADMM-Net e2e detection ({args.layers} layers, "
                     f"{args.head} head)")
        else:
            fn = jax.jit(
                lambda y, b, s: jnp.sum(jnp.abs(model.apply(params, y, b, s)))
            )
            label = f"ADMM-Net forward ({args.layers} layers)"

    if args.sequential:
        # true per-solve latency, one instance at a time -- the reference
        # protocol (test_time_admm.py:85-110) is 1000 independent runs with
        # fresh noise per run; every run here is a distinct anchor instance.
        jax.block_until_ready(fn(y[:1], b[:1], sigma[:1]))  # compile
        times = []
        for i in range(args.runs):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(y[i : i + 1], b[i : i + 1], sigma[i : i + 1]))
            times.append(time.perf_counter() - t0)
        times = np.asarray(times)
    else:
        jax.block_until_ready(fn(y, b, sigma))  # compile
        t0 = time.perf_counter()
        jax.block_until_ready(fn(y, b, sigma))
        total = time.perf_counter() - t0
        times = np.full(args.runs, total / args.runs)

    print(f"{label}: mean {times.mean():.6f}s  std {times.std():.6f}s  "
          f"median {np.median(times):.6f}s  min {times.min():.6f}s  "
          f"max {times.max():.6f}s per solve "
          f"({'sequential' if args.sequential else f'batched x{args.runs}'})")
    if getattr(args, "adaptive", False) and getattr(fn, "last_iters", None) is not None:
        it = fn.last_iters.ravel()
        conv = fn.last_converged.ravel()
        q = np.percentile(it, [50, 90, 95, 99])
        uniq, cnt = np.unique(it, return_counts=True)
        print(f"iterations-to-convergence: mean {it.mean():.2f}  "
              f"median {q[0]:.0f}  p90 {q[1]:.0f}  p95 {q[2]:.0f}  "
              f"p99 {q[3]:.0f}  max {it.max()}  "
              f"converged {conv.mean() * 100:.1f}%")
        print("iteration histogram: "
              + " ".join(f"{u}:{c}" for u, c in zip(uniq, cnt)))
        # batched adaptive note: the batch finishes when the LAST instance
        # converges, so amortized per-solve time is an upper bound
        eff = it.mean() / max(it.max(), 1)
        print(f"mask efficiency (mean/max iterations): {eff:.3f}")
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        np.savetxt(out, times)
        print(f"written {out}")


if __name__ == "__main__":
    main()
