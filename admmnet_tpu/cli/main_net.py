"""Net inference pipeline CLI (reference main_for_net.py:13-143).

Loads a trained PhiEstADMMNet checkpoint, runs phi inference on the anchor
scenario, peak-searches, prints the top-L peaks.

Usage: python -m admmnet_tpu.cli.main_net --ckpt runs/phinet [--mode fixed_e]
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True, help="checkpoint directory")
    p.add_argument("--mode", default="fixed_e", choices=["fresh", "redemod", "fixed_e"])
    p.add_argument("--num-layers", type=int, default=10)
    p.add_argument("--g-mode", default="eigh", choices=["eigh", "chebyshev"])
    p.add_argument("--head", default="attention",
                   choices=["attention", "spectrum"],
                   help="e2e ADMMNet peak head variant")
    p.add_argument("--top", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", action="store_true")
    p.add_argument("--plot", default=None)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import jax

    from admmnet_tpu.core.config import ModelConfig, PeakSearchConfig, ProblemSpec
    from admmnet_tpu.data.anchor import load_anchor
    from admmnet_tpu.models import PhiEstADMMNet
    from admmnet_tpu.peaks import find_peaks, match_peaks
    from admmnet_tpu.train.checkpoint import restore_checkpoint
    from admmnet_tpu.utils import enable_compile_cache

    enable_compile_cache()

    sc = load_anchor(mode=args.mode, rng=np.random.default_rng(args.seed))
    spec = ProblemSpec(Nb=sc.Nb, Nd=sc.Nd, L_max=3)
    mcfg = ModelConfig(spec=spec, num_layers=args.num_layers,
                       g_mode=args.g_mode, head=args.head)
    model = PhiEstADMMNet(cfg=mcfg)

    y = np.asarray(sc.y, np.complex64)[None, :]
    b = np.asarray(sc.b, np.complex64)[None, :]
    sigma = np.asarray([sc.sigma], np.float32)

    params = jax.jit(lambda key, y, b, s: model.init(key, y, b, s))(
        jax.random.PRNGKey(0), y, b, sigma
    )
    restored = restore_checkpoint(args.ckpt, {"params": params, "opt_state": None})
    if restored is None:
        raise SystemExit(f"no checkpoint found under {args.ckpt}")
    params = restored[0]["params"]

    infer = jax.jit(
        lambda p, y, b, s: find_peaks(
            model.apply(p, y, b, s), sc.Nb, sc.Nd, PeakSearchConfig()
        )
    )
    peaks = jax.device_get(infer(params, y, b, sigma))
    rows = [
        [float(peaks.tau[0, i]), float(peaks.f[0, i]), float(peaks.height[0, i])]
        for i in range(args.top)
        if bool(peaks.valid[0, i])
    ]
    stats = match_peaks(
        np.asarray([r[0] for r in rows])[None, :],
        np.asarray([r[1] for r in rows])[None, :],
        sc.tau[None, :], sc.f[None, :], 0.05, 0.05,
    )

    if args.json:
        print(json.dumps({"peaks": rows, "f1": stats["f1"],
                          "tau_rmse": stats["tau_rmse"], "f_rmse": stats["f_rmse"]}))
    else:
        print(f"net inference ({args.num_layers} layers) peaks [tau, f, height]:")
        for i, r in enumerate(rows):
            print(f"  {i + 1}. [{r[0]:.4f}, {r[1]:+.4f}, {r[2]:.2f}]")
        print(f"truth tau={sc.tau.tolist()} f={sc.f.tolist()}")
        print(f"F1={stats['f1']:.3f}")


if __name__ == "__main__":
    main()
