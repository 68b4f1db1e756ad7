"""Model-quality evaluation CLI (reference test/test_model_peaksearch.py).

Runs a trained PhiEstADMMNet on the test split, peak-searches both the model
phi and the classical-solver phi labels, and reports side-by-side detection
metrics plus the PhiAlignment test loss.

Usage: python -m admmnet_tpu.cli.eval_net --data data/phi5k --ckpt runs/phi
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", required=True, help="dataset dir with phi labels")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--num-layers", type=int, default=10)
    p.add_argument("--g-mode", default="eigh", choices=["eigh", "chebyshev"])
    p.add_argument("--cheb-degree", type=int, default=48)
    p.add_argument("--cheb-precision", default="highest",
                   choices=["highest", "default"],
                   help="Clenshaw matmul precision (default = TF32 on GPU)")
    p.add_argument("--head", default="attention",
                   choices=["attention", "spectrum"],
                   help="e2e ADMMNet peak head variant")
    p.add_argument("--limit", type=int, default=256, help="max test samples")
    p.add_argument("--tol", type=float, default=0.05, help="match tolerance")
    p.add_argument("--e2e", action="store_true",
                   help="checkpoint is a full ADMMNet (peak head): score its "
                        "direct (tau, f, conf) predictions with "
                        "position-matched F1 instead of phi peak search")
    p.add_argument("--conf-threshold", type=float, default=0.5)
    p.add_argument("--learned-sensing", action="store_true",
                   help="checkpoint has the trainable sensing matrix")
    p.add_argument("--json", action="store_true")
    return p


def _eval_e2e(args):
    """Position-matched detection metrics for an end-to-end ADMMNet."""
    import jax

    from admmnet_tpu.core.config import ModelConfig, ProblemSpec
    from admmnet_tpu.data.generator import DatasetGenerator
    from admmnet_tpu.models import ADMMNet
    from admmnet_tpu.peaks import match_peaks
    from admmnet_tpu.train.checkpoint import restore_checkpoint
    from pathlib import Path

    from admmnet_tpu.utils import enable_compile_cache

    enable_compile_cache()

    gen = DatasetGenerator(data_dir=args.data)
    info = json.loads((Path(args.data) / "dataset_config.json").read_text())
    spec = ProblemSpec(Nb=info["Nb"], Nd=info["Nd"], L_max=info["L_max"])
    test = gen.load_split("test")
    n = min(args.limit, test["y"].shape[0])
    test = {k: v[:n] for k, v in test.items()}

    mcfg = ModelConfig(spec=spec, num_layers=args.num_layers,
                       g_mode=args.g_mode, head=args.head,
                       cheb_degree=args.cheb_degree,
                       cheb_precision=args.cheb_precision,
                       learned_sensing=args.learned_sensing)
    model = ADMMNet(cfg=mcfg)
    params = jax.jit(lambda k, y, b, s: model.init(k, y, b, s))(
        jax.random.PRNGKey(0), test["y"][:2], test["b"][:2], test["sigma"][:2]
    )
    restored = restore_checkpoint(args.ckpt, {"params": params, "opt_state": None})
    if restored is None:
        raise SystemExit(f"no checkpoint under {args.ckpt}")
    params = restored[0]["params"]

    def run(p, y, b, s):
        tau, f, conf, _phi = model.apply(p, y, b, s)
        return tau, f, conf

    tau, f, conf = jax.device_get(
        jax.jit(run)(params, test["y"], test["b"], test["sigma"])
    )
    order = np.argsort(-conf, axis=-1)  # confidence-desc, as find_peaks sorts
    rows = np.arange(n)[:, None]
    tau, f, conf = tau[rows, order], f[rows, order], conf[rows, order]
    stats = match_peaks(
        tau, f, test["tau"], test["f"], args.tol, args.tol,
        pred_valid=conf > args.conf_threshold,
    )
    out = {
        "samples": n,
        "mode": "e2e",
        "conf_threshold": args.conf_threshold,
        "detection": {k: stats[k] for k in
                      ("f1", "precision", "recall", "tau_rmse", "f_rmse")},
    }
    print(json.dumps(out) if args.json else json.dumps(out, indent=2))


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.e2e:
        return _eval_e2e(args)

    import jax

    from admmnet_tpu.core.config import ModelConfig, PeakSearchConfig, ProblemSpec
    from admmnet_tpu.data.generator import DatasetGenerator
    from admmnet_tpu.models import PhiEstADMMNet
    from admmnet_tpu.peaks import find_peaks, match_peaks, scale_invariant_nmse
    from admmnet_tpu.train.checkpoint import restore_checkpoint
    from admmnet_tpu.train.losses import phi_alignment_loss
    from admmnet_tpu.utils import enable_compile_cache

    enable_compile_cache()

    gen = DatasetGenerator(data_dir=args.data)
    from pathlib import Path

    info = json.loads((Path(args.data) / "dataset_config.json").read_text())
    spec = ProblemSpec(Nb=info["Nb"], Nd=info["Nd"], L_max=info["L_max"])
    test = gen.load_split("test")
    if "phi" not in test:
        raise SystemExit("dataset has no phi labels; regenerate with --with-phi")
    n = min(args.limit, test["y"].shape[0])
    test = {k: v[:n] for k, v in test.items()}

    mcfg = ModelConfig(spec=spec, num_layers=args.num_layers,
                       g_mode=args.g_mode, head=args.head,
                       cheb_degree=args.cheb_degree,
                       cheb_precision=args.cheb_precision,
                       learned_sensing=args.learned_sensing)
    model = PhiEstADMMNet(cfg=mcfg)
    params = jax.jit(lambda k, y, b, s: model.init(k, y, b, s))(
        jax.random.PRNGKey(0), test["y"][:2], test["b"][:2], test["sigma"][:2]
    )
    restored = restore_checkpoint(args.ckpt, {"params": params, "opt_state": None})
    if restored is None:
        raise SystemExit(f"no checkpoint under {args.ckpt}")
    params = restored[0]["params"]

    pcfg = PeakSearchConfig(max_peaks=8)

    def run(p, y, b, s, phi_true):
        phi_net = model.apply(p, y, b, s)
        loss, parts = phi_alignment_loss(phi_net, phi_true)
        pk_net = find_peaks(phi_net, spec.Nb, spec.Nd, pcfg)
        pk_cls = find_peaks(phi_true, spec.Nb, spec.Nd, pcfg)
        return loss, parts, pk_net, pk_cls, phi_net

    loss, parts, pk_net, pk_cls, phi_net = jax.device_get(
        jax.jit(run)(params, test["y"], test["b"], test["sigma"], test["phi"])
    )

    L = spec.L_max
    stats_net = match_peaks(
        pk_net.tau[:, :L], pk_net.f[:, :L], test["tau"], test["f"],
        args.tol, args.tol, pred_valid=pk_net.valid[:, :L],
    )
    stats_cls = match_peaks(
        pk_cls.tau[:, :L], pk_cls.f[:, :L], test["tau"], test["f"],
        args.tol, args.tol, pred_valid=pk_cls.valid[:, :L],
    )
    nmse = scale_invariant_nmse(phi_net, test["phi"])

    out = {
        "samples": n,
        "phi_alignment_loss": float(loss),
        "amplitude_loss": float(parts["amplitude_loss"]),
        "phase_loss": float(parts["phase_loss"]),
        "phi_scale_invariant_nmse": nmse,
        "net_detection": {k: stats_net[k] for k in
                          ("f1", "precision", "recall", "tau_rmse", "f_rmse")},
        "classical_detection": {k: stats_cls[k] for k in
                                ("f1", "precision", "recall", "tau_rmse", "f_rmse")},
    }
    if args.json:
        print(json.dumps(out))
    else:
        print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
