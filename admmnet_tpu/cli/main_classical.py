"""Classical end-to-end pipeline CLI (reference main.py:8-137).

Builds the anchor scenario (data modes fresh/redemod/fixed_e ~ reference
data_type 0/1/2), runs the batched ADMM, peak-searches, prints the top-L
peaks sorted by height, optionally writes plots.

Usage: python -m admmnet_tpu.cli.main_classical [--mode fixed_e] [--plot out/]
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mode", default="fixed_e", choices=["fresh", "redemod", "fixed_e"])
    p.add_argument("--max-iter", type=int, default=100)
    p.add_argument("--eta", type=float, default=1e-7)
    p.add_argument("--rho", type=float, default=1.0)
    p.add_argument("--lambda-val", type=float, default=1.0)
    p.add_argument("--g-update", default="eigh",
                   choices=["eigh", "newton_schulz", "ref_identity"])
    p.add_argument("--phi-update", default="diag", choices=["diag", "ref_dense"])
    p.add_argument("--top", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--snr-w", type=float, default=20.0)
    p.add_argument("--plot", default=None, help="directory for output figures")
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.add_argument("--deploy", action="store_true",
                   help="gated deployment point: detection-grade polar_fast "
                        "solve at the fixed DETECTION_BUDGET_ITERS budget + "
                        "PRODUCTION_PEAKS (2-round DEFAULT-precision refine); "
                        "overrides --max-iter/--eta/--g-update")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import jax

    from admmnet_tpu.core.config import (
        ADMMOptions,
        DETECTION_BUDGET_ITERS,
        PeakSearchConfig,
        PRODUCTION_PEAKS,
    )
    from admmnet_tpu.data.anchor import load_anchor
    from admmnet_tpu.peaks import find_peaks, match_peaks
    from admmnet_tpu.solver import admm_solve, admm_solve_fixed
    from admmnet_tpu.utils import enable_compile_cache

    enable_compile_cache()
    sc = load_anchor(mode=args.mode, snr_w=args.snr_w,
                     rng=np.random.default_rng(args.seed))
    lam = args.lambda_val

    if args.deploy:
        opts = ADMMOptions(rho=args.rho, g_update="polar_fast",
                           phi_update=args.phi_update)
        pcfg = PRODUCTION_PEAKS
        budget = DETECTION_BUDGET_ITERS
        phi = jax.jit(
            lambda y, b, s: admm_solve_fixed(y, b, s, budget, lam, opts)
        )(
            np.asarray(sc.y, np.complex64)[None],
            np.asarray(sc.b, np.complex64)[None],
            np.float32(sc.sigma)[None],
        )[0]
        # fixed-budget solve: there IS no convergence measurement (the
        # budget is gated offline, see core.config) -- report None
        info = {"iterations": budget, "converged": None}
    else:
        opts = ADMMOptions(
            rho=args.rho, max_iter=args.max_iter, eta_abs=args.eta,
            eta_rel=args.eta, g_update=args.g_update,
            phi_update=args.phi_update,
        )
        pcfg = PeakSearchConfig()

        run = jax.jit(lambda y, b, s: admm_solve(y, b, s, lam, opts))
        res = run(
            np.asarray(sc.y, np.complex64), np.asarray(sc.b, np.complex64),
            np.float32(sc.sigma),
        )
        phi = res.phi
        info = jax.device_get(
            {"iterations": res.iterations, "converged": res.converged}
        )
    peaks = jax.device_get(
        jax.jit(lambda p: find_peaks(p, sc.Nb, sc.Nd, pcfg))(phi)
    )

    rows = [
        [float(peaks.tau[i]), float(peaks.f[i]), float(peaks.height[i])]
        for i in range(min(args.top, len(peaks.valid)))
        if bool(peaks.valid[i])
    ]
    stats = match_peaks(
        np.asarray([r[0] for r in rows])[None, :],
        np.asarray([r[1] for r in rows])[None, :],
        sc.tau[None, :], sc.f[None, :], 0.05, 0.05,
    )

    if args.json:
        print(json.dumps({
            "iterations": int(info["iterations"]),
            "converged": (None if info["converged"] is None
                          else bool(info["converged"])),
            "sigma": sc.sigma,
            "ser": sc.ser,
            "peaks": rows,
            "f1": stats["f1"],
            "tau_rmse": stats["tau_rmse"],
            "f_rmse": stats["f_rmse"],
        }))
    else:
        print(f"sigma: {sc.sigma:.4f}  SER: {sc.ser:.2f}%")
        conv = ("fixed budget (gated offline)" if info["converged"] is None
                else f"converged={bool(info['converged'])}")
        print(f"ADMM finished after {int(info['iterations'])} iterations "
              f"({conv})")
        print(f"top {len(rows)} peaks [tau, f, height]:")
        for i, r in enumerate(rows):
            print(f"  {i + 1}. [{r[0]:.4f}, {r[1]:+.4f}, {r[2]:.2f}]")
        print(f"truth tau={sc.tau.tolist()} f={sc.f.tolist()}")
        print(f"detection F1={stats['f1']:.3f} tau_rmse={stats['tau_rmse']:.4f} "
              f"f_rmse={stats['f_rmse']:.4f}")

    if args.plot:
        from pathlib import Path

        from admmnet_tpu.utils.plotting import plot_peaks, plot_predictions_vs_truth

        d = Path(args.plot)
        d.mkdir(parents=True, exist_ok=True)
        phi_host = np.asarray(phi)
        plot_predictions_vs_truth(sc.f, sc.tau, rows, str(d / "pred_vs_truth.png"))
        plot_peaks(phi_host, sc.Nb, sc.Nd, {"tau": sc.tau, "f": sc.f},
                   str(d / "peaks_surface.png"))
        print(f"plots written to {d}")


if __name__ == "__main__":
    main()
