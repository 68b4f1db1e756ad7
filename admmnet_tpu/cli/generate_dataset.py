"""Dataset generation CLI (reference test.py + test/test_phi_dataset.py).

Usage:
  python -m admmnet_tpu.cli.generate_dataset --out data/fixSNR20L3 --total 10000
  python -m admmnet_tpu.cli.generate_dataset --out data/phi5k --total 5000 --with-phi
"""

from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--total", type=int, default=10000)
    p.add_argument("--Nb", type=int, default=10)
    p.add_argument("--Nd", type=int, default=10)
    p.add_argument("--L-max", type=int, default=3)
    p.add_argument("--snr-min", type=float, default=5.0)
    p.add_argument("--snr-max", type=float, default=25.0)
    p.add_argument("--fixed-snr", type=float, default=None,
                   help="use a single SNR (reference fixSNR20L3 style)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--with-phi", action="store_true",
                   help="label with classical-solver phi (batched)")
    p.add_argument("--phi-iters", type=int, default=100)
    p.add_argument("--phi-g-update", default="polar",
                   help="PSD step for the labeller (polar|eigh|"
                        "newton_schulz; polar = the phi-exact contract, "
                        "NMSE vs eigh <= 1e-5)")
    p.add_argument("--stats-plot", action="store_true",
                   help="write dataset_statistics.png (reference "
                        "generate_data.py:302-349)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from admmnet_tpu.core.config import ADMMOptions, DataConfig, ProblemSpec
    from admmnet_tpu.data.generator import DatasetGenerator
    from admmnet_tpu.utils import enable_compile_cache

    enable_compile_cache()

    snr = (
        (args.fixed_snr, args.fixed_snr)
        if args.fixed_snr is not None
        else (args.snr_min, args.snr_max)
    )
    cfg = DataConfig(
        spec=ProblemSpec(Nb=args.Nb, Nd=args.Nd, L_max=args.L_max),
        snr_range=snr,
    )
    gen = DatasetGenerator(cfg, data_dir=args.out)
    gen.generate_complete_dataset(
        total_samples=args.total, seed=args.seed, with_phi=args.with_phi,
        phi_iters=args.phi_iters,
        phi_opts=ADMMOptions(g_update=args.phi_g_update),
    )
    if args.stats_plot:
        from pathlib import Path

        from admmnet_tpu.utils.plotting import plot_dataset_statistics

        p = plot_dataset_statistics(
            gen.load_split("train"), str(Path(args.out) / "dataset_statistics.png")
        )
        print(f"stats figure: {p}")
    print(f"dataset written to {args.out}")


if __name__ == "__main__":
    main()
