"""Training CLI (reference train.py:446-450 / trainPhi.py:306-311).

Usage:
  python -m admmnet_tpu.cli.train_cli --data data/fixSNR20L3 --workdir runs/x
  python -m admmnet_tpu.cli.train_cli --data data/phi5k --workdir runs/phi --phi
"""

from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", required=True, help="dataset dir (generate_dataset)")
    p.add_argument("--workdir", required=True)
    p.add_argument("--phi", action="store_true", help="train PhiEstADMMNet")
    p.add_argument("--num-layers", type=int, default=10)
    p.add_argument("--g-mode", default="eigh", choices=["eigh", "chebyshev"],
                   help="GLayer spectral-filter evaluation (see ops/chebyshev.py)")
    p.add_argument("--head", default="attention",
                   choices=["attention", "spectrum"],
                   help="e2e peak head: attention (reference parity) or "
                        "spectrum (differentiable spectral search)")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--patience", type=int, default=10,
                   help="early-stop patience (reference train.py:133); set "
                        "large to run through SGDR restarts")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=None,
                   help="default 1e-3 (e2e) / 5e-3 (phi, reference trainPhi.py:31)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--assignment", default="slot", choices=["slot", "perm"],
                   help="e2e loss target assignment (perm = set matching)")
    p.add_argument("--spectral-weight", type=float, default=None,
                   help="spectral contrast loss weight (default 0.5 with "
                        "--head spectrum, else 0; see train/losses.py)")
    p.add_argument("--init-from", default=None,
                   help="warm-start matching submodules (e.g. the trunk) "
                        "from this checkpoint dir (e2e mode only)")
    p.add_argument("--learned-sensing", action="store_true",
                   help="enable the trainable measurement/calibration matrix "
                        "(north-star config #5; models/nets.py _SensingMatrix)")
    p.add_argument("--reset-best", action="store_true",
                   help="on resume, forget the checkpoint's best-val/patience "
                        "(curriculum stage switch: losses are not comparable "
                        "across datasets)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import json
    from pathlib import Path

    from admmnet_tpu.core.config import ModelConfig, ProblemSpec, TrainConfig, to_json
    from admmnet_tpu.data.generator import DatasetGenerator
    from admmnet_tpu.train.trainer import train_admmnet, train_phinet
    from admmnet_tpu.utils import enable_compile_cache

    enable_compile_cache()

    gen = DatasetGenerator(data_dir=args.data)
    info = json.loads((Path(args.data) / "dataset_config.json").read_text())
    spec = ProblemSpec(Nb=info["Nb"], Nd=info["Nd"], L_max=info["L_max"])
    train = gen.load_split("train")
    val = gen.load_split("val")
    test = gen.load_split("test")

    mcfg = ModelConfig(spec=spec, num_layers=args.num_layers,
                       g_mode=args.g_mode, head=args.head,
                       learned_sensing=args.learned_sensing)
    lr = args.lr if args.lr is not None else (5e-3 if args.phi else 1e-3)
    sw = args.spectral_weight
    if sw is None:
        sw = 0.5 if args.head == "spectrum" else 0.0
    tcfg = TrainConfig(
        batch_size=args.batch_size, epochs=args.epochs, lr=lr, seed=args.seed,
        assignment=args.assignment, spectral_weight=sw,
        patience=args.patience, reset_best=args.reset_best,
    )
    Path(args.workdir).mkdir(parents=True, exist_ok=True)
    (Path(args.workdir) / "config.json").write_text(
        json.dumps({"model": json.loads(to_json(mcfg)),
                    "train": json.loads(to_json(tcfg))}, indent=2)
    )

    if args.phi:
        res = train_phinet(mcfg, tcfg, train, val, test, workdir=args.workdir)
    else:
        res = train_admmnet(mcfg, tcfg, train, val, test,
                            workdir=args.workdir, init_from=args.init_from)
    print(f"best val loss {res.best_val_loss:.6f} after {res.epochs_run} epochs")
    if res.test_metrics:
        print("test:", json.dumps(res.test_metrics, indent=2))


if __name__ == "__main__":
    main()
