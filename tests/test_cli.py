"""CLI smoke tests (CPU): each entry point runs end-to-end."""

import json
import sys

import numpy as np
import pytest


def test_main_classical_json(capsys):
    from admmnet_tpu.cli.main_classical import main

    main(["--mode", "fixed_e", "--max-iter", "10", "--g-update", "newton_schulz",
          "--json"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["f1"] == 1.0
    assert len(out["peaks"]) == 3
    assert abs(out["sigma"] - 4.4641) < 1e-3


def test_generate_then_train_then_infer(tmp_path, capsys):
    from admmnet_tpu.cli.generate_dataset import main as gen_main
    from admmnet_tpu.cli.train_cli import main as train_main
    from admmnet_tpu.cli.main_net import main as net_main

    ds = tmp_path / "ds"
    gen_main(["--out", str(ds), "--total", "60", "--Nb", "10", "--Nd", "10",
              "--with-phi", "--phi-iters", "3", "--fixed-snr", "20",
              "--stats-plot"])
    capsys.readouterr()
    assert (ds / "dataset_statistics.png").stat().st_size > 1000

    run = tmp_path / "run"
    train_main(["--data", str(ds), "--workdir", str(run), "--phi",
                "--num-layers", "2", "--epochs", "1", "--batch-size", "16"])
    out = capsys.readouterr().out
    assert "best val loss" in out

    net_main(["--ckpt", str(run), "--num-layers", "2", "--json"])
    peaks = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "peaks" in peaks


def test_bench_time_batched(capsys, tmp_path):
    from admmnet_tpu.cli.bench_time import main

    out = tmp_path / "t.txt"
    main(["--what", "admm", "--runs", "8", "--iters", "3",
          "--out", str(out)])
    txt = capsys.readouterr().out
    assert "classical ADMM" in txt
    assert out.exists() and np.loadtxt(out).shape == (8,)


def test_bench_time_e2e(capsys):
    from admmnet_tpu.cli.bench_time import main

    main(["--what", "e2e", "--runs", "4", "--layers", "1",
          "--g-mode", "chebyshev"])
    txt = capsys.readouterr().out
    assert "ADMM-Net e2e detection" in txt and "spectrum head" in txt


def test_plotting_writes_files(tmp_path):
    from admmnet_tpu.ops.atoms import atom
    from admmnet_tpu.utils.plotting import plot_peaks, plot_predictions_vs_truth

    phi = np.asarray(atom(0.3, 0.1, 10, 10))
    p1 = plot_predictions_vs_truth(
        [0.1], [0.3], [[0.3, 0.1, 5.0]], str(tmp_path / "a.png")
    )
    p2 = plot_peaks(phi, 10, 10, {"tau": np.array([0.3]), "f": np.array([0.1])},
                    str(tmp_path / "b.png"), step=0.02)
    import os

    assert os.path.getsize(p1) > 1000 and os.path.getsize(p2) > 1000


def test_main_classical_deploy_mode(tmp_path, capsys):
    """--deploy runs the gated fixed-budget pipeline (detection-grade
    polar_fast solve) and still localizes the anchor."""
    import json as _json

    from admmnet_tpu.cli.main_classical import main

    main(["--mode", "fixed_e", "--deploy", "--json"])
    out = _json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["iterations"] == 10
    assert out["converged"] is None  # fixed budget: no convergence claim
    assert out["f1"] == 1.0
