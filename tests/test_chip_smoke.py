"""chip_smoke.py rehearsed on the CPU: the GPU check, and each phase function
at Nb=Nd=4 (the full-width run needs the card; see README)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import chip_smoke
from admmnet_tpu.core.config import DataConfig, ProblemSpec
from admmnet_tpu.data.generator import generate_batch

REPO = Path(__file__).resolve().parents[1]
SPEC = ProblemSpec(Nb=4, Nd=4, L_max=2)


def _scenes(B, seed=0, snr=(20.0, 20.0)):
    return generate_batch(
        jax.random.PRNGKey(seed), DataConfig(spec=SPEC, snr_range=snr), B
    )


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.require_gpu()


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "script_alone"])
def test_script_fails_without_gpu_and_prints_no_result(tmp_path, alone):
    """On the CPU the script exits non-zero naming the missing GPU, and
    prints no result line -- also when copied away from the repository."""
    if alone:
        cwd = tmp_path
        shutil.copy(REPO / "chip_smoke.py", cwd / "chip_smoke.py")
    else:
        cwd = REPO
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_compile_and_time_reports_compile_and_steady():
    out, compile_s, times, compiled = chip_smoke.compile_and_time(
        lambda x: (x * 2.0).sum(), (jax.numpy.ones(8),), repeats=2
    )
    assert float(out) == 16.0 and compile_s > 0
    assert len(times) == 2 and all(t >= 0 for t in times)
    assert float(compiled(jax.numpy.ones(8))) == 16.0


def test_detection_phase_rehearsal():
    raw = _scenes(16)
    r = chip_smoke.detection_phase(
        raw["y"], raw["b"], raw["sigma"], raw["tau"], raw["f"], 4, 4,
        iters=20, n_check=4, repeats=1,
    )
    assert r["B"] == 16 and r["checked"] == 4 and len(r["steady_s"]) == 1
    assert 0.0 <= r["f1"] <= 1.0
    assert 0.0 <= r["nmse_vs_eigh"] < 1e-2  # detection-grade schedule
    assert r["inst_iter_per_s"] > 0


def test_detection_phase_writes_trace(tmp_path):
    raw = _scenes(4)
    chip_smoke.detection_phase(
        raw["y"], raw["b"], raw["sigma"], raw["tau"], raw["f"], 4, 4,
        iters=2, n_check=2, repeats=1, trace_dir=str(tmp_path),
    )
    assert list(tmp_path.rglob("*.xplane.pb"))


def test_phi_exact_phase_meets_contract():
    raw = _scenes(8, seed=1)
    r = chip_smoke.phi_exact_phase(
        raw["y"], raw["b"], raw["sigma"], iters=30, n_check=8, repeats=1
    )
    assert r["g_update"] == "polar"
    assert r["nmse_vs_eigh"] <= chip_smoke.PHI_EXACT_NMSE


def test_deploy_phase_rehearsal():
    raw = _scenes(16, seed=2, snr=(5.0, 25.0))
    r = chip_smoke.deploy_phase(raw, 4, 4, control_iters=20, repeats=1)
    assert r["scenes"] == 16 and r["budget_iters"] == 10
    assert 0.0 <= r["f1"] <= 1.0 and 0.0 <= r["f1_control"] <= 1.0
    assert set(r["timing"]) == {"deploy", "control"}


def test_deploy_cli_anchor_full_width():
    r = chip_smoke.deploy_cli_anchor()
    assert r["f1"] == 1.0 and r["iterations"] == 10


def test_reference_pin_phase_full_width():
    r = chip_smoke.reference_pin_phase()
    assert r["nmse_vs_oracle64"] < chip_smoke.REF_PIN_NMSE
    assert r["iterations"] == r["iterations_oracle"]


@pytest.mark.parametrize("n_devices", [2, 4])
def test_sharded_phase_rehearsal(n_devices):
    """The --four path on virtual CPU devices: every device holds B/n rows
    of the inputs and of phi, and phi equals the one-device solve."""
    raw = _scenes(8 * n_devices, seed=3)
    r = chip_smoke.sharded_phase(
        raw["y"], raw["b"], raw["sigma"], n_devices, iters=5, repeats=1
    )
    assert r["rows_per_device_input"] == [8] * n_devices
    assert r["rows_per_device_phi"] == [8] * n_devices
    assert r["nmse_sharded_vs_one"] <= chip_smoke.SHARD_NMSE


def test_gpu_smoke_on_card(gpu):
    """On the card: a small detection solve compiles for the GPU and agrees
    with the eigh solve (both at HIGHEST)."""
    del gpu
    from admmnet_tpu.data.anchor import ANCHOR_F, ANCHOR_TAU, make_anchor_batch

    y, b, s = make_anchor_batch(64, mode="redemod", seed=0)
    tau = np.broadcast_to(ANCHOR_TAU, (64, 3))
    f = np.broadcast_to(ANCHOR_F, (64, 3))
    r = chip_smoke.detection_phase(y, b, s, tau, f, 10, 10, repeats=1)
    assert r["f1"] == 1.0 and r["nmse_vs_eigh"] < 1e-2


def test_bench_line_rehearsal(monkeypatch, capsys):
    """bench.py's one JSON line at a tiny size, with the GPU check stubbed:
    every metric field is present and the device is named."""
    import json

    import bench

    monkeypatch.setattr(chip_smoke, "require_gpu", jax.devices)
    for k, v in {"BENCH_BATCH": "16", "BENCH_ITERS": "3", "BENCH_REPEATS": "1",
                 "BENCH_RANDOM": "16", "BENCH_EXACT_BATCH": "8"}.items():
        monkeypatch.setenv(k, v)
    bench.main()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "classical_admm_instance_iterations_per_s"
    assert line["value"] > 0 and line["batch"] == 16
    assert line["g_update"] == "polar_fast"
    for key in ("quality_f1", "phi_nmse_vs_eigh", "random_gate_ok",
                "deploy_gate_ok", "deploy_scenes_per_s", "exact_iter_s",
                "exact_phi_nmse_vs_eigh", "refcompat_phi_nmse_vs_oracle64"):
        assert key in line, key
    assert line["refcompat_phi_nmse_vs_oracle64"] < 1e-8
    assert line["device"]["platform"] == "cpu"
