#!/usr/bin/env python
"""Smoke run of the detection pipeline on one GPU, end to end, in one process.

Phases (each prints one line ``[phase N name] {json}``):

1. device     -- refuse anything but a GPU; print its kind, count, name and
                 power limit (``nvidia-smi``).
2. detection  -- ``admm_solve_fixed`` on 8192 anchor instances x 100
                 iterations, detection-grade ``polar_fast``: compile and
                 steady seconds, anchor F1 on 8 instances (gate: 1.0), phi
                 NMSE vs the ``eigh`` solve of the same 8.
3. phi_exact  -- ``polar`` at B=2048 x 100; phi NMSE vs the ``eigh`` solve
                 on a 64-instance slice (gate: <= 1e-5, the contract
                 ``label_phi`` serves).
4. deploy     -- the ``main_classical --deploy`` path: the CLI itself on the
                 anchor (gate: F1 1.0), then the same budget and peak config
                 on 512 random-SNR scenes vs the 100-iteration ``eigh``
                 control on the same scenes (gate: F1 >= control - 0.005).
5. ref_pin    -- ref-compat ``admm_solve`` on the fixed anchor vs the float64
                 numpy oracle (gate: NMSE < 1e-8).

Precision: every solver product runs at ``Precision.HIGHEST`` (full f32;
the code pins it), including the ``eigh`` reference solves.  The peak
search's refine einsums run at DEFAULT under ``PRODUCTION_PEAKS`` (TF32 on
the card) -- phase 4's gate re-checks that.  The oracle is float64 numpy.

``--four`` runs only the sharded solve on four GPUs: ``sharded_solver`` at
B=4x8192 against the one-card solve of the same instances, plus a check that
every card holds B/4 rows of the inputs and of phi.

``--trace DIR`` also writes a ``jax.profiler`` trace of one steady phase-2
call and prints its device idle share and per-stage device time (stages are
the solver's ``jax.named_scope`` names; with XLA's CUDA graphs on, kernels
carry no scope and count as "other" -- see ``device_stage_split``).  The last line is ``{"ok": true, "device": {...}}``; any failed gate
or a missing GPU exits non-zero without it.

Usage: python chip_smoke.py [--four] [--trace DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

ITERS = 100
MATCH_TOL = 0.05
F1_BAND = 0.005  # deploy F1 may trail the eigh control by at most this
PHI_EXACT_NMSE = 1e-5
REF_PIN_NMSE = 1e-8
SHARD_NMSE = 1e-6  # sharded vs one-card phi: same math, other batch tiling


def require_gpu():
    """The JAX device list; exits non-zero unless the first is a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU found (JAX platform is "
            f"{devs[0].platform!r}); nothing was run"
        )
    return devs


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi`` name and power limit, one card per line."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"
    return out


def compile_and_time(fn, args, repeats: int = 3):
    """(output, compile_s, steady times, compiled): AOT-compiles ``fn`` for
    ``args`` (device arrays), warms once, then times ``repeats`` calls, each
    ending in ``block_until_ready``."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    return out, compile_s, times, compiled


def _solve_fn(g_update: str, iters: int):
    from admmnet_tpu.core.config import ADMMOptions
    from admmnet_tpu.solver import admm_solve_fixed

    opts = ADMMOptions(g_update=g_update)
    return lambda y, b, s: admm_solve_fixed(y, b, s, iters, 1.0, opts)


def eigh_phi(y, b, sigma, iters):
    """phi of the exact-projection (eigh) solve: the reference side."""
    import jax

    return np.asarray(jax.jit(_solve_fn("eigh", iters))(y, b, sigma))


def detection_stats(phi, tau, f, Nb, Nd) -> dict:
    """Position-matched detection stats (F1, RMSE, ...) of the top-L peaks
    of ``phi`` vs the truth ``tau``/``f`` of shape (B, L)."""
    import jax

    from admmnet_tpu.core.config import PeakSearchConfig
    from admmnet_tpu.peaks import find_peaks, match_peaks

    pcfg = PeakSearchConfig(max_peaks=8)
    pk = jax.device_get(
        jax.jit(lambda p: find_peaks(p, Nb, Nd, pcfg))(phi)
    )
    L = tau.shape[-1]
    return match_peaks(pk.tau[:, :L], pk.f[:, :L], tau, f,
                       tol_tau=MATCH_TOL, tol_f=MATCH_TOL)


def _timing(B, iters, compile_s, times):
    steady = float(np.median(times))
    return {
        "compile_s": round(compile_s, 3),
        "steady_s": [round(t, 5) for t in times],
        "inst_iter_per_s": round(B * iters / steady, 1),
    }


def detection_phase(y, b, sigma, tau, f, Nb, Nd, iters=ITERS, n_check=8,
                    repeats=3, trace_dir=None):
    """Detection-grade ``polar_fast`` solve of the whole batch; F1 and phi
    NMSE vs ``eigh`` on the first ``n_check`` instances."""
    import jax

    from admmnet_tpu.peaks import scale_invariant_nmse

    B = y.shape[0]
    fn = _solve_fn("polar_fast", iters)
    args = jax.device_put((y, b, sigma))
    phi, compile_s, times, compiled = compile_and_time(fn, args, repeats)
    if trace_dir:
        with jax.profiler.trace(trace_dir):
            jax.block_until_ready(compiled(*args))
        with open(os.path.join(trace_dir, "detection.hlo.txt"), "w") as fp:
            fp.write(compiled.as_text())
    phi_c = np.asarray(phi[:n_check])
    c = slice(0, n_check)
    return {
        "B": B, "iters": iters, "g_update": "polar_fast",
        **_timing(B, iters, compile_s, times),
        "f1": detection_stats(phi_c, tau[c], f[c], Nb, Nd)["f1"],
        "nmse_vs_eigh": scale_invariant_nmse(
            phi_c, eigh_phi(y[c], b[c], sigma[c], iters)
        ),
        "checked": n_check,
    }


def phi_exact_phase(y, b, sigma, iters=ITERS, n_check=64, repeats=3):
    """phi-exact ``polar`` solve; NMSE vs ``eigh`` on a slice."""
    import jax

    from admmnet_tpu.peaks import scale_invariant_nmse

    B = y.shape[0]
    args = jax.device_put((y, b, sigma))
    phi, compile_s, times, _ = compile_and_time(
        _solve_fn("polar", iters), args, repeats
    )
    c = slice(0, n_check)
    return {
        "B": B, "iters": iters, "g_update": "polar",
        **_timing(B, iters, compile_s, times),
        "nmse_vs_eigh": scale_invariant_nmse(
            np.asarray(phi[c]), eigh_phi(y[c], b[c], sigma[c], iters)
        ),
        "checked": n_check,
    }


def deploy_cli_anchor() -> dict:
    """``python -m admmnet_tpu.cli.main_classical --deploy --json`` on the
    fixed anchor, called in-process through its ``main(argv)``."""
    from admmnet_tpu.cli import main_classical

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main_classical.main(["--mode", "fixed_e", "--deploy", "--json"])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    return {"f1": out["f1"], "iterations": out["iterations"],
            "peaks": out["peaks"]}


def deploy_phase(scenes, Nb, Nd, control_iters=ITERS, repeats=3):
    """Deploy pipeline (budget + PRODUCTION_PEAKS, as ``--deploy`` runs it)
    on ``scenes`` vs the ``eigh`` control; both scored against truth."""
    import jax

    from admmnet_tpu.core.config import (
        DETECTION_BUDGET_ITERS,
        PRODUCTION_PEAKS,
        ADMMOptions,
        PeakSearchConfig,
    )
    from admmnet_tpu.peaks import find_peaks, match_peaks
    from admmnet_tpu.solver import admm_solve_fixed

    def pipeline(opts, iters, pcfg):
        return lambda y, b, s: find_peaks(
            admm_solve_fixed(y, b, s, iters, 1.0, opts), Nb, Nd, pcfg
        )

    args = jax.device_put((scenes["y"], scenes["b"], scenes["sigma"]))
    B = scenes["y"].shape[0]
    L = scenes["tau"].shape[-1]
    stats, timing = {}, {}
    for name, fn in (
        ("deploy", pipeline(ADMMOptions(g_update="polar_fast"),
                            DETECTION_BUDGET_ITERS, PRODUCTION_PEAKS)),
        ("control", pipeline(ADMMOptions(g_update="eigh"), control_iters,
                             PeakSearchConfig(max_peaks=8))),
    ):
        pk, compile_s, times, _ = compile_and_time(fn, args, repeats)
        pk = jax.device_get(pk)
        stats[name] = match_peaks(
            pk.tau[:, :L], pk.f[:, :L], scenes["tau"], scenes["f"],
            tol_tau=MATCH_TOL, tol_f=MATCH_TOL,
        )
        steady = float(np.median(times))
        timing[name] = {"compile_s": round(compile_s, 3),
                        "steady_s": [round(t, 5) for t in times],
                        "scenes_per_s": round(B / steady, 1)}
    return {
        "scenes": B, "budget_iters": DETECTION_BUDGET_ITERS,
        "control_iters": control_iters,
        "f1": stats["deploy"]["f1"], "f1_control": stats["control"]["f1"],
        "tau_rmse": stats["deploy"]["tau_rmse"],
        "tau_rmse_control": stats["control"]["tau_rmse"],
        "timing": timing,
    }


def reference_pin_phase(iters=ITERS) -> dict:
    """Ref-compat solve of the fixed anchor vs the float64 numpy oracle."""
    import jax

    from admmnet_tpu.core.config import ADMMOptions
    from admmnet_tpu.data.anchor import load_anchor
    from admmnet_tpu.peaks import phi_nmse
    from admmnet_tpu.solver import admm_solve
    from admmnet_tpu.solver.reference_oracle import reference_admm

    sc = load_anchor(mode="fixed_e", rng=np.random.default_rng(0))
    opts = ADMMOptions(phi_update="ref_dense", g_update="ref_identity",
                       max_iter=iters)
    res = jax.jit(lambda y, b, s: admm_solve(y, b, s, 1.0, opts))(
        np.asarray(sc.y, np.complex64)[None],
        np.asarray(sc.b, np.complex64)[None],
        np.float32(sc.sigma)[None],
    )
    phi_oracle, iters_oracle = reference_admm(
        sc.y, sc.b, 1.0, sc.sigma, max_iter=iters, phi_mode="dense"
    )
    return {
        "nmse_vs_oracle64": phi_nmse(np.asarray(res.phi)[0], phi_oracle),
        "iterations": int(res.iterations[0]),
        "iterations_oracle": int(iters_oracle),
    }


def sharded_phase(y, b, sigma, n_devices, iters=ITERS, repeats=3,
                  g_update="polar_fast"):
    """``sharded_solver`` over ``n_devices`` vs the one-device solve of the
    same instances; rows per device of the placed inputs and of phi.  The
    one-device side solves the batch in ``n_devices`` chunks of B/n (one
    device's share, and the memory one device is sized for)."""
    import jax

    from admmnet_tpu.core.config import ADMMOptions
    from admmnet_tpu.parallel import data_mesh, sharded_solver
    from admmnet_tpu.peaks import scale_invariant_nmse

    B = y.shape[0]
    mesh = data_mesh(n_devices)
    solve = sharded_solver(mesh, iters, opts=ADMMOptions(g_update=g_update))
    t0 = time.perf_counter()
    phi_sh = jax.block_until_ready(solve(y, b, sigma))
    first_s = time.perf_counter() - t0
    sh_times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        phi_sh = jax.block_until_ready(solve(y, b, sigma))
        sh_times.append(time.perf_counter() - t0)

    dsh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("data"))
    y_placed = jax.device_put(y, dsh)
    dev0 = jax.devices()[0]
    q = B // n_devices
    chunks = [jax.device_put((y[i:i + q], b[i:i + q], sigma[i:i + q]), dev0)
              for i in range(0, B, q)]
    _, compile_s, _, compiled = compile_and_time(
        _solve_fn(g_update, iters), chunks[0], repeats=0
    )
    one_times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        phi_1 = jax.block_until_ready([compiled(*c) for c in chunks])
        one_times.append(time.perf_counter() - t0)
    phi_1 = np.concatenate([np.asarray(p) for p in phi_1])
    return {
        "B": B, "devices": n_devices, "iters": iters, "g_update": g_update,
        "rows_per_device_input": sorted(
            s.data.shape[0] for s in y_placed.addressable_shards
        ),
        "rows_per_device_phi": sorted(
            s.data.shape[0] for s in phi_sh.addressable_shards
        ),
        "nmse_sharded_vs_one": scale_invariant_nmse(np.asarray(phi_sh), phi_1),
        "sharded": {"first_call_s": round(first_s, 3),
                    "steady_s": [round(t, 5) for t in sh_times],
                    "inst_iter_per_s": round(
                        B * iters / float(np.median(sh_times)), 1)},
        "one_device": _timing(B, iters, compile_s, one_times),
    }


def _report(n, name, fields):
    print(f"[phase {n} {name}] {json.dumps(fields)}", flush=True)


def run_one_card(trace_dir=None) -> list:
    """Phases 2-5 at full width; returns the failed gates."""
    import jax

    from admmnet_tpu.core.config import DataConfig
    from admmnet_tpu.data.anchor import ANCHOR_F, ANCHOR_TAU, make_anchor_batch
    from admmnet_tpu.data.generator import generate_batch

    failed = []
    y, b, sigma = make_anchor_batch(8192, mode="redemod", seed=0)
    B = y.shape[0]
    tau = np.broadcast_to(ANCHOR_TAU, (B, 3))
    f = np.broadcast_to(ANCHOR_F, (B, 3))

    r = detection_phase(y, b, sigma, tau, f, 10, 10, trace_dir=trace_dir)
    _report(2, "detection", r)
    if trace_dir:
        from admmnet_tpu.utils.profiling import device_stage_split

        with open(os.path.join(trace_dir, "detection.hlo.txt")) as fp:
            hlo = fp.read()
        _report(2, "trace", device_stage_split(
            trace_dir, ("psd_projection", "h_projection"), hlo))
    if r["f1"] != 1.0:
        failed.append(f"detection anchor F1 {r['f1']} != 1.0")

    r = phi_exact_phase(y[:2048], b[:2048], sigma[:2048])
    _report(3, "phi_exact", r)
    if not r["nmse_vs_eigh"] <= PHI_EXACT_NMSE:
        failed.append(f"polar NMSE vs eigh {r['nmse_vs_eigh']:.3e} > "
                      f"{PHI_EXACT_NMSE:g}")

    cli = deploy_cli_anchor()
    scenes = generate_batch(jax.random.PRNGKey(42), DataConfig(), 512)
    r = {"cli_anchor": cli, **deploy_phase(scenes, 10, 10)}
    _report(4, "deploy", r)
    if cli["f1"] != 1.0:
        failed.append(f"--deploy anchor F1 {cli['f1']} != 1.0")
    if not r["f1"] >= r["f1_control"] - F1_BAND:
        failed.append(f"deploy F1 {r['f1']:.4f} < eigh control "
                      f"{r['f1_control']:.4f} - {F1_BAND}")

    r = reference_pin_phase()
    _report(5, "ref_pin", r)
    if not r["nmse_vs_oracle64"] < REF_PIN_NMSE:
        failed.append(f"ref-compat NMSE vs oracle {r['nmse_vs_oracle64']:.3e}"
                      f" >= {REF_PIN_NMSE:g}")
    return failed


def run_four_cards() -> list:
    """Sharded solve on four GPUs vs one card; returns the failed gates."""
    from admmnet_tpu.data.anchor import make_anchor_batch

    y, b, sigma = make_anchor_batch(4 * 8192, mode="redemod", seed=0)
    r = sharded_phase(y, b, sigma, 4)
    _report(2, "sharded", r)
    failed = []
    quarter = y.shape[0] // 4
    for key in ("rows_per_device_input", "rows_per_device_phi"):
        if r[key] != [quarter] * 4:
            failed.append(f"{key} {r[key]} != 4 x {quarter}")
    if not r["nmse_sharded_vs_one"] <= SHARD_NMSE:
        failed.append(f"sharded vs one-card NMSE "
                      f"{r['nmse_sharded_vs_one']:.3e} > {SHARD_NMSE:g}")
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="only the sharded solve, on four GPUs")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="write a profiler trace of one phase-2 call")
    args = ap.parse_args(argv)

    devs = require_gpu()
    from admmnet_tpu.utils import enable_compile_cache

    cache = enable_compile_cache()
    want = 4 if args.four else 1
    if len(devs) < want:
        raise SystemExit(f"chip_smoke: needs {want} GPUs, found {len(devs)}")
    _report(1, "device", {"platform": devs[0].platform,
                          "kind": devs[0].device_kind, "count": len(devs),
                          "compile_cache": cache})
    print(gpu_name_and_power_limit(), flush=True)

    failed = run_four_cards() if args.four else run_one_card(args.trace)
    if failed:
        for msg in failed:
            print(f"FAILED: {msg}", flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
