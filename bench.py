#!/usr/bin/env python
"""Round benchmark: batched classical ANM-ADMM throughput on the data.npz
anchor protocol, with detection-quality gates.  Needs a GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Protocol (mirrors reference test/test_time_admm.py:85-110, batched):
- BENCH_BATCH independent anchor instances (fresh demod + channel noise per
  instance), BENCH_ITERS ADMM iterations each (the reference's max_iter=100
  budget), scan-based fixed-iteration path.  Inputs are placed on the device
  before timing and every timed call ends in ``block_until_ready``.
- value = instance-iterations per second on one device; baseline = 190
  iterations/s, the reference's implied classical throughput (BASELINE.md;
  mean 0.5244 s per <=100-iteration solve).
- quality gates: the peaks of 8 solved anchor instances must localize the 3
  true targets ("quality_f1" 1.0); phi NMSE vs the exact-eigh solve on the
  same instances; the phi-exact ``polar`` mode's throughput and NMSE
  (contract <= 1e-5); on BENCH_RANDOM random-SNR scenes the headline mode
  and the deploy point (DETECTION_BUDGET_ITERS + PRODUCTION_PEAKS) must reach
  the 100-iteration eigh control's F1 within 0.005 ("random_gate_ok",
  "deploy_gate_ok"); the ref-compat mode must match the float64 oracle.

The phases are chip_smoke.py's; this script only chooses sizes and names the
fields.  Env knobs: BENCH_BATCH (8192), BENCH_ITERS (100), BENCH_G
(headline PSD mode: polar_fast | polar | newton_schulz | eigh), BENCH_REPEATS
(2), BENCH_RANDOM (random-SNR scene count, 512; 0 disables), BENCH_EXACT
(0|1, default 1: the phi-exact block), BENCH_EXACT_BATCH (2048),
BENCH_REFCOMPAT (0|1, default 1).
"""

import json
import os

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    import chip_smoke as cs
    from admmnet_tpu.core.config import (
        DETECTION_BUDGET_ITERS,
        PRODUCTION_PEAKS,
        ADMMOptions,
        DataConfig,
    )
    from admmnet_tpu.data.anchor import ANCHOR_F, ANCHOR_TAU, make_anchor_batch
    from admmnet_tpu.peaks import find_peaks, scale_invariant_nmse
    from admmnet_tpu.solver import admm_solve_fixed
    from admmnet_tpu.utils import enable_compile_cache

    devs = cs.require_gpu()
    enable_compile_cache()

    B = int(os.environ.get("BENCH_BATCH", 8192))
    ITERS = int(os.environ.get("BENCH_ITERS", 100))
    G_MODE = os.environ.get("BENCH_G", "polar_fast")
    REPEATS = int(os.environ.get("BENCH_REPEATS", 2))
    opts = ADMMOptions(g_update=G_MODE)

    y, b, sigma = make_anchor_batch(B, mode="redemod", seed=0)
    args = jax.device_put((y, b, sigma))
    phi, compile_s, times, _ = cs.compile_and_time(
        lambda y, b, s: admm_solve_fixed(y, b, s, ITERS, 1.0, opts),
        args, REPEATS,
    )
    best = min(times)
    ips = B * ITERS / best

    qB = 8
    stats = cs.detection_stats(
        phi[:qB], np.broadcast_to(ANCHOR_TAU, (qB, 3)),
        np.broadcast_to(ANCHOR_F, (qB, 3)), 10, 10,
    )
    nmse_vs_eigh = None
    if G_MODE != "eigh":
        nmse_vs_eigh = scale_invariant_nmse(
            np.asarray(phi[:qB]),
            cs.eigh_phi(y[:qB], b[:qB], sigma[:qB], ITERS),
        )

    exact_fields = {}
    if int(os.environ.get("BENCH_EXACT", 1)):
        B_EX = min(B, int(os.environ.get("BENCH_EXACT_BATCH", 2048)))
        r = cs.phi_exact_phase(y[:B_EX], b[:B_EX], sigma[:B_EX], ITERS,
                               n_check=qB, repeats=REPEATS)
        exact_iter_s = B_EX * ITERS / min(r["steady_s"])
        exact_fields = {
            "exact_phi_nmse_vs_eigh": r["nmse_vs_eigh"],
            "exact_iter_s": round(exact_iter_s, 1),
            "exact_vs_baseline": round(exact_iter_s / 190.0, 2),
            "exact_batch": B_EX,
        }

    random_fields = {}
    RANDOM_B = int(os.environ.get("BENCH_RANDOM", 512))
    if RANDOM_B > 0:
        from admmnet_tpu.data.generator import generate_batch

        raw = generate_batch(jax.random.PRNGKey(42), DataConfig(), RANDOM_B)
        prod = cs.detection_stats(
            jax.jit(lambda y, b, s: admm_solve_fixed(y, b, s, ITERS, 1.0, opts))(
                raw["y"], raw["b"], raw["sigma"]),
            raw["tau"], raw["f"], 10, 10,
        )
        dep = cs.deploy_phase(raw, 10, 10, ITERS, repeats=1)
        control = dep["f1_control"]
        random_fields = {
            "random_snr_scenes": RANDOM_B,
            "random_f1": round(prod["f1"], 4),
            "random_f1_eigh_control": round(control, 4),
            "random_f1_band": cs.F1_BAND,
            "random_gate_ok": bool(prod["f1"] >= control - cs.F1_BAND),
            "random_tau_rmse": round(prod["tau_rmse"], 5),
            "random_tau_rmse_eigh_control": round(dep["tau_rmse_control"], 5),
            "deploy_random_f1": round(dep["f1"], 4),
            "deploy_gate_ok": bool(dep["f1"] >= control - cs.F1_BAND),
        }

    # deploy throughput: observation -> (tau, f, height) peak list at the
    # gated budget, on the anchor batch
    def deploy(y, b, s):
        pk = find_peaks(
            admm_solve_fixed(y, b, s, DETECTION_BUDGET_ITERS, 1.0,
                             ADMMOptions(g_update="polar_fast")),
            10, 10, PRODUCTION_PEAKS,
        )
        return (jnp.sum(pk.tau) + jnp.sum(pk.f)
                + jnp.sum(jnp.where(pk.valid, pk.height, 0.0)))

    _, _, d_times, _ = cs.compile_and_time(deploy, args, REPEATS)
    best_d = min(d_times)
    random_fields.update({
        "deploy_budget_iters": DETECTION_BUDGET_ITERS,
        "deploy_ms_per_scene": round(best_d / B * 1e3, 4),
        "deploy_scenes_per_s": round(B / best_d, 1),
    })

    refcompat_nmse = None
    if int(os.environ.get("BENCH_REFCOMPAT", 1)):
        refcompat_nmse = cs.reference_pin_phase(ITERS)["nmse_vs_oracle64"]

    print(json.dumps({
        "metric": "classical_admm_instance_iterations_per_s",
        "value": round(ips, 1),
        "unit": "iter/s",
        "vs_baseline": round(ips / 190.0, 2),
        "batch": B,
        "iters": ITERS,
        "g_update": G_MODE,
        "compile_s": round(compile_s, 1),
        "best_run_s": round(best, 4),
        "quality_f1": round(stats["f1"], 4),
        "tau_rmse": round(stats["tau_rmse"], 5),
        "f_rmse": round(stats["f_rmse"], 5),
        "phi_nmse_vs_eigh": nmse_vs_eigh,
        **random_fields,
        **exact_fields,
        "refcompat_phi_nmse_vs_oracle64": refcompat_nmse,
        "device": {"platform": devs[0].platform, "kind": devs[0].device_kind,
                   "count": len(devs),
                   "name_power_limit": cs.gpu_name_and_power_limit()},
    }))


if __name__ == "__main__":
    main()
