"""Scaling-efficiency CLI: throughput vs device count.

Usage: python -m admmnet_tpu.cli.bench_scaling --devices 1 2 4 8
"""

from __future__ import annotations

import argparse
import json


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--devices", type=int, nargs="+", default=None,
                   help="device counts to sweep (default: 1..all)")
    p.add_argument("--batch-per-device", type=int, default=512)
    p.add_argument("--total-batch", type=int, default=None,
                   help="strong scaling: fixed total batch sharded over the "
                        "devices (default: weak scaling, batch-per-device*n)")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--g-update", default="polar")
    p.add_argument("--force-cpu", type=int, default=None, metavar="N",
                   help="run on N virtual CPU devices (validates the sharded "
                        "path and measures scaling shape without a pod; "
                        "absolute numbers are not device numbers)")
    p.add_argument("--json", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import jax

    if args.force_cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.force_cpu)

    from admmnet_tpu.bench import scaling_report
    from admmnet_tpu.core.config import ADMMOptions
    from admmnet_tpu.utils import enable_compile_cache

    enable_compile_cache()

    n_avail = len(jax.devices())
    counts = args.devices or sorted(
        {n for n in (1, 2, 4, 8, n_avail) if n <= n_avail}
    )
    rows = scaling_report(
        counts, args.batch_per_device, args.iters,
        ADMMOptions(g_update=args.g_update), total_batch=args.total_batch,
    )
    if args.json:
        print(json.dumps(rows))
    else:
        print(f"{'devices':>8}{'iters/s':>14}{'per-device':>14}{'efficiency':>12}")
        for r in rows:
            print(f"{r['devices']:>8}{r['throughput_iters_per_s']:>14.0f}"
                  f"{r['per_device']:>14.0f}{r['efficiency']:>12.2%}")


if __name__ == "__main__":
    main()
