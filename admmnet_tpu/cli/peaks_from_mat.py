"""MATLAB cross-validation CLI (reference test_peaksearch.py:1-43).

Loads a phi vector exported from the original MATLAB implementation
(.mat, variable ``phi_ad`` by default; the reference expects
data/mat/phi_ad.mat which is not bundled upstream either), peak-searches it
with the batched pipeline, and prints peaks sorted by height -- the
cross-implementation check against the MATLAB ANM-DUMV code.

Usage: python -m admmnet_tpu.cli.peaks_from_mat data/mat/phi_ad.mat
"""

from __future__ import annotations

import argparse

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("mat_file")
    p.add_argument("--var", default="phi_ad", help=".mat variable name")
    p.add_argument("--Nb", type=int, default=10)
    p.add_argument("--Nd", type=int, default=10)
    p.add_argument("--top", type=int, default=10)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import scipy.io as sio

    import jax

    from admmnet_tpu.core.config import PeakSearchConfig
    from admmnet_tpu.peaks import find_peaks
    from admmnet_tpu.utils import enable_compile_cache

    enable_compile_cache()

    mat = sio.loadmat(args.mat_file)
    if args.var not in mat:
        raise SystemExit(
            f"variable {args.var!r} not in {args.mat_file}; has "
            f"{[k for k in mat if not k.startswith('__')]}"
        )
    phi = np.asarray(mat[args.var]).reshape(-1).astype(np.complex64)

    peaks = jax.device_get(
        jax.jit(lambda p: find_peaks(p, args.Nb, args.Nd, PeakSearchConfig()))(phi)
    )
    print(f"found peaks (top {args.top}) [tau, f, height]:")
    shown = 0
    for i in range(peaks.tau.shape[-1]):
        if not bool(peaks.valid[i]) or shown >= args.top:
            break
        print(f"  {shown + 1}. [{float(peaks.tau[i]):.4f}, "
              f"{float(peaks.f[i]):+.4f}, {float(peaks.height[i]):.3f}]")
        shown += 1


if __name__ == "__main__":
    main()
