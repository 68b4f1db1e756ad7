"""Offline fitter for POLAR_QUINTIC_SCHEDULE (greedy per-step minimax LP).

The matrix-sign schedule applies, per step, the odd quintic
``g(x) = x (a + b x^2 + c x^4)`` to the (normalized) spectrum.  Given the
current eigenvalue band ``[l, u]``, the best step minimizes
``e = max_{x in [l, u]} |g(x) - 1|``; since g is linear in (a, b, c) this is
a linear program on a dense grid (Remez-style).  The band then contracts to
``[1 - e, 1 + e]`` and the next step is fitted to it.

Run as a script to refit (e.g. after changing the step count or the initial
lower bound) and paste the printed tuple into ops/projections.py:

    python -m admmnet_tpu.ops.fit_polar_schedule --steps 7 --l0 1e-3

The quality figures printed alongside are the ones the schedule comments
cite: composed ``|p(x) - 1|`` on ``[l0, 1]`` and the |M|-weighted error
``max_x |x (p(x) - 1)|`` on ``[0, 1]`` (what a PSD projection actually
feels: absolute eigenvalue error scaled by eigenvalue magnitude).
"""

from __future__ import annotations

import argparse

import numpy as np
from scipy.optimize import linprog


def fit_step(l: float, u: float, grid: int = 4001):
    """Minimax quintic g(x)=ax+bx^3+cx^5 mapping [l,u] -> [1-e,1+e] (LP)."""
    x = np.linspace(l, u, grid)
    # variables: a, b, c, e;  constraints: -e <= g(x) - 1 <= e
    G = np.stack([x, x**3, x**5], axis=1)
    A_ub = np.block([[G, -np.ones((grid, 1))], [-G, -np.ones((grid, 1))]])
    b_ub = np.concatenate([np.ones(grid), -np.ones(grid)])
    c = np.array([0.0, 0.0, 0.0, 1.0])
    res = linprog(
        c, A_ub=A_ub, b_ub=b_ub,
        bounds=[(None, None)] * 3 + [(0, None)],
        method="highs",
    )
    if not res.success:
        raise RuntimeError(f"LP failed on [{l}, {u}]: {res.message}")
    a, b, cq, e = res.x
    return (float(a), float(b), float(cq)), float(e)


def fit_schedule(steps: int, l0: float = 1e-3, u0: float = 1.0):
    sched, l, u = [], l0, u0
    for _ in range(steps):
        (a, b, c), e = fit_step(l, u)
        sched.append((a, b, c))
        l, u = 1.0 - e, 1.0 + e
    return sched, e


# ---------------------------------------------------------------------------
# bf16-safe schedule (POLAR_BF16_SCHEDULE): two-phase LP with box constraints
#
# One-pass bf16 matmuls inject ~4e-3 relative noise per product.  The plain minimax schedule diverges under that noise
# for two reasons, both fixed here:
#  1. its polynomials explode outside the fitted band (step-1 quintic reaches
#     ~22 at x=1.2), so a noise-displaced eigenvalue blows up -> every step
#     is constrained to the box  floor <= g(x) <= 1+e  on [0, 1.02*u];
#  2. matmul noise breaks Hermitian symmetry, the iterate drifts non-normal,
#     and polynomial iterations on non-normal matrices have unbounded
#     transient growth -> a low-precision evaluation must re-Hermitianize X
#     after every step (cheap transposes).
# With the box, one gentle step cannot flatten [l0, 1], so early steps
# instead MAXIMIZE the guaranteed growth of the smallest band eigenvalue
# (also an LP: max t s.t. g >= t on band, box on [0, xmax]); once the band
# lower edge passes ~0.25, minimax polish steps take over.  Eigenvalues
# below the bf16 noise floor are written off -- they contribute O(noise)
# error to |M|.
# ---------------------------------------------------------------------------


def _lp(c, A_ub, b_ub, bounds):
    res = linprog(c, A_ub=np.vstack(A_ub), b_ub=np.concatenate(b_ub),
                  bounds=bounds, method="highs")
    if not res.success:
        raise RuntimeError(f"LP failed: {res.message}")
    return res.x


def _basis(x):
    return np.stack([x, x**3, x**5], axis=1)


def fit_step_grow(l, u, xmax, cap=1.01, floor=-0.02, grid=4001):
    """max t s.t. g(x) >= t on [l,u] and floor <= g(x) <= cap on [0,xmax]."""
    Gb, Ga = _basis(np.linspace(l, u, grid)), _basis(np.linspace(0, xmax, grid))
    A = [np.hstack([-Gb, np.ones((grid, 1))]),
         np.hstack([Ga, np.zeros((grid, 1))]),
         np.hstack([-Ga, np.zeros((grid, 1))])]
    b = [np.zeros(grid), np.full(grid, cap), np.full(grid, -floor)]
    a, bq, c, t = _lp(np.array([0.0, 0.0, 0.0, -1.0]), A, b,
                      [(None, None)] * 3 + [(0, None)])
    return (float(a), float(bq), float(c)), float(t)


def fit_step_box(l, u, xmax, floor=-0.02, grid=4001):
    """min e = max|g-1| on [l,u] s.t. floor <= g <= 1+e on [0,xmax]."""
    Gb, Ga = _basis(np.linspace(l, u, grid)), _basis(np.linspace(0, xmax, grid))
    A = [np.hstack([Gb, -np.ones((grid, 1))]),
         np.hstack([-Gb, -np.ones((grid, 1))]),
         np.hstack([Ga, -np.ones((grid, 1))]),
         np.hstack([-Ga, np.zeros((grid, 1))])]
    b = [np.ones(grid), -np.ones(grid), np.ones(grid), np.full(grid, -floor)]
    a, bq, c, e = _lp(np.array([0.0, 0.0, 0.0, 1.0]), A, b,
                      [(None, None)] * 3 + [(0, None)])
    return (float(a), float(bq), float(c)), float(e)


def fit_bf16_schedule(l0: float = 3e-3, noise: float = 6e-3,
                      bootstrap_until: float = 0.25, max_bf16: int = 14):
    """Fit the two-phase bf16-safe schedule + the optional HIGHEST polish.

    Returns (schedule, polish): the schedule steps tolerate one-pass bf16
    products with per-step Hermitian projection and the final |M| products
    at HIGHEST; ``polish`` is an optional extra HIGHEST step -- it tightens the eigenvalue band below the bf16 noise
    floor, which only marginally improves |M| (the floor is the write-off
    of near-zero eigenvalues, not band width).
    """
    sched, l, u = [], l0, 1.0
    for _ in range(max_bf16):
        if l < bootstrap_until:
            coef, t = fit_step_grow(l, u, xmax=u * 1.02)
            l, u = t, 1.01 + noise
        else:
            coef, e = fit_step_box(l, u, xmax=u * 1.02)
            l, u = 1.0 - e - noise, 1.0 + e + noise
        sched.append(coef)
        if l >= 1.0 - 1.5 * noise:
            break
    polish, e = fit_step_box(l, u, xmax=u * 1.01)
    return sched, polish


def composed_errors(sched, l0: float = 1e-3):
    x = np.linspace(0.0, 1.0, 200001)
    p = x.copy()
    for a, b, c in sched:
        p = p * (a + b * p**2 + c * p**4)
    band = x >= l0
    return float(np.max(np.abs(p[band] - 1.0))), float(np.max(np.abs(x * (p - 1.0))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=7)
    ap.add_argument("--l0", type=float, default=1e-3)
    ap.add_argument("--bf16", action="store_true",
                    help="fit the two-phase box-constrained bf16 schedule")
    args = ap.parse_args(argv)

    polish = None
    if args.bf16:
        sched, polish = fit_bf16_schedule(l0=args.l0 if args.l0 != 1e-3 else 3e-3)
        name = "POLAR_BF16_SCHEDULE"
    else:
        sched, _ = fit_schedule(args.steps, args.l0)
        name = "POLAR_QUINTIC_SCHEDULE"
    band_err, weighted_err = composed_errors(sched, args.l0)
    print(f"# {len(sched)} steps, l0={args.l0:g}: |p-1| < {band_err:.2e} on "
          f"[{args.l0:g}, 1], max |x (p-1)| = {weighted_err:.2e} on [0, 1]")
    print(f"{name} = (")
    for a, b, c in sched:
        print(f"    ({a:.6f}, {b:.6f}, {c:.6f}),")
    print(")")
    if polish is not None:
        print(f"POLAR_BF16_POLISH = ({polish[0]:.6f}, {polish[1]:.6f}, "
              f"{polish[2]:.6f})")


if __name__ == "__main__":
    main()
