"""Vectorized Euclidean projections: the XLA replacements for the reference's
per-iteration native-solver calls.

- ``project_sum_inf``: exact projection onto {h real : A*||h||_inf + sum(h) <= 1},
  replacing the cvxpy/ECOS interior-point solve the reference runs EVERY ADMM
  iteration (reference admm.py:82,117-148).  Implemented as bisection on the
  dual scalar mu with an exact Newton-waterline prox inside -- pure vector
  ops, fully batched, no data-dependent shapes, VPU-friendly.

- ``psd_project_eigh``: projection onto the Hermitian PSD cone via
  eigendecomposition + eigenvalue clamp.  This is the *intended* G-update.
  NOTE: the reference's SVD-based G-update (admm.py:151-179) zeroes "negative
  singular values" of a Hermitian matrix -- singular values are |eigenvalues|,
  never negative, so that step is the identity map and the reference solver
  never actually projects onto the PSD cone.  We implement the real projection
  (which the learned GLayer also uses via eigh, reference admm_net.py:303-334)
  and provide the identity behavior separately as a ref-compat mode in the
  solver.

- ``psd_project_newton_schulz``: matmul-only approximation using the
  matrix-sign Newton-Schulz iteration: P(M) = (M + |M|)/2 with
  |M| = sign(M) @ M.  Batched complex matmuls only, unlike eigh's sequential
  sweeps; accuracy degrades smoothly for eigenvalues near zero, which ADMM
  tolerates.

Derivation of project_sum_inf (for the docstring-level record):
minimize 1/2||h-t||^2 s.t. f(h) <= 1 with f(h) = A*||h||_inf + 1^T h, A > 0.
If f(t) <= 1 return t.  Else the constraint is active; for dual mu >= 0 the
Lagrangian minimizer is h(mu) = prox_{mu*A*||.||_inf}(t - mu*1), and by Moreau
decomposition prox of the inf-norm is identity minus L1-ball projection:
h(mu) = v - P_{L1 <= mu*A}(v), v = t - mu*1.  f(h(mu)) is nonincreasing in mu
(dual monotonicity) and comparing h(mu) with the feasible point 0 gives
f(h(mu)) <= ||t||^2/(2*mu), so mu_hi = max(1, ||t||^2/2 + 1) brackets the root
f(h(mu)) = 1; bisect.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

# Precision note: on the GPU a float32 product at DEFAULT precision may run
# in TF32 (about 10 mantissa bits), and the large early coefficients of the
# sign schedules amplify that rounding noise from step to step.  Every
# numerically critical contraction below therefore pins HIGHEST (full f32);
# a cheaper tier must be gated per contract against the eigh solve first.
_HI = jax.lax.Precision.HIGHEST


def project_l1_ball(v: jnp.ndarray, radius: jnp.ndarray, iters: int = 32) -> jnp.ndarray:
    """Euclidean projection of real v (..., n) onto {x : ||x||_1 <= radius}.

    ``radius`` broadcasts over the leading dims, shape (...,) or scalar; must
    be >= 0.  Bisection on the soft-threshold tau: sum(relu(|v|-tau)) is
    continuous, strictly decreasing where positive, so ``iters`` halvings of
    [0, max|v|] locate tau to max|v| * 2^-iters.
    """
    v = jnp.asarray(v)
    radius = jnp.broadcast_to(jnp.asarray(radius, v.dtype), v.shape[:-1])[..., None]
    av = jnp.abs(v)
    l1 = jnp.sum(av, axis=-1, keepdims=True)
    inside = l1 <= radius
    lo = jnp.zeros_like(radius)
    hi = jnp.max(av, axis=-1, keepdims=True)

    def body(_, lohi):
        lo, hi = lohi
        tau = 0.5 * (lo + hi)
        s = jnp.sum(jnp.maximum(av - tau, 0.0), axis=-1, keepdims=True)
        too_big = s > radius
        return jnp.where(too_big, tau, lo), jnp.where(too_big, hi, tau)

    lo, hi = lax.fori_loop(0, iters, body, (lo, hi))
    tau = 0.5 * (lo + hi)
    # Rescale exactly onto the sphere to kill the residual bisection error:
    # the projection has the form sign(v)*max(|v|-tau,0) with L1 norm == radius.
    x = jnp.maximum(av - tau, 0.0)
    xs = jnp.sum(x, axis=-1, keepdims=True)
    x = x * jnp.where(xs > 0, radius / jnp.maximum(xs, 1e-30), 0.0)
    return jnp.where(inside, v, jnp.sign(v) * x)


def _prox_scaled_inf(v: jnp.ndarray, scale: jnp.ndarray, inner_iters: int) -> jnp.ndarray:
    """prox_{scale*||.||_inf}(v): clamp at the l1-waterline tau solving
    sum max(|v| - tau, 0) = scale (Moreau: prox = v - P_{L1<=scale}(v), and
    the l1-ball projection leaves exactly the clamp residual).

    tau is found by Newton from below: s(tau) is convex piecewise linear
    decreasing with slope -count(|v| > tau), so tau += (s - scale)/count
    increases monotonically to the EXACT root (validated ~1e-15 vs a
    100-step bisection oracle); ``inner_iters`` ~ 8 replaces the previous 32
    bisections -- this chain of small reductions runs every ADMM iteration,
    so its sequential-op count is the dispatch hot spot of the scan path
    (measured 2.5 ms/iteration at B=2048 with the 32x32 nested bisection).
    """
    scale = jnp.broadcast_to(jnp.asarray(scale, v.dtype), v.shape[:-1])[..., None]
    av = jnp.abs(v)
    n = v.shape[-1]
    total = jnp.sum(av, axis=-1, keepdims=True)
    tau = jnp.maximum(0.0, (total - scale) / n)

    def body(_, tau):
        s = jnp.sum(jnp.maximum(av - tau, 0.0), axis=-1, keepdims=True)
        cnt = jnp.maximum(
            jnp.sum((av > tau).astype(v.dtype), axis=-1, keepdims=True), 1.0
        )
        return tau + (s - scale) / cnt

    tau = lax.fori_loop(0, inner_iters, body, tau)
    # scale >= ||v||_1: the l1-projection returns v itself, so the prox is 0
    return jnp.where(total <= scale, 0.0, jnp.clip(v, -tau, tau))


def project_sum_inf(
    t: jnp.ndarray,
    A: jnp.ndarray,
    outer_iters: int = 32,
    inner_iters: int = 8,
) -> jnp.ndarray:
    """Exact projection of real t (..., n) onto {h : A*||h||_inf + sum(h) <= 1}.

    ``A`` is the constraint weight 2*sqrt(MN)*sigma + sigma^2 (reference
    admm.py:136); scalar or batched (...,).  See module docstring for the
    derivation.  Replaces cvxpy/ECOS (reference admm.py:117-148).
    """
    t = jnp.asarray(t)
    A = jnp.broadcast_to(jnp.asarray(A, t.dtype), t.shape[:-1])

    def f_of(h):
        return A * jnp.max(jnp.abs(h), axis=-1) + jnp.sum(h, axis=-1)

    feasible = f_of(t) <= 1.0

    def h_of(mu):  # mu: (...,)
        v = t - mu[..., None]
        return _prox_scaled_inf(v, mu * A, inner_iters)

    mu_hi0 = jnp.maximum(1.0, 0.5 * jnp.sum(t * t, axis=-1) + 1.0)
    lo = jnp.zeros_like(mu_hi0)

    def body(_, lohi):
        lo, hi = lohi
        mu = 0.5 * (lo + hi)
        still_violated = f_of(h_of(mu)) > 1.0
        return jnp.where(still_violated, mu, lo), jnp.where(still_violated, hi, mu)

    lo, hi = lax.fori_loop(0, outer_iters, body, (lo, mu_hi0))
    h = h_of(hi)  # hi is always feasible
    return jnp.where(feasible[..., None], t, h)


def hermitian_eigh(M: jnp.ndarray):
    """Batched eigendecomposition of (..., m, m) after Hermitian symmetrization."""
    Mh = 0.5 * (M + jnp.conj(jnp.swapaxes(M, -1, -2)))
    return jnp.linalg.eigh(Mh)


def psd_project_eigh(M: jnp.ndarray) -> jnp.ndarray:
    """Exact projection of Hermitian (..., m, m) onto the PSD cone."""
    w, V = hermitian_eigh(M)
    w = jnp.maximum(w, 0.0)
    return jnp.einsum(
        "...ij,...j,...kj->...ik", V, w.astype(M.dtype), jnp.conj(V),
        precision=_HI,
    )


def _matrix_abs_newton_schulz(M: jnp.ndarray, iters: int) -> jnp.ndarray:
    """|M| = U|Lambda|U^H for Hermitian M via Newton-Schulz matrix sign.

    Scale so spectrum lies in [-1, 1] (Frobenius bound), then iterate
    X <- 1.5*X - 0.5*X^3, which drives each eigenvalue lambda to sign(lambda)
    (cubic fixed-point, monotone on (0,1]).  Then |M| = sign(M) @ M restored
    to the original scale.  Eigenvalues ~0 map to ~0 smoothly.
    """
    m = M.shape[-1]
    normF = jnp.sqrt(
        jnp.sum(jnp.abs(M) ** 2, axis=(-1, -2), keepdims=True)
    ).astype(M.dtype)
    scale = jnp.maximum(jnp.real(normF), 1e-30).astype(M.dtype)
    X = M / scale

    def body(_, X):
        X2 = jnp.matmul(X, X, precision=_HI)
        return 1.5 * X - 0.5 * jnp.matmul(X, X2, precision=_HI)

    S = lax.fori_loop(0, iters, body, X)
    # symmetrized sign(M) @ M
    return (jnp.matmul(S, M, precision=_HI) + jnp.matmul(M, S, precision=_HI)) * 0.5


def psd_project_newton_schulz(M: jnp.ndarray, iters: int = 24) -> jnp.ndarray:
    """Approximate PSD projection P(M) ~ (M + |M|)/2, matmul-only."""
    absM = _matrix_abs_newton_schulz(M, iters)
    P = 0.5 * (M + absM)
    return 0.5 * (P + jnp.conj(jnp.swapaxes(P, -1, -2)))


# Greedy minimax quintic schedule for the matrix-sign function, fitted offline
# by per-step LP (Remez-style): step k applies p_k(x) = a x + b x^3 + c x^5,
# mapping the current eigenvalue band [l_k, u_k] onto [1-e_k, 1+e_k].
# Composed error: |p(x) - 1| < 1e-9 on [1e-3, 1] and the |M|-weighted error
# max |x (p(x)-1)| < 8e-5 on [0, 1].  3 matmuls/step x 7 steps = 21 matmuls,
# vs 48 for cubic Newton-Schulz at 24 iterations with WORSE (2e-5) error.
POLAR_QUINTIC_SCHEDULE = (
    (8.470329, -25.108079, 18.629279),
    (4.182834, -3.108701, 0.580607),
    (3.961857, -2.954063, 0.562976),
    (3.286584, -2.464719, 0.507358),
    (2.273748, -1.644659, 0.416191),
    (1.888716, -1.265157, 0.376519),
    (1.874984, -1.249968, 0.374983),
)

# Box-constrained two-phase schedule (fit_polar_schedule.fit_bf16_schedule),
# the detection-grade "polar_fast" path: steps 1-4 maximize guaranteed
# growth of the smallest eigenvalue inside the box 0 <= g <= ~1.01 on
# [0, 1.02u] (no overshoot anywhere, so low-precision rounding noise cannot
# escape), steps 5-6 are box-constrained minimax polish.  Exact arithmetic:
# |p-1| < 1e-5 on [3e-3, 1], p([0,1]) subset [0, ~1].  18 matmuls per
# projection vs the 7-step schedule's 21.
POLAR_BF16_SCHEDULE = (
    (4.203834, -11.937382, 8.504934),
    (4.101730, -11.104443, 7.628472),
    (3.953683, -10.006929, 6.734898),
    (3.400460, -6.548496, 3.994283),
    (2.316193, -2.250782, 0.931482),
    (1.858068, -1.215865, 0.357804),
)

# Polish step fitted to the post-noise band [1 - 1.5*noise, 1 + 1.5*noise]
# (the fitter's second output; appended only where a low-precision tier
# needs a full-precision final step).
POLAR_BF16_POLISH = (1.866601, -1.233157, 0.366556)


def _matrix_abs_polar(M: jnp.ndarray, schedule=POLAR_QUINTIC_SCHEDULE) -> jnp.ndarray:
    """|M| for Hermitian M via the fitted quintic sign schedule."""
    m = M.shape[-1]
    eye = jnp.eye(m, dtype=M.dtype)
    normF = jnp.sqrt(
        jnp.sum(jnp.abs(M) ** 2, axis=(-1, -2), keepdims=True)
    )
    scale = jnp.maximum(jnp.real(normF), 1e-30).astype(M.dtype)
    X = M / scale
    for a, b, c in schedule:
        X2 = jnp.matmul(X, X, precision=_HI)
        X4 = jnp.matmul(X2, X2, precision=_HI)
        X = jnp.matmul(X, a * eye + b * X2 + c * X4, precision=_HI)
    return (jnp.matmul(X, M, precision=_HI) + jnp.matmul(M, X, precision=_HI)) * 0.5


def psd_project_polar(M: jnp.ndarray, schedule=POLAR_QUINTIC_SCHEDULE) -> jnp.ndarray:
    """PSD projection via a minimax quintic sign schedule (matmul-only).

    ~2.3x fewer matmuls than cubic Newton-Schulz at much higher accuracy.
    The default 7-step schedule is the phi-exact contract (``g_update=
    "polar"``); ``POLAR_BF16_SCHEDULE`` is the detection-grade one
    (``"polar_fast"``).
    """
    absM = _matrix_abs_polar(M, schedule)
    P = 0.5 * (M + absM)
    return 0.5 * (P + jnp.conj(jnp.swapaxes(P, -1, -2)))
