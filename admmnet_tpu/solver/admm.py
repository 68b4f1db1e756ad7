"""Batched classical ANM-DUMV ADMM solver.

Functional target: reference admm.py:6-114 (``admm_for_us``), re-designed for
XLA instead of translated:

- the per-iteration cvxpy/ECOS solve of the H-subproblem (reference
  admm.py:82,117-148) becomes the exact vectorized projection
  ``ops.projections.project_sum_inf`` -- no Python<->C boundary in the loop;
- the per-iteration LAPACK SVD (reference admm.py:85,151-179) becomes a
  batched PSD step selectable via ``ADMMOptions.g_update`` (see
  core.config for why the reference's SVD step is actually the identity);
- the per-instance early ``break`` (reference admm.py:110-112) becomes a
  per-instance ``converged`` mask inside one ``lax.while_loop``: converged
  instances freeze (their state stops updating) while the rest keep
  iterating, and the loop exits when every instance in the batch converged
  or ``max_iter`` is reached;
- everything carries a leading batch dim; thousands of independent MN=100
  instances run as one XLA program (shard the batch axis over a mesh with
  ``parallel.sharding`` for multi-chip).

The iteration (reference admm.py:63-112), per active instance:

  phi   <- (D^-1 + rho I)^-1 (D_b^-1 y + rho g + zeta)        [diagonal]
  h     <- Proj_{A||h||_inf + sum(h) <= 1} Re diag(G_hat + Z_hat/rho)
  B     <- [[diag(h), phi], [phi^H, 1/lambda^2]]
  G     <- PSD-step(B - Z/rho)
  Z     <- Z + rho (G - B)

stopping after >= min_iter iterations (reference admm.py:95-96) when
  ||G - B||_F        <= eta_abs sqrt(n+1) + eta_rel max(||G||_F, ||B||_F)
  rho ||h - h_prev|| <= eta_abs sqrt(n)   + eta_rel ||Z||_F
(reference admm.py:98-112).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from admmnet_tpu.core.config import ADMMOptions
from admmnet_tpu.ops.atoms import COMPLEX
from admmnet_tpu.ops.linalg import (
    assemble_lifted,
    fro_norm,
    hermitianize,
    lifted_corner_vec,
    lifted_topleft,
    vec_norm,
)
from admmnet_tpu.ops.projections import (
    POLAR_BF16_SCHEDULE,
    project_sum_inf,
    psd_project_eigh,
    psd_project_newton_schulz,
    psd_project_polar,
)


class ADMMResult(NamedTuple):
    phi: jnp.ndarray  # (..., n) complex: dual polynomial coefficients
    iterations: jnp.ndarray  # (...,) int32: per-instance iterations used
    converged: jnp.ndarray  # (...,) bool
    r_pri: jnp.ndarray  # (...,) final primal residual
    r_dual: jnp.ndarray  # (...,) final dual residual


class _State(NamedTuple):
    phi: jnp.ndarray
    h: jnp.ndarray
    G: jnp.ndarray
    Z: jnp.ndarray
    it: jnp.ndarray  # scalar loop counter
    iterations: jnp.ndarray  # per-instance stop iteration
    converged: jnp.ndarray  # per-instance bool
    r_pri: jnp.ndarray
    r_dual: jnp.ndarray


def _phi_update_diag(y, b, g, zeta, rho):
    """Intended diagonal phi-update (matches learned PhiLayer,
    reference admm_net.py:94-103): elementwise
    (D^-1 + rho I)^-1 (y/b + rho g + zeta) with D = diag(|b|^2)."""
    b_sq = jnp.abs(b) ** 2
    weight = (b_sq / (1.0 + rho * b_sq)).astype(COMPLEX)
    return weight * (y / b + rho * g + zeta)


def _phi_update_ref_dense(y, b, g, zeta, rho):
    """Reference-compat phi-update reproducing the admm.py:78 broadcast:
    solves with D^-1 + rho*11^T (rank-one, NOT rho*I) via Sherman-Morrison:
    (D^-1 + rho 11^T)^-1 v = D v - rho (1^T D v) D1 / (1 + rho tr D)."""
    d = (jnp.abs(b) ** 2).astype(COMPLEX)
    v = y / b + rho * g + zeta
    dv = d * v
    corr = rho * jnp.sum(dv, axis=-1, keepdims=True) / (
        1.0 + rho * jnp.sum(d, axis=-1, keepdims=True)
    )
    return dv - corr * d


def _g_step(M, opts: ADMMOptions):
    if opts.g_update == "eigh":
        return psd_project_eigh(M)
    if opts.g_update == "polar":
        return psd_project_polar(M)
    if opts.g_update == "polar_fast":
        return psd_project_polar(M, schedule=POLAR_BF16_SCHEDULE)
    if opts.g_update == "newton_schulz":
        return psd_project_newton_schulz(M, opts.newton_schulz_iters)
    # "ref_identity": the reference's SVD step on a Hermitian matrix
    # reconstructs it exactly (admm.py:151-179); keep the symmetrization.
    return M


def _iteration(y, b, A, lam_inv_sq, state: _State, opts: ADMMOptions):
    n = y.shape[-1]
    rho = opts.rho

    g = lifted_corner_vec(state.G)
    zeta = lifted_corner_vec(state.Z)
    if opts.phi_update == "diag":
        phi = _phi_update_diag(y, b, g, zeta, rho)
    else:
        phi = _phi_update_ref_dense(y, b, g, zeta, rho)

    t = jnp.real(
        jnp.diagonal(lifted_topleft(state.G), axis1=-2, axis2=-1)
        + jnp.diagonal(lifted_topleft(state.Z), axis1=-2, axis2=-1) / rho
    )
    h = project_sum_inf(t, A)

    B = assemble_lifted(h, phi, lam_inv_sq)
    G = _g_step(hermitianize(B - state.Z / rho), opts)
    Z = state.Z + rho * (G - B)

    r_pri = fro_norm(G - B)
    eta_pri = opts.eta_abs * jnp.sqrt(n + 1.0) + opts.eta_rel * jnp.maximum(
        fro_norm(G), fro_norm(B)
    )
    r_dual = rho * vec_norm(h - state.h)
    eta_dual = opts.eta_abs * jnp.sqrt(float(n)) + opts.eta_rel * fro_norm(Z)

    return phi, h, G, Z, r_pri, eta_pri, r_dual, eta_dual


def _masked(mask, new, old):
    """Select new where instance is active; mask shape (...,) broadcast up."""
    extra = new.ndim - mask.ndim
    m = mask.reshape(mask.shape + (1,) * extra)
    return jnp.where(m, new, old)


def admm_solve(
    y: jnp.ndarray,
    b: jnp.ndarray,
    sigma: jnp.ndarray,
    lambda_val: float = 1.0,
    opts: ADMMOptions = ADMMOptions(),
) -> ADMMResult:
    """Solve batched ANM-DUMV instances; early-exits when all converge.

    y, b: (..., n) complex observations / demodulated symbols;
    sigma: (...,) noise-level bound; lambda_val: ANM weight (reference
    main.py:81-82).  Leading dims are the instance batch.
    """
    y = jnp.asarray(y, COMPLEX)
    b = jnp.asarray(b, COMPLEX)
    batch = y.shape[:-1]
    n = y.shape[-1]
    sigma = jnp.broadcast_to(jnp.asarray(sigma, jnp.float32), batch)
    A = 2.0 * jnp.sqrt(float(n)) * sigma + sigma**2  # reference admm.py:136
    lam_inv_sq = 1.0 / (lambda_val**2)

    state0 = _State(
        phi=jnp.zeros((*batch, n), COMPLEX),
        h=jnp.zeros((*batch, n), jnp.float32),
        G=jnp.zeros((*batch, n + 1, n + 1), COMPLEX),
        Z=jnp.zeros((*batch, n + 1, n + 1), COMPLEX),
        it=jnp.zeros((), jnp.int32),
        iterations=jnp.zeros(batch, jnp.int32),
        converged=jnp.zeros(batch, bool),
        r_pri=jnp.full(batch, jnp.inf, jnp.float32),
        r_dual=jnp.full(batch, jnp.inf, jnp.float32),
    )

    def cond(s: _State):
        return (s.it < opts.max_iter) & ~jnp.all(s.converged)

    def body(s: _State) -> _State:
        it = s.it + 1  # 1-based like the reference loop (admm.py:63)
        phi, h, G, Z, r_pri, eta_pri, r_dual, eta_dual = _iteration(
            y, b, A, lam_inv_sq, s, opts
        )
        active = ~s.converged
        min_ok = (
            (it >= opts.min_iter) if opts.use_min_iter else jnp.array(True)
        ) & (it > 1)
        newly = active & min_ok & (r_pri <= eta_pri) & (r_dual <= eta_dual)
        return _State(
            phi=_masked(active, phi, s.phi),
            h=_masked(active, h, s.h),
            G=_masked(active, G, s.G),
            Z=_masked(active, Z, s.Z),
            it=it,
            iterations=jnp.where(active, it, s.iterations),
            converged=s.converged | newly,
            r_pri=jnp.where(active, r_pri, s.r_pri),
            r_dual=jnp.where(active, r_dual, s.r_dual),
        )

    s = lax.while_loop(cond, body, state0)
    return ADMMResult(
        phi=s.phi,
        iterations=s.iterations,
        converged=s.converged,
        r_pri=s.r_pri,
        r_dual=s.r_dual,
    )


def admm_solve_fixed(
    y: jnp.ndarray,
    b: jnp.ndarray,
    sigma: jnp.ndarray,
    num_iters: int,
    lambda_val: float = 1.0,
    opts: Optional[ADMMOptions] = None,
) -> jnp.ndarray:
    """Run exactly ``num_iters`` iterations (no convergence checks) and
    return phi.  ``lax.scan``-based: fixed trip count, no residual norms, no
    host sync -- the throughput-benchmark and ADMM-Net-labelling workhorse.
    """
    opts = opts or ADMMOptions()
    y = jnp.asarray(y, COMPLEX)
    b = jnp.asarray(b, COMPLEX)
    batch = y.shape[:-1]
    n = y.shape[-1]

    sigma = jnp.broadcast_to(jnp.asarray(sigma, jnp.float32), batch)
    A = 2.0 * jnp.sqrt(float(n)) * sigma + sigma**2
    lam_inv_sq = 1.0 / (lambda_val**2)

    phi0 = jnp.zeros((*batch, n), COMPLEX)
    h0 = jnp.zeros((*batch, n), jnp.float32)
    G0 = jnp.zeros((*batch, n + 1, n + 1), COMPLEX)
    Z0 = jnp.zeros((*batch, n + 1, n + 1), COMPLEX)

    def step(carry, _):
        phi_c, h_c, G_c, Z_c = carry
        g = lifted_corner_vec(G_c)
        zeta = lifted_corner_vec(Z_c)
        if opts.phi_update == "diag":
            phi = _phi_update_diag(y, b, g, zeta, opts.rho)
        else:
            phi = _phi_update_ref_dense(y, b, g, zeta, opts.rho)
        t = jnp.real(
            jnp.diagonal(lifted_topleft(G_c), axis1=-2, axis2=-1)
            + jnp.diagonal(lifted_topleft(Z_c), axis1=-2, axis2=-1) / opts.rho
        )
        # named scopes let a profiler trace split an iteration by stage
        with jax.named_scope("h_projection"):
            h = project_sum_inf(t, A)
        B = assemble_lifted(h, phi, lam_inv_sq)
        with jax.named_scope("psd_projection"):
            G = _g_step(hermitianize(B - Z_c / opts.rho), opts)
        Z = Z_c + opts.rho * (G - B)
        return (phi, h, G, Z), None

    (phi, _, _, _), _ = lax.scan(step, (phi0, h0, G0, Z0), None, length=num_iters)
    return phi
