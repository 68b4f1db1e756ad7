"""Batched 2-D dual-polynomial spectrum evaluation.

The quantity searched is z(tau, f) = |<phi, a(tau, f)>|^2 with
a = kron(s(f), conj(d(tau))) (reference utils/peakSearchUtils.py:9-33).  The
reference evaluates it one grid point at a time through nested Python loops
(peakSearchUtils.py:37-60) -- the post-processing hot spot.

Formulation: because the atom is separable, the whole grid is a
2-D non-uniform DFT of conj(phi) reshaped to (Nb, Nd):

  <phi, a>(tau, f) = sum_m s(f)_m * sum_k conj(Phi[m, k]) * conj(d(tau))_k
                   = [ S(f) @ conj(Phi) @ conj(D(tau))^T ]

i.e. two small dense matmuls shared across the instance batch, with no
(grid x n) atom matrix ever materialized.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from admmnet_tpu.ops.atoms import delay_steering, doppler_steering


def spectrum_grid(phi: jnp.ndarray, taus, fs, Nb: int, Nd: int) -> jnp.ndarray:
    """Spectrum on the separable grid fs x taus.

    phi: (..., Nb*Nd) complex; taus: (nx,); fs: (ny,).
    Returns (..., ny, nx) real, indexed [doppler, delay] like the reference's
    meshgrid layout (peakSearchUtils.py:112-115).
    """
    Phi = jnp.conj(phi).reshape(*phi.shape[:-1], Nb, Nd)
    S = doppler_steering(jnp.asarray(fs), Nb)  # (ny, Nb)
    Dc = jnp.conj(delay_steering(jnp.asarray(taus), Nd))  # (nx, Nd)
    inner = jnp.einsum("ym,...mk,xk->...yx", S, Phi, Dc,
                       precision=jax.lax.Precision.HIGHEST)
    return jnp.abs(inner) ** 2


def spectrum_at(phi: jnp.ndarray, taus, fs, Nb: int, Nd: int) -> jnp.ndarray:
    """Spectrum at paired points: taus, fs of shape (..., P) broadcastable
    against phi's batch dims.  Returns (..., P) real.

    Used by the refinement stage where every peak has its own local grid.
    """
    Phi = jnp.conj(phi).reshape(*phi.shape[:-1], Nb, Nd)
    S = doppler_steering(jnp.asarray(fs), Nb)  # (..., P, Nb)
    Dc = jnp.conj(delay_steering(jnp.asarray(taus), Nd))  # (..., P, Nd)
    inner = jnp.einsum("...pm,...mk,...pk->...p", S, Phi, Dc,
                       precision=jax.lax.Precision.HIGHEST)
    return jnp.abs(inner) ** 2
