"""Matrix spectral filters as Chebyshev polynomials (matmul-only).

Motivation (a matmul-only form of the learned PSD step): the reference's
GLayer (admm_net.py:208-354) eigendecomposes the lifted matrix every layer to
apply a learned scalar filter f to the spectrum and rebuild ``V f(L) V^H``.
An eigendecomposition is a sequential, poorly batched primitive; but
``V f(L) V^H = f_mat(M)`` is a *matrix function*, and any continuous f on the
spectral interval is approximated by a Chebyshev expansion whose evaluation
(Clenshaw recurrence) is nothing but ``degree`` batched matrix products --
the same trick the polar PSD projection uses (ops/projections.py).

Pipeline per call (batched over leading dims):
1. bound the spectrum: r = ||M||_F >= rho(M); normalize Mh = M / r;
2. sample the learned filter at Chebyshev nodes of [-1, 1] mapped back to
   the real spectral domain: g_j = f(r * x_j) / r  (pointwise; the learned
   MLP evaluates on an (..., N) scalar grid -- negligible cost);
3. project samples onto Chebyshev coefficients with the fixed DCT-II matrix
   (exact discrete orthogonality, N samples -> N coefficients);
4. Clenshaw on matrices: b_k = c_k I + 2 Mh b_{k+1} - b_{k+2}, result
   c_0/2-corrected; ``degree`` complex 101x101 matmuls, Precision.HIGHEST.

Everything is differentiable -- gradients flow through the filter samples
into the learned threshold/MLP parameters AND through the matrix recurrence,
with no detached eigenvectors anywhere (the reference needs the detach only
because eigenvector derivatives are ill-conditioned; a polynomial has no
such pathology).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

import jax.numpy as jnp
from jax import lax

_HI = lax.Precision.HIGHEST


def chebyshev_nodes(n: int) -> np.ndarray:
    """First-kind Chebyshev nodes x_j = cos(pi (j + 1/2) / n), j = 0..n-1."""
    j = np.arange(n)
    return np.cos(np.pi * (j + 0.5) / n)


def coefficient_matrix(n: int) -> np.ndarray:
    """(n, n) matrix C with c = C @ g mapping samples at ``chebyshev_nodes``
    to Chebyshev coefficients (c_0 already halved for Clenshaw)."""
    j = np.arange(n)
    k = np.arange(n)[:, None]
    C = (2.0 / n) * np.cos(k * np.pi * (j + 0.5) / n)
    C[0] *= 0.5
    return C.astype(np.float32)


def apply_spectral_filter(
    M: jnp.ndarray,
    f: Callable[[jnp.ndarray], jnp.ndarray],
    degree: int = 48,
    precision=None,
) -> jnp.ndarray:
    """f_mat(M) for Hermitian (..., m, m) M and pointwise filter ``f``.

    ``f`` maps a real (..., n_nodes) array of eigenvalue locations to filter
    values (broadcast over the node axis).  ``degree`` = number of Chebyshev
    terms = number of matrix products.

    ``precision``: matmul precision for the Clenshaw recurrence (default
    HIGHEST).  Below HIGHEST (``lax.Precision.DEFAULT`` may run in TF32 on
    the GPU) the recurrence is kept on the Hermitian manifold by
    re-projecting each iterate -- without it the rounding noise's
    non-Hermitian component compounds through the 2*M*b1 doubling.
    """
    prec = _HI if precision is None else precision
    resym = prec != _HI
    m = M.shape[-1]
    r = jnp.sqrt(jnp.sum(jnp.abs(M) ** 2, axis=(-1, -2), keepdims=True))
    r = jnp.maximum(jnp.real(r), 1e-20)  # (..., 1, 1) spectral bound
    Mh = M / r.astype(M.dtype)

    x = jnp.asarray(chebyshev_nodes(degree))  # (K,)
    rr = r[..., 0, 0][..., None]  # (..., 1)
    g = f(rr * x) / rr  # (..., K) filter samples in normalized domain
    c = jnp.einsum("kj,...j->...k", jnp.asarray(coefficient_matrix(degree)), g)

    eye = jnp.eye(m, dtype=M.dtype)
    zero = jnp.zeros_like(M)

    def _herm(X):
        return 0.5 * (X + jnp.conj(jnp.swapaxes(X, -1, -2)))

    def clenshaw(carry, ck):
        b1, b2 = carry
        b0 = ck[..., None, None].astype(M.dtype) * eye + (
            2.0 * jnp.matmul(Mh, b1, precision=prec) - b2
        )
        if resym:
            b0 = _herm(b0)
        return (b0, b1), None

    # iterate k = K-1 .. 1; handle k = 0 with the single-M correction
    ck_rev = jnp.moveaxis(c[..., 1:], -1, 0)[::-1]  # (K-1, ...)
    (b1, b2), _ = lax.scan(clenshaw, (zero, zero), ck_rev)
    out = c[..., 0][..., None, None].astype(M.dtype) * eye + (
        jnp.matmul(Mh, b1, precision=prec) - b2
    )
    if resym:
        out = _herm(out)
    return (out * r.astype(M.dtype)).astype(M.dtype)
