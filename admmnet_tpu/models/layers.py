"""Unrolled-ADMM layer modules (flax.linen).

Functional parity targets are the reference's learned layers
(admm_net.py:71-491), with these deltas:

- layers pass the diagonal ``h`` VECTOR between stages instead of
  materializing the (n, n) diagonal matrix H (the reference embeds/extracts
  it every layer, admm_net.py:171,151-152);
- the GLayer eigenvalue MLP is applied to all eigenvalues in one batched
  Dense call instead of the reference's per-eigenvalue Python loop
  (admm_net.py:324-334);
- no ``.item()`` graph breaks; where the reference's ``.item()`` calls
  silently stop gradients (lambda in the block assembly at admm_net.py:271
  and :426, rho in the ZLayer feature at :458) the same stop-gradients are
  reproduced deliberately via ``lax.stop_gradient`` behind
  ``ref_stop_gradients`` (defaulted on for parity, ablatable);
- the eigenvector detach of the reference (admm_net.py:306) is likewise
  reproduced -- gradients flow through eigenvalues only, which is what keeps
  training stable without eigh's notoriously ill-conditioned vector
  derivatives.

All modules take/return batched arrays with a leading instance dim.
"""

from __future__ import annotations

import flax.linen as nn
import jax
import jax.numpy as jnp

from admmnet_tpu.ops.atoms import COMPLEX
from admmnet_tpu.ops.linalg import assemble_lifted, fro_norm, hermitianize
from admmnet_tpu.ops.projections import hermitian_eigh


def _softplus(x):
    return jax.nn.softplus(x)


class PhiLayer(nn.Module):
    """Closed-form phi-update with learned rho (reference admm_net.py:71-105)."""

    epsilon: float = 1e-8

    @nn.compact
    def __call__(self, y, b, G, Z):
        rho = _softplus(self.param("rho", nn.initializers.constant(1.0), ()))
        g = G[..., :-1, -1]
        zeta = Z[..., :-1, -1]
        b_sq = jnp.abs(b) ** 2 + self.epsilon
        weight = (b_sq / (1.0 + rho * b_sq)).astype(COMPLEX)
        return weight * (y / (b + self.epsilon) + rho * g + zeta)


class HLayer(nn.Module):
    """Learned diagonal-H update (reference admm_net.py:108-194).

    Target vector t = Re diag(G_hat + Z_hat/rho), additive MLP correction
    t + 0.1*tanh-MLP(t), then a soft radial projection toward
    {A*||h||_inf + sum(h) <= 1}: scale = min(1, sigmoid(w)/constraint).
    Returns the h VECTOR (..., n).
    """

    dim: int
    hidden: int = 64
    epsilon: float = 1e-8

    @nn.compact
    def __call__(self, phi, G, Z, sigma):
        n = self.dim
        rho = _softplus(self.param("rho", nn.initializers.constant(1.0), ()))
        proj_w = self.param("projection_weight", nn.initializers.constant(1.0), ())

        T = G[..., :n, :n] + Z[..., :n, :n] / (rho + self.epsilon)
        t = jnp.real(jnp.diagonal(T, axis1=-2, axis2=-1))

        A = 2.0 * jnp.sqrt(float(n)) * sigma + sigma**2  # (...,)

        corr = nn.Dense(self.hidden, name="correction_hidden")(t)
        corr = nn.relu(corr)
        corr = nn.Dense(n, name="correction_out")(corr)
        corr = jnp.tanh(corr)
        t_c = t + 0.1 * corr

        l_inf = jnp.max(jnp.abs(t_c), axis=-1)
        trace = jnp.sum(t_c, axis=-1)
        constraint = A * l_inf + trace
        scale = jax.nn.sigmoid(proj_w) / (constraint + self.epsilon)
        scale = jnp.clip(scale, max=1.0)
        return t_c * scale[..., None]


class GLayer(nn.Module):
    """Learned PSD step (reference admm_net.py:208-354): build the lifted
    block matrix, apply a learned spectral filter
    softplus(w - sigmoid(thr)) * value_net(|w|) to the spectrum, rebuild.

    Two evaluation modes (same parameters, swappable per config):

    - ``"eigh"`` (reference-parity default): Hermitian eigh with detached
      eigenvectors (reference admm_net.py:306), filter on eigenvalues,
      U diag(w') U^H rebuild;
    - ``"chebyshev"`` (matmul-only): the identical learned filter applied as a
      matmul-only matrix function via ops.chebyshev.apply_spectral_filter
      -- no eigendecomposition anywhere, fully differentiable (no detach
      needed: polynomials have no eigenvector-derivative pathology).
    """

    dim: int  # n = M*N; lifted side is n+1
    value_hidden: int = 16
    epsilon: float = 1e-8
    learnable_threshold: bool = True
    ref_stop_gradients: bool = True
    mode: str = "eigh"  # "eigh" | "chebyshev"
    cheb_degree: int = 48
    cheb_precision: str = "highest"  # "highest" | "default" (TF32 on GPU)

    @nn.compact
    def __call__(self, phi, h, Z):
        lam = _softplus(self.param("lambda", nn.initializers.constant(0.1), ()))
        rho = _softplus(self.param("rho", nn.initializers.constant(1.0), ()))
        lam_inv = 1.0 / (lam**2 + self.epsilon)
        if self.ref_stop_gradients:
            # reference: lambda_inv.item() at admm_net.py:271 cuts the graph
            lam_inv = jax.lax.stop_gradient(lam_inv)
        if self.learnable_threshold:
            thr = jax.nn.sigmoid(
                self.param("threshold", nn.initializers.constant(0.0), ())
            )
        else:
            thr = 0.5  # sigmoid(0), matching the non-learnable default

        value_hidden = nn.Dense(self.value_hidden, name="value_hidden")
        value_out = nn.Dense(1, name="value_out")

        def spectral_filter(w):
            """softplus(w - thr) * sigmoid(MLP(|w|)), pointwise on (..., k)."""
            base = _softplus(w - thr)
            s = value_hidden(jnp.abs(w)[..., None])
            s = nn.relu(s)
            s = jax.nn.sigmoid(value_out(s))[..., 0]
            return base * s

        B = assemble_lifted(h, phi, lam_inv)
        M = B - Z / (rho + self.epsilon)

        if self.mode == "chebyshev":
            from admmnet_tpu.ops.chebyshev import apply_spectral_filter

            G = apply_spectral_filter(
                hermitianize(M), spectral_filter, self.cheb_degree,
                precision=(
                    jax.lax.Precision.DEFAULT
                    if self.cheb_precision == "default" else None
                ),
            )
            return hermitianize(G)

        w, V = hermitian_eigh(M)
        V = jax.lax.stop_gradient(V)  # reference admm_net.py:306
        w_new = spectral_filter(w).astype(COMPLEX)
        G = jnp.einsum("...ij,...j,...kj->...ik", V, w_new, jnp.conj(V),
                       precision=jax.lax.Precision.HIGHEST)
        return hermitianize(G)


class ZLayer(nn.Module):
    """Dual ascent with learned adaptive step (reference admm_net.py:357-474).

    step = softplus(rho) * scale, scale in [0.5, 2] from an MLP on
    [k/10, rho, ||R||/mean_batch(||R||)].  NOTE the mean couples instances
    across the batch exactly as the reference does (admm_net.py:459) -- a
    batch-statistic at inference time, reproduced for parity.
    """

    dim: int
    scale_hidden: int = 32
    epsilon: float = 1e-8
    ref_stop_gradients: bool = True

    @nn.compact
    def __call__(self, phi, h, G, Z_prev, k: int):
        lam = _softplus(self.param("lambda", nn.initializers.constant(1.0), ()))
        rho = _softplus(self.param("rho", nn.initializers.constant(1.0), ()))
        lam_inv = 1.0 / (lam**2 + self.epsilon)
        if self.ref_stop_gradients:
            lam_inv = jax.lax.stop_gradient(lam_inv)  # .item() at :426

        B = assemble_lifted(h, phi, lam_inv)
        R = G - B

        res_norm = fro_norm(R)
        k_feat = jnp.full_like(res_norm, k / 10.0)
        rho_feat = jnp.broadcast_to(rho, res_norm.shape)
        if self.ref_stop_gradients:
            rho_feat = jax.lax.stop_gradient(rho_feat)  # .item() at :458
        res_feat = res_norm / (jnp.mean(res_norm) + self.epsilon)
        feats = jnp.stack([k_feat, rho_feat, res_feat], axis=-1)

        s = nn.Dense(self.scale_hidden, name="scale_hidden")(feats)
        s = nn.relu(s)
        s = nn.Dense(1, name="scale_out")(s)
        s = jax.nn.sigmoid(s)[..., 0]
        scale = 0.5 + 1.5 * s

        step = (rho * scale).astype(COMPLEX)
        return Z_prev + step[..., None, None] * R
