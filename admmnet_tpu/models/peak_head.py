"""Learned peak-search heads for the end-to-end ADMMNet.

``PeakSearchHead`` (reference admm_net.py:494-630): phi -> [Re, Im] feature
MLP -> cross-attention query against a learnable (tau, f) positional grid ->
per-target regression heads: tau in [0,1] (sigmoid), f in [-0.5, 0.5]
(tanh/2 -- see note), shared confidence head.

NOTE: the reference's f_regressor ends in Tanh, whose range is (-1, 1), even
though the comment says f in [-0.5, 0.5] (admm_net.py:540-547).  We keep the
reference's actual behavior (plain tanh) for parity; the training data keeps
f in (-0.4, 0.4) so both parameterizations cover it.

``SpectrumPeakHead`` (extension, no exact reference analog): a differentiable
version of the classical coarse-to-fine peak search (peaks/search.py).  The
reference sketches this idea in dead code (admm_net.py:632-720,
``differentiable_spectrum``/``peak_refinement``, never called); its shipped
attention head regresses (tau, f) directly from phi and localizes coarsely
(far below phi-regression + classical search on position-matched F1).  This head instead evaluates the dual-polynomial
spectrum |<phi, a(tau,f)>|^2 on a coarse separable-matmul grid (batched matmuls,
peaks/spectrum.py), takes the top-L_max local maxima (hard argmax,
stop-gradient -- cell choice is discrete), zooms with hard argmax rounds,
and finishes with a soft-argmax over the final window (learnable
temperature) so position gradients flow into phi and the trunk.  Confidence
comes from a tiny MLP on scale-invariant peak statistics.
"""

from __future__ import annotations

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np


def _grid_init(M: int, N: int):
    tau_grid = np.linspace(0.0, 1.0, M)
    f_grid = np.linspace(-0.5, 0.5, N)
    tg, fg = np.meshgrid(tau_grid, f_grid, indexing="ij")
    enc = np.stack([tg.ravel(), fg.ravel()], axis=1).astype(np.float32)

    def init(key, shape, dtype=jnp.float32):
        assert shape == enc.shape, (shape, enc.shape)
        return jnp.asarray(enc, dtype)

    return init


class PeakSearchHead(nn.Module):
    M: int
    N: int
    L_max: int = 3
    hidden_dim: int = 128
    num_heads: int = 4
    dropout: float = 0.1

    @nn.compact
    def __call__(self, phi, deterministic: bool = True):
        n = self.M * self.N
        x = jnp.concatenate([jnp.real(phi), jnp.imag(phi)], axis=-1)

        # 1. feature extraction
        x = nn.relu(nn.Dense(self.hidden_dim, name="feat1")(x))
        x = nn.relu(nn.Dense(self.hidden_dim, name="feat2")(x))

        # 2. learnable positional grid, projected
        pos = self.param("position_grid", _grid_init(self.M, self.N), (n, 2))
        pos = nn.Dense(self.hidden_dim, name="position_projection")(pos)
        pos = jnp.broadcast_to(pos, (*x.shape[:-1], n, self.hidden_dim))

        # 3. cross-attention: single query = features, keys/values = grid
        attended = nn.MultiHeadDotProductAttention(
            num_heads=self.num_heads,
            dropout_rate=self.dropout,
            name="attention",
        )(
            inputs_q=x[..., None, :],
            inputs_kv=pos,
            deterministic=deterministic,
        )
        x = x + attended[..., 0, :]

        # 4. peak feature funnel
        for i, w in enumerate(
            (self.hidden_dim // 2, self.hidden_dim // 4, self.hidden_dim // 8)
        ):
            x = nn.relu(nn.Dense(w, name=f"peak{i}")(x))

        # 5. per-target heads with query offset t/L (reference admm_net.py:613-623)
        taus, fs, confs = [], [], []
        conf_h = nn.Dense(16, name="conf_hidden")
        conf_o = nn.Dense(1, name="conf_out")
        for t in range(self.L_max):
            feat = x + t / self.L_max
            th = nn.relu(nn.Dense(32, name=f"tau{t}_hidden")(feat))
            taus.append(nn.sigmoid(nn.Dense(1, name=f"tau{t}_out")(th)))
            fh = nn.relu(nn.Dense(32, name=f"f{t}_hidden")(feat))
            fs.append(jnp.tanh(nn.Dense(1, name=f"f{t}_out")(fh)))
            ch = nn.relu(conf_h(feat))
            confs.append(nn.sigmoid(conf_o(ch)))
        tau_est = jnp.concatenate(taus, axis=-1)
        f_est = jnp.concatenate(fs, axis=-1)
        conf = jnp.concatenate(confs, axis=-1)
        return tau_est, f_est, conf


class SpectrumPeakHead(nn.Module):
    """Differentiable coarse-to-fine spectral peak search (see module doc).

    M = Nb (doppler symbol count), N = Nd (delay subcarrier count); the
    spectrum convention matches peaks/spectrum.py ([doppler, delay] grid).
    """

    M: int
    N: int
    L_max: int = 3
    grid_step: float = 0.01
    refine_rounds: int = 3
    refine_points: int = 11
    reduce_factor: float = 0.2
    conf_hidden: int = 16

    @nn.compact
    def __call__(self, phi, deterministic: bool = True):
        from admmnet_tpu.ops.atoms import delay_steering, doppler_steering
        from admmnet_tpu.peaks.search import _local_max_mask
        from admmnet_tpu.peaks.spectrum import spectrum_grid

        n = self.M * self.N
        batch_shape = phi.shape[:-1]
        phi2 = phi.reshape(-1, n)
        B = phi2.shape[0]
        K = self.L_max
        P = self.refine_points

        # 1. coarse spectrum on the separable grid (two small matmuls)
        taus_ax = np.arange(0.0, 1.0, self.grid_step, dtype=np.float32)
        if taus_ax.size and abs((taus_ax[-1]) % 1.0) < 1e-9:
            taus_ax = taus_ax[:-1]  # drop the tau=1 alias of tau=0
        fs_ax = np.arange(-0.5, 0.5, self.grid_step, dtype=np.float32)
        nx, ny = taus_ax.size, fs_ax.size
        Z = spectrum_grid(phi2, taus_ax, fs_ax, self.M, self.N)  # (B, ny, nx)

        # 2. top-K local maxima; non-local-max cells are demoted (not -inf)
        # so top_k always yields K usable cells even on near-flat spectra
        zmax = jnp.max(Z, axis=(-2, -1), keepdims=True)
        mask = _local_max_mask(Z)
        scores = jnp.where(mask, Z, Z - 2.0 * zmax).reshape(B, ny * nx)
        _, idx = jax.lax.top_k(scores, K)
        tau = jax.lax.stop_gradient(jnp.asarray(taus_ax)[idx % nx])  # (B, K)
        f = jax.lax.stop_gradient(jnp.asarray(fs_ax)[idx // nx])

        # 3. zoom: hard-argmax rounds, then a soft-argmax finish whose
        # softmax weights carry position gradients into phi
        beta = self.param(
            "softargmax_beta",
            lambda key, shape: jnp.full(shape, 25.0, jnp.float32),
            (),
        )
        Phi = jnp.conj(phi2).reshape(B, self.M, self.N)
        rel = jnp.linspace(-1.0, 1.0, P, dtype=jnp.float32)
        half_t = half_f = self.grid_step
        height = None
        for r in range(self.refine_rounds):
            taus = jnp.clip(tau[..., None] + half_t * rel, 0.0, 1.0 - 1e-6)
            fs = jnp.clip(f[..., None] + half_f * rel, -0.5, 0.5 - 1e-6)
            S = doppler_steering(fs, self.M)  # (B, K, P, M)
            Dc = jnp.conj(delay_steering(taus, self.N))  # (B, K, P, N)
            Zl = (
                jnp.abs(
                    jnp.einsum(
                        "bzpm,bmk,bzqk->bzpq", S, Phi, Dc,
                        precision=jax.lax.Precision.HIGHEST,
                    )
                )
                ** 2
            )  # (B, K, P[f], P[tau])
            flat = Zl.reshape(B, K, P * P)
            if r < self.refine_rounds - 1:
                i = jnp.argmax(flat, axis=-1)
                f = jnp.take_along_axis(fs, i[..., None] // P, axis=-1)[..., 0]
                tau = jnp.take_along_axis(taus, i[..., None] % P, axis=-1)[..., 0]
            else:
                norm = jax.lax.stop_gradient(
                    jnp.max(flat, axis=-1, keepdims=True)
                )
                w = jax.nn.softmax(
                    nn.softplus(beta) * flat / (norm + 1e-20), axis=-1
                )  # (B, K, P*P)
                wg = w.reshape(B, K, P, P)
                f = jnp.sum(jnp.sum(wg, axis=-1) * fs, axis=-1)
                tau = jnp.sum(jnp.sum(wg, axis=-2) * taus, axis=-1)
                height = jnp.sum(w * flat, axis=-1)  # (B, K)
            half_t *= self.reduce_factor
            half_f *= self.reduce_factor

        # 4. confidence from scale-invariant peak statistics:
        # z <= ||phi||^2 * n (Cauchy-Schwarz), so h/(e*n) in [0, 1]
        e = jnp.sum(jnp.abs(phi2) ** 2, axis=-1, keepdims=True)  # (B, 1)
        h_rel = height / (e * n + 1e-20)
        h_top = height / (height[..., :1] + 1e-20)
        rank = jnp.broadcast_to(
            jnp.arange(K, dtype=jnp.float32) / K, height.shape
        )
        feats = jnp.stack([h_rel, jnp.sqrt(h_rel + 1e-20), h_top, rank], -1)
        ch = nn.relu(nn.Dense(self.conf_hidden, name="conf_hidden")(feats))
        conf = nn.sigmoid(nn.Dense(1, name="conf_out")(ch))[..., 0]

        return (
            tau.reshape(*batch_shape, K),
            f.reshape(*batch_shape, K),
            conf.reshape(*batch_shape, K),
        )
