"""Unrolled ADMM networks (reference admm_net.py:724-816).

``PhiEstADMMNet``: K layers of Phi -> H -> G -> Z, returns phi (the
trainPhi.py model).  ``ADMMNet``: same trunk + PeakSearchHead, returns
(tau_est, f_est, confidences, phi) (the train.py model).

Each depth has its own parameter set (the reference uses ModuleLists of
independent layers).  State G/Z initializes to complex zeros explicitly
(the reference relies on real->complex promotion, admm_net.py:753-755).

``learned_sensing`` adds an optional trainable measurement/calibration matrix
W applied to the observation (y' = y W^T as a complex matrix realized by two
real matmuls) -- the north-star's "trainable measurement matrix" config; the
reference has no such component (its trainPhi "Phi" is the OUTPUT dual
polynomial, see SURVEY.md 0.1), so it defaults off.
"""

from __future__ import annotations

from typing import Optional

import flax.linen as nn
import jax.numpy as jnp

from admmnet_tpu.core.config import ModelConfig
from admmnet_tpu.models.layers import GLayer, HLayer, PhiLayer, ZLayer
from admmnet_tpu.models.peak_head import PeakSearchHead, SpectrumPeakHead
from admmnet_tpu.ops.atoms import COMPLEX


class _SensingMatrix(nn.Module):
    dim: int

    @nn.compact
    def __call__(self, y):
        wr = self.param(
            "w_real",
            lambda key, shape, dtype=jnp.float32: jnp.eye(shape[0], dtype=dtype),
            (self.dim, self.dim),
        )
        wi = self.param(
            "w_imag", nn.initializers.zeros_init(), (self.dim, self.dim)
        )
        yr, yi = jnp.real(y), jnp.imag(y)
        out_r = yr @ wr.T - yi @ wi.T
        out_i = yr @ wi.T + yi @ wr.T
        return (out_r + 1j * out_i).astype(COMPLEX)


class _Trunk(nn.Module):
    cfg: ModelConfig

    @nn.compact
    def __call__(self, y, b, sigma):
        cfg = self.cfg
        n = cfg.spec.n
        batch = y.shape[:-1]

        if cfg.learned_sensing:
            y = _SensingMatrix(dim=n, name="sensing")(y)

        G = jnp.zeros((*batch, n + 1, n + 1), COMPLEX)
        Z = jnp.zeros((*batch, n + 1, n + 1), COMPLEX)
        phi = jnp.zeros((*batch, n), COMPLEX)
        for k in range(cfg.num_layers):
            phi = PhiLayer(epsilon=cfg.epsilon, name=f"phi_{k}")(y, b, G, Z)
            h = HLayer(
                dim=n,
                hidden=cfg.correction_hidden,
                epsilon=cfg.epsilon,
                name=f"h_{k}",
            )(phi, G, Z, sigma)
            G = GLayer(
                dim=n,
                value_hidden=cfg.value_net_hidden,
                epsilon=cfg.epsilon,
                ref_stop_gradients=cfg.ref_stop_gradients,
                mode=cfg.g_mode,
                cheb_degree=cfg.cheb_degree,
                cheb_precision=cfg.cheb_precision,
                name=f"g_{k}",
            )(phi, h, Z)
            Z = ZLayer(
                dim=n,
                scale_hidden=cfg.scale_net_hidden,
                epsilon=cfg.epsilon,
                ref_stop_gradients=cfg.ref_stop_gradients,
                name=f"z_{k}",
            )(phi, h, G, Z, k)
        return phi


class PhiEstADMMNet(nn.Module):
    """Trunk-only net regressing the dual polynomial phi
    (reference admm_net.py:724-764).

    ``ADMM_LR_MODULES`` declares which top-level submodules form the
    unrolled-ADMM parameter group that trains at ``admm_lr_scale * lr``.
    BOTH reference trainers scale that group by 0.5 (train.py:107-121 and
    trainPhi.py:105-113: ``{'params': admm_params, 'lr': config['lr']*0.5}``);
    for this model the trunk is every parameter, so phi training runs at an
    effective ``0.5 * lr`` -- exactly like the reference, where every
    PhiEstADMMNet param matches the phiLayers/hLayers/gLayers/zLayers
    prefixes.  Declared next to the ``name="trunk"`` binding so a rename
    updates both (the trainer raises if the declaration matches nothing).
    """

    ADMM_LR_MODULES = ("trunk",)

    cfg: ModelConfig

    @nn.compact
    def __call__(self, y, b, sigma, deterministic: bool = True):
        return _Trunk(cfg=self.cfg, name="trunk")(y, b, sigma)


class ADMMNet(nn.Module):
    """Full net: trunk + learned peak head (reference admm_net.py:767-816).

    ``cfg.head`` selects the head: "attention" (reference-parity direct
    regression) or "spectrum" (differentiable coarse-to-fine spectral
    search; see models/peak_head.py).

    ``ADMM_LR_MODULES``: the trunk trains at ``admm_lr_scale * lr``, the
    peak head at full lr (reference train.py:107-121); see PhiEstADMMNet.
    The optional learned-sensing matrix lives inside the trunk and shares
    its LR group (no referent: the reference has no sensing matrix)."""

    ADMM_LR_MODULES = ("trunk",)

    cfg: ModelConfig

    @nn.compact
    def __call__(self, y, b, sigma, deterministic: bool = True):
        cfg = self.cfg
        phi = _Trunk(cfg=cfg, name="trunk")(y, b, sigma)
        if cfg.head == "spectrum":
            head = SpectrumPeakHead(
                M=cfg.spec.Nb,
                N=cfg.spec.Nd,
                L_max=cfg.spec.L_max,
                grid_step=cfg.head_grid_step,
                refine_rounds=cfg.head_refine_rounds,
                refine_points=cfg.head_refine_points,
                reduce_factor=cfg.head_reduce_factor,
                name="peak_head",
            )
        else:
            head = PeakSearchHead(
                M=cfg.spec.Nb,
                N=cfg.spec.Nd,
                L_max=cfg.spec.L_max,
                hidden_dim=cfg.hidden_dim,
                num_heads=cfg.num_heads,
                name="peak_head",
            )
        tau_est, f_est, conf = head(phi, deterministic=deterministic)
        return tau_est, f_est, conf, phi
