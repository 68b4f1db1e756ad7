"""Typed configuration for the framework.

The reference keeps every knob in hardcoded dict literals (reference
train.py:17-39, admm.py:36-45, utils/peakSearchUtils.py:84-93).  Here the same
knob set is preserved as frozen dataclasses so configs are hashable (usable as
jit static args), serializable, and CLI-overridable.

Axis-naming convention (kills the xbase/ybase swap class of bug in the
reference, see reference main.py:95 vs main.py:103-105):

- ``delay`` axis: tau in [0, 1), resolved by the ``Nd`` within-block symbol
  axis; atom factor ``d(tau) = exp(2j pi tau * [0..Nd-1])``.
- ``doppler`` axis: f in [-0.5, 0.5), resolved by the ``Nb`` OFDM-block axis;
  atom factor ``s(f) = exp(2j pi f * [0..Nb-1])``.
- flattened atom: ``a(tau, f) = kron(s(f), conj(d(tau)))`` with layout index
  ``m * Nd + k`` (m = block, k = symbol), matching the reference's
  ``kr(S, conj(D))`` column layout (reference main.py:29,
  utils/peakSearchUtils.py:27-31).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """Dimensions of one recovery instance (reference main.py:11-17)."""

    Nb: int = 10  # number of OFDM blocks (doppler axis length)
    Nd: int = 10  # data symbols per block (delay axis length)
    L_max: int = 3  # maximum number of targets

    @property
    def n(self) -> int:
        """Flattened problem size MN = Nb * Nd."""
        return self.Nb * self.Nd

    @property
    def lifted(self) -> int:
        """Side of the lifted PSD matrix G: MN + 1 (reference admm.py:54)."""
        return self.n + 1


G_UPDATES = ("eigh", "polar", "polar_fast", "newton_schulz", "ref_identity")


@dataclasses.dataclass(frozen=True)
class ADMMOptions:
    """Classical-solver knobs (reference admm.py:6,36-45).

    ``phi_update`` selects between the intended diagonal phi-update
    (what the learned PhiLayer implements, reference admm_net.py:94-103) and
    ``"ref_dense"`` which reproduces the reference's broadcasting quirk at
    admm.py:78 where ``inv(diag(|b|^2)) + rho*ones(n)`` adds rho to every
    matrix entry, i.e. solves with ``D^{-1} + rho*11^T`` instead of
    ``D^{-1} + rho*I`` (handled closed-form via Sherman-Morrison here).

    ``g_update`` selects the PSD step, one per contract:

    - ``"eigh"``: the true projection onto the PSD cone (eigendecompose,
      clamp negative eigenvalues; what the learned GLayer does, reference
      admm_net.py:303-334);
    - ``"polar"``: the phi-exact matmul-only path, the 7-step minimax quintic
      matrix-sign schedule (ops.projections.POLAR_QUINTIC_SCHEDULE); phi NMSE
      vs the eigh solve <= 1e-5 is the contract ``label_phi`` serves;
    - ``"polar_fast"``: the detection-grade path, the 6-step box-constrained
      schedule (ops.projections.POLAR_BF16_SCHEDULE);
    - ``"newton_schulz"``: the cubic matrix-sign iteration (an ablation);
    - ``"ref_identity"``: the reference's admm.py:151-179 SVD step, which on
      a Hermitian input is the identity map (singular values of a Hermitian
      matrix are |eigenvalues|, so zeroing negatives is a no-op).
    """

    rho: float = 1.0
    max_iter: int = 100
    eta_abs: float = 1e-7
    eta_rel: float = 1e-7
    use_min_iter: bool = True
    min_iter: int = 5
    phi_update: str = "diag"  # "diag" | "ref_dense"
    g_update: str = "eigh"  # one of G_UPDATES
    newton_schulz_iters: int = 24

    def __post_init__(self):
        if self.phi_update not in ("diag", "ref_dense"):
            raise ValueError(f"unknown phi_update {self.phi_update!r}")
        if self.g_update not in G_UPDATES:
            raise ValueError(
                f"unknown g_update {self.g_update!r}; expected one of "
                f"{G_UPDATES}"
            )


@dataclasses.dataclass(frozen=True)
class PeakSearchConfig:
    """Coarse-to-fine 2-D spectral peak search knobs.

    Mirrors reference utils/peakSearchUtils.py:84-93 defaults.  ``max_peaks``
    is new: the batched search returns a fixed number of candidate peaks
    (sorted by height, padded with -inf) instead of a data-dependent count.

    The refinement here zooms properly: round r scans a ``refine_points``^2
    window spanning +-step_{r-1} at spacing step_r = reducefactor * step_{r-1}
    around the current estimate.  (The reference's window at
    peakSearchUtils.py:142-145 only spans +-step_r -- a tenth of the coarse
    cell -- so its refinement cannot leave the coarse grid cell; ours strictly
    dominates it in accuracy.)
    """

    delay_min: float = 0.0
    delay_max: float = 1.0
    delay_step: float = 0.01
    doppler_min: float = -0.5
    doppler_max: float = 0.5
    doppler_step: float = 0.01
    reduce_factor: float = 0.1
    refine_iters: int = 3
    refine_points: int = 11  # points per axis per refinement round
    max_peaks: int = 16
    # Matmul precision of the refine einsums ("highest" | "default").  They
    # are tiny per-peak contractions whose result only has to preserve an
    # 11x11 argmax, so "default" (TF32 on the GPU) is gated, not assumed:
    # PRODUCTION_PEAKS below is re-checked against the eigh control by
    # chip_smoke.py and bench.py.
    refine_precision: str = "highest"

    def __post_init__(self):
        if self.refine_precision not in ("highest", "default"):
            raise ValueError(
                f"unknown refine_precision {self.refine_precision!r}"
            )
        # zoom-coverage invariant (class docstring): each round's span must
        # cover the previous round's quantization error
        if self.refine_points < 1.0 / self.reduce_factor + 1.0 - 1e-9:
            raise ValueError(
                f"refine_points {self.refine_points} < 1/reduce_factor + 1 "
                f"({1.0 / self.reduce_factor + 1.0:g}): the refinement zoom "
                "cannot cover the previous round's quantization error"
            )


# Gated deployment point of the classical pipeline (``main_classical
# --deploy``):
#
# - DETECTION_BUDGET_ITERS: fixed solve budget for detection-only
#   deployments.  Detection on the random-SNR scenes (SNR 5-25 dB) saturates
#   near the matched-filter initialization, so the budget is set by a
#   convergence criterion instead: 10 is where every anchor instance's
#   residuals cross eta=5e-2, the smallest budget that is a *solve* and not
#   just a periodogram.  NOT for phi-faithful work (phi at 10 iterations is
#   far from the fixed point; use the full budget with polar or eigh).
# - PRODUCTION_PEAKS: 2 refine rounds (final quantization ~6e-5, far below
#   the solver's tau error) at "default" refine precision.
#
# Both are gated on the card: the deploy F1 on 512 random-SNR scenes must be
# within 0.005 of the 100-iteration eigh control (chip_smoke.py, bench.py).
DETECTION_BUDGET_ITERS = 10

PRODUCTION_PEAKS = PeakSearchConfig(
    max_peaks=8, refine_iters=2, refine_precision="default"
)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Synthetic OFDM-ISAC dataset knobs (reference generate_data.py:15-44)."""

    spec: ProblemSpec = ProblemSpec()
    tau_range: Tuple[float, float] = (0.1, 0.9)
    f_range: Tuple[float, float] = (-0.4, 0.4)
    gain_std: float = 0.7  # complex reflection coeff ~ N(0, 0.7^2) per part
    snr_range: Tuple[float, float] = (5.0, 25.0)  # environment SNR_w in dB
    snr_demod: float = 7.0  # demodulation SNR_e in dB
    psk_order: int = 4  # QPSK
    train_ratio: float = 0.7
    val_ratio: float = 0.15


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Unrolled ADMM-Net architecture (reference admm_net.py:724-816)."""

    spec: ProblemSpec = ProblemSpec()
    num_layers: int = 10
    hidden_dim: int = 128
    num_heads: int = 4
    correction_hidden: int = 64  # HLayer MLP width (reference admm_net.py:127)
    value_net_hidden: int = 16  # GLayer eigenvalue MLP (reference admm_net.py:230)
    scale_net_hidden: int = 32  # ZLayer step MLP (reference admm_net.py:373)
    with_peak_head: bool = True
    epsilon: float = 1e-8
    # Reproduce the reference's accidental stop-gradients (.item() calls at
    # admm_net.py:271,426,458 and the eigenvector detach at :306).  Kept as a
    # flag so the effect can be ablated.
    ref_stop_gradients: bool = True
    # Optional learned sensing/measurement matrix (north-star config #5).
    # NOTE: the reference's "Phi" in trainPhi.py is the *output* dual
    # polynomial, not a measurement matrix (see SURVEY.md section 0.1); this
    # option is an extension, off by default.
    learned_sensing: bool = False
    # GLayer spectral-filter evaluation: "eigh" (reference parity: eigh with
    # detached eigenvectors) or "chebyshev" (matmul-only matrix function,
    # no eigendecomposition -- see ops/chebyshev.py).
    g_mode: str = "eigh"
    cheb_degree: int = 48
    # Clenshaw matmul precision for g_mode="chebyshev": "highest" (full f32)
    # or "default" (TF32 on the GPU, plus a per-step Hermitian re-projection;
    # quality-gate before deploying)
    cheb_precision: str = "highest"
    # Peak head for the e2e ADMMNet: "attention" (reference parity,
    # admm_net.py:494-630: direct (tau, f) regression) or "spectrum"
    # (extension: differentiable coarse-to-fine spectral search with a
    # soft-argmax finish -- see models/peak_head.py SpectrumPeakHead).
    head: str = "attention"
    head_grid_step: float = 0.01
    head_refine_rounds: int = 3
    head_refine_points: int = 11
    head_reduce_factor: float = 0.2

    def __post_init__(self):
        # GLayer dispatches on string equality, so a typo must raise here
        # rather than silently select another evaluation path.
        if self.g_mode not in ("eigh", "chebyshev"):
            raise ValueError(f"unknown g_mode {self.g_mode!r}")
        if self.cheb_precision not in ("highest", "default"):
            raise ValueError(f"unknown cheb_precision {self.cheb_precision!r}")
        if self.head not in ("attention", "spectrum"):
            raise ValueError(f"unknown head {self.head!r}")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-driver knobs (reference train.py:17-39, trainPhi.py:16-38)."""

    batch_size: int = 256
    epochs: int = 100
    lr: float = 1e-3
    admm_lr_scale: float = 0.5  # ADMM-layer params at 0.5x lr (train.py:107-113)
    weight_decay: float = 1e-3
    grad_clip: float = 1.0
    # CosineAnnealingWarmRestarts(T_0=10, T_mult=2, eta_min=1e-6), train.py:126-128
    sgdr_t0: int = 10
    sgdr_t_mult: int = 2
    lr_min: float = 1e-6
    patience: int = 10  # early stop (train.py:133)
    conf_threshold: float = 0.5  # detection threshold for F1 (train.py:384)
    # e2e loss target assignment: "slot" (reference parity) or "perm"
    # (permutation-invariant set matching; see train/losses.py)
    assignment: str = "slot"
    # weight of the spectral contrast term (train/losses.py
    # spectral_contrast_loss); needed to train the trunk under the spectrum
    # peak head, whose argmax positions carry no cross-cell gradient
    spectral_weight: float = 0.0
    # On resume, forget the checkpoint's best_val_loss/patience (keep params
    # + epoch).  Needed for curriculum stage switches: losses are not
    # comparable across datasets, so a harder stage would otherwise never
    # checkpoint and early-stop against the easier stage's best (measured:
    # the round-3 from-scratch SNR-curriculum run runs/spec50k).
    reset_best: bool = False
    seed: int = 0


def to_json(cfg: Any) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2)


def _from_dict(cls, d: Dict[str, Any]):
    # Unknown keys are skipped so that configs written by older versions
    # (e.g. with the retired ``cheb_impl``/``cheb_kblk`` fields) still load.
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in fields:
            continue
        ft = fields[k].type
        if isinstance(v, dict) and "Nb" in v:
            v = ProblemSpec(**v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[k] = v
    return cls(**kwargs)


def from_json(cls, s: str):
    return _from_dict(cls, json.loads(s))
