"""Minimax quintic polar PSD projection: accuracy vs exact eigh."""

import numpy as np
import jax.numpy as jnp

from admmnet_tpu.core.config import ADMMOptions
from admmnet_tpu.data.anchor import make_anchor_batch
from admmnet_tpu.ops.projections import (
    POLAR_QUINTIC_SCHEDULE,
    psd_project_eigh,
    psd_project_polar,
)
from admmnet_tpu.peaks import scale_invariant_nmse
from admmnet_tpu.solver import admm_solve_fixed


def test_polar_schedule_sign_accuracy():
    """The composed polynomial maps [1e-3, 1] to within 1e-6 of 1."""
    x = np.linspace(1e-3, 1.0, 50001)
    y = x.copy()
    for a, b, c in POLAR_QUINTIC_SCHEDULE:
        y = a * y + b * y**3 + c * y**5
    # 6-decimal coefficient rounding leaves ~1e-6 composed error
    assert np.abs(y - 1.0).max() < 5e-6


def test_polar_matches_eigh_on_random_hermitian():
    rng = np.random.default_rng(3)
    X = (rng.normal(size=(12, 101, 101)) + 1j * rng.normal(size=(12, 101, 101))).astype(
        np.complex64
    )
    M = (X + np.conj(np.swapaxes(X, -1, -2))) / 2
    Pe = np.asarray(psd_project_eigh(jnp.asarray(M)))
    Pp = np.asarray(psd_project_polar(jnp.asarray(M)))
    err = np.linalg.norm(Pe - Pp, axis=(1, 2)) / np.linalg.norm(Pe, axis=(1, 2))
    assert err.max() < 2e-4, err.max()


def test_polar_solver_mode_matches_eigh_mode():
    y, b, s = make_anchor_batch(2, mode="redemod", seed=5)
    phi_e = np.asarray(
        admm_solve_fixed(jnp.asarray(y), jnp.asarray(b), jnp.asarray(s), 40, 1.0,
                         ADMMOptions(g_update="eigh"))
    )
    phi_p = np.asarray(
        admm_solve_fixed(jnp.asarray(y), jnp.asarray(b), jnp.asarray(s), 40, 1.0,
                         ADMMOptions(g_update="polar"))
    )
    assert scale_invariant_nmse(phi_p, phi_e) < 1e-4


def test_fit_polar_schedule_reproduces_committed_prefix():
    """Greedy LP fitter: each step contracts the band, and the fitted
    schedule's first steps match the committed POLAR_QUINTIC_SCHEDULE
    (greedy => a shorter fit is a prefix of a longer one)."""
    from admmnet_tpu.ops.fit_polar_schedule import composed_errors, fit_schedule

    sched, _ = fit_schedule(3, l0=1e-3)
    for got, want in zip(sched, POLAR_QUINTIC_SCHEDULE):
        assert np.allclose(got, want, atol=2e-5), (got, want)
    # 3-step band error is still large; the committed 7-step one is ~1e-6
    band3, _ = composed_errors(sched, 1e-3)
    assert band3 > 1e-2


def test_bf16_schedule_box_and_band_properties():
    """POLAR_BF16_SCHEDULE (+ polish): composed map stays inside the box on
    [0, 1.01] (no overshoot anywhere -- the bf16-stability property), hits 1
    to ~1e-5 on [3e-3, 1], and its |M|-weighted error is small on [0, 1]."""
    from admmnet_tpu.ops.projections import (
        POLAR_BF16_POLISH,
        POLAR_BF16_SCHEDULE,
    )

    x = np.linspace(0.0, 1.01, 200001)
    p = x.copy()
    pmax_running = 0.0
    for a, b, c in POLAR_BF16_SCHEDULE + (POLAR_BF16_POLISH,):
        p = p * (a + b * p**2 + c * p**4)
        pmax_running = max(pmax_running, p.max())
    # every intermediate stays bounded (fit box is ~1.016 + LP slack)
    assert pmax_running < 1.05, pmax_running
    assert p.min() > -0.03, p.min()
    band = x >= 3e-3
    assert np.abs(p[band & (x <= 1.0)] - 1.0).max() < 1e-5
    assert np.abs(x * (p - 1.0))[x <= 1.0].max() < 2e-4


def test_polar_fast_solver_mode_matches_eigh_mode():
    """g_update="polar_fast" end-to-end (the detection-grade schedule)."""
    y, b, s = make_anchor_batch(2, mode="redemod", seed=5)
    phi_e = np.asarray(
        admm_solve_fixed(jnp.asarray(y), jnp.asarray(b), jnp.asarray(s), 40, 1.0,
                         ADMMOptions(g_update="eigh"))
    )
    phi_f = np.asarray(
        admm_solve_fixed(jnp.asarray(y), jnp.asarray(b), jnp.asarray(s), 40, 1.0,
                         ADMMOptions(g_update="polar_fast"))
    )
    assert scale_invariant_nmse(phi_f, phi_e) < 1e-3


def test_fit_bf16_schedule_reproduces_committed():
    """The two-phase LP fitter reproduces the committed POLAR_BF16_SCHEDULE
    and POLAR_BF16_POLISH (deterministic grid LPs)."""
    from admmnet_tpu.ops.fit_polar_schedule import fit_bf16_schedule
    from admmnet_tpu.ops.projections import (
        POLAR_BF16_POLISH,
        POLAR_BF16_SCHEDULE,
    )

    sched, polish = fit_bf16_schedule()
    assert len(sched) == len(POLAR_BF16_SCHEDULE)
    for got, want in zip(sched, POLAR_BF16_SCHEDULE):
        assert np.allclose(got, want, atol=2e-4), (got, want)
    assert np.allclose(polish, POLAR_BF16_POLISH, atol=2e-4)
