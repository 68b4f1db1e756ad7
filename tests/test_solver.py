"""Classical solver tests: ref-compat golden parity against the numpy oracle,
honest-mode end-to-end detection on the data.npz anchor, batched-mask
semantics."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from admmnet_tpu.core.config import ADMMOptions
from admmnet_tpu.data.anchor import load_anchor, make_anchor_batch
from admmnet_tpu.peaks import find_peaks, match_peaks, phi_nmse
from admmnet_tpu.solver import admm_solve, admm_solve_fixed
from admmnet_tpu.solver import reference_oracle as oracle


def _anchor():
    return load_anchor(mode="fixed_e", rng=np.random.default_rng(0))


def test_reference_svd_step_is_identity_on_hermitian():
    """Confirms the documented quirk: the reference's G-update reconstructs
    any Hermitian input exactly (so it never projects onto the PSD cone)."""
    rng = np.random.default_rng(0)
    n = 30
    X = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    Z = rng.normal(size=(n + 1, n + 1)) + 1j * rng.normal(size=(n + 1, n + 1))
    Z = (Z + Z.conj().T) / 2
    H = np.diag(rng.normal(size=n))
    phi = rng.normal(size=n) + 1j * rng.normal(size=n)
    G = oracle.g_svd_update(H, phi, 1.0, Z, 1.0)
    # rebuild what the input matrix was
    M = np.zeros((n + 1, n + 1), complex)
    M[:n, :n] = H
    M[:n, n] = phi
    M[n, :n] = phi.conj()
    M[n, n] = 1.0
    M = M - Z
    np.testing.assert_allclose(G, M, atol=1e-10)


def test_oracle_exits_at_min_iter_on_anchor():
    sc = _anchor()
    phi, iters = oracle.reference_admm(
        sc.y, sc.b, sigma=sc.sigma, eta_abs=1e-7, eta_rel=1e-7, max_iter=100
    )
    assert iters == 5  # degenerate trajectory: residuals are exactly zero


def test_ref_compat_dense_matches_oracle():
    sc = _anchor()
    opts = ADMMOptions(
        phi_update="ref_dense", g_update="ref_identity", max_iter=100
    )
    res = jax.jit(lambda y, b, s: admm_solve(y, b, s, 1.0, opts))(
        jnp.asarray(sc.y, jnp.complex64),
        jnp.asarray(sc.b, jnp.complex64),
        jnp.float32(sc.sigma),
    )
    phi_ref, iters_ref = oracle.reference_admm(
        sc.y, sc.b, sigma=sc.sigma, eta_abs=1e-7, eta_rel=1e-7, max_iter=100
    )
    assert int(res.iterations) == iters_ref == 5
    assert phi_nmse(np.asarray(res.phi), phi_ref) < 1e-8


def test_ref_compat_diag_matches_oracle_diag():
    sc = _anchor()
    opts = ADMMOptions(phi_update="diag", g_update="ref_identity", max_iter=100)
    res = admm_solve(
        jnp.asarray(sc.y, jnp.complex64),
        jnp.asarray(sc.b, jnp.complex64),
        jnp.float32(sc.sigma),
        1.0,
        opts,
    )
    phi_ref, _ = oracle.reference_admm(
        sc.y, sc.b, sigma=sc.sigma, phi_mode="diag"
    )
    assert phi_nmse(np.asarray(res.phi), phi_ref) < 1e-8


def test_honest_solver_detects_anchor_targets():
    """The real ANM ADMM (eigh PSD projection, exact H projection) must
    localize the 3 anchor targets (reference main.py scenario)."""
    sc = _anchor()
    opts = ADMMOptions(max_iter=60)  # honest mode defaults: diag + eigh
    res = admm_solve(
        jnp.asarray(sc.y, jnp.complex64),
        jnp.asarray(sc.b, jnp.complex64),
        jnp.float32(sc.sigma),
        1.0,
        opts,
    )
    peaks = find_peaks(res.phi, sc.Nb, sc.Nd)
    stats = match_peaks(
        np.asarray(peaks.tau)[None, :3],
        np.asarray(peaks.f)[None, :3],
        sc.tau[None, :],
        sc.f[None, :],
        tol_tau=0.05,
        tol_f=0.05,
    )
    assert stats["f1"] == 1.0, stats


def test_batched_solve_matches_individual():
    y, b, sigma = make_anchor_batch(3, mode="redemod", seed=1)
    opts = ADMMOptions(max_iter=12, eta_abs=1e-3, eta_rel=1e-3)
    batched = admm_solve(jnp.asarray(y), jnp.asarray(b), jnp.asarray(sigma), 1.0, opts)
    for i in range(3):
        single = admm_solve(
            jnp.asarray(y[i]), jnp.asarray(b[i]), jnp.float32(sigma[i]), 1.0, opts
        )
        np.testing.assert_allclose(
            np.asarray(batched.phi[i]), np.asarray(single.phi), atol=2e-5
        )
        assert int(batched.iterations[i]) == int(single.iterations)


def test_fixed_iteration_scan_matches_while_loop():
    y, b, sigma = make_anchor_batch(2, mode="redemod", seed=2)
    # eta = 0 so the while_loop never converges early
    opts = ADMMOptions(max_iter=7, eta_abs=0.0, eta_rel=0.0)
    res = admm_solve(jnp.asarray(y), jnp.asarray(b), jnp.asarray(sigma), 1.0, opts)
    phi_fixed = admm_solve_fixed(
        jnp.asarray(y), jnp.asarray(b), jnp.asarray(sigma), 7, 1.0, opts
    )
    np.testing.assert_allclose(np.asarray(res.phi), np.asarray(phi_fixed), atol=1e-6)


def test_newton_schulz_mode_close_to_eigh_mode():
    y, b, sigma = make_anchor_batch(1, mode="redemod", seed=3)
    phi_e = admm_solve_fixed(
        jnp.asarray(y), jnp.asarray(b), jnp.asarray(sigma), 20, 1.0,
        ADMMOptions(g_update="eigh"),
    )
    phi_ns = admm_solve_fixed(
        jnp.asarray(y), jnp.asarray(b), jnp.asarray(sigma), 20, 1.0,
        ADMMOptions(g_update="newton_schulz", newton_schulz_iters=30),
    )
    from admmnet_tpu.peaks import scale_invariant_nmse

    assert scale_invariant_nmse(np.asarray(phi_ns), np.asarray(phi_e)) < 1e-3


# phi NMSE vs the eigh solve that each PSD mode must meet on small scenes
_G_TOL = {"eigh": 1e-10, "polar": 1e-4, "polar_fast": 1e-3,
          "newton_schulz": 1e-3}


@pytest.mark.parametrize("solver", ["admm_solve", "admm_solve_fixed"])
@pytest.mark.parametrize("g_update", list(_G_TOL))
def test_g_update_modes_match_eigh(g_update, solver):
    """Every PSD mode, through both solver entry points, lands near the
    exact-projection (eigh) solve of the same Nb=Nd=4 scenes."""
    from admmnet_tpu.core.config import DataConfig, ProblemSpec
    from admmnet_tpu.data.generator import generate_batch
    from admmnet_tpu.peaks import scale_invariant_nmse as nmse

    spec = ProblemSpec(Nb=4, Nd=4, L_max=2)
    raw = generate_batch(jax.random.PRNGKey(7), DataConfig(spec=spec), 4)
    args = (raw["y"], raw["b"], raw["sigma"])
    iters = 20

    def run(g):
        opts = ADMMOptions(g_update=g, max_iter=iters, eta_abs=0.0,
                           eta_rel=0.0, newton_schulz_iters=30)
        if solver == "admm_solve":
            res = jax.jit(lambda y, b, s: admm_solve(y, b, s, 1.0, opts))(*args)
            assert (np.asarray(res.iterations) == iters).all()
            return np.asarray(res.phi)
        return np.asarray(jax.jit(
            lambda y, b, s: admm_solve_fixed(y, b, s, iters, 1.0, opts)
        )(*args))

    assert nmse(run(g_update), run("eigh")) <= _G_TOL[g_update]
