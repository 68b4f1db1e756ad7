"""ADMM-Net model tests: shapes, param inventory, gradient flow, stop-grad
parity, loss oracles."""

import numpy as np
import jax
import jax.numpy as jnp

from admmnet_tpu.core.config import ModelConfig, ProblemSpec
from admmnet_tpu.models import ADMMNet, PhiEstADMMNet
from admmnet_tpu.train import basic_anm_loss, basic_parameter_loss, phi_alignment_loss


def _toy_cfg(num_layers=2, Nb=4, Nd=4):
    return ModelConfig(spec=ProblemSpec(Nb=Nb, Nd=Nd, L_max=3), num_layers=num_layers)


def _inputs(cfg, B=3, seed=0):
    rng = np.random.default_rng(seed)
    n = cfg.spec.n
    y = (rng.normal(size=(B, n)) + 1j * rng.normal(size=(B, n))).astype(np.complex64)
    b = np.exp(1j * rng.uniform(0, 2 * np.pi, (B, n))).astype(np.complex64)
    sigma = np.abs(rng.normal(size=B)).astype(np.float32) + 1.0
    return jnp.asarray(y), jnp.asarray(b), jnp.asarray(sigma)


def test_phiest_forward_shapes():
    cfg = _toy_cfg()
    model = PhiEstADMMNet(cfg=cfg)
    y, b, s = _inputs(cfg)
    params = model.init(jax.random.PRNGKey(0), y, b, s)
    phi = model.apply(params, y, b, s)
    assert phi.shape == (3, cfg.spec.n)
    assert phi.dtype == jnp.complex64
    assert bool(jnp.all(jnp.isfinite(jnp.abs(phi))))


def test_admmnet_forward_shapes_and_ranges():
    cfg = _toy_cfg()
    model = ADMMNet(cfg=cfg)
    y, b, s = _inputs(cfg)
    params = model.init(jax.random.PRNGKey(0), y, b, s)
    tau, f, conf, phi = model.apply(params, y, b, s)
    assert tau.shape == f.shape == conf.shape == (3, 3)
    assert float(tau.min()) >= 0.0 and float(tau.max()) <= 1.0
    assert float(f.min()) >= -1.0 and float(f.max()) <= 1.0
    assert float(conf.min()) >= 0.0 and float(conf.max()) <= 1.0
    assert phi.shape == (3, cfg.spec.n)


def test_per_layer_params_exist():
    cfg = _toy_cfg(num_layers=3)
    model = PhiEstADMMNet(cfg=cfg)
    y, b, s = _inputs(cfg)
    params = model.init(jax.random.PRNGKey(0), y, b, s)["params"]["trunk"]
    for k in range(3):
        for prefix in ("phi", "h", "g", "z"):
            assert f"{prefix}_{k}" in params, params.keys()
    # learned scalars present
    assert params["phi_0"]["rho"].shape == ()
    assert params["g_0"]["lambda"].shape == ()
    assert params["g_0"]["threshold"].shape == ()


def test_gradients_flow_to_all_layer_kinds():
    cfg = _toy_cfg()
    model = PhiEstADMMNet(cfg=cfg)
    y, b, s = _inputs(cfg)
    params = model.init(jax.random.PRNGKey(0), y, b, s)

    def loss(p):
        phi = model.apply(p, y, b, s)
        return jnp.sum(jnp.abs(phi) ** 2)

    grads = jax.grad(loss)(params)["params"]["trunk"]
    # NOTE: the LAST layer's h/g/z params cannot receive gradients -- the
    # network returns phi, computed before them (same in the reference
    # forward, admm_net.py:757-764).  Check all earlier layers + final phi.
    for name in ("phi_0", "h_0", "g_0", "z_0", "phi_1"):
        gnorm = sum(
            float(jnp.sum(jnp.abs(g) ** 2))
            for g in jax.tree.leaves(grads[name])
        )
        assert gnorm > 0, f"no gradient into {name}"


def test_stop_gradient_parity_on_lambda():
    """With ref_stop_gradients=True the GLayer/ZLayer lambda receives no
    gradient through the block assembly (the reference's .item() behavior);
    with False it does."""
    for flag, expect_zero in [(True, True), (False, False)]:
        # two layers so layer-0's G/Z feed layer-1's phi (a single layer's
        # G/Z are discarded and would get zero grads either way)
        cfg = ModelConfig(
            spec=ProblemSpec(Nb=4, Nd=4), num_layers=2, ref_stop_gradients=flag
        )
        model = PhiEstADMMNet(cfg=cfg)
        y, b, s = _inputs(cfg)
        params = model.init(jax.random.PRNGKey(0), y, b, s)

        def loss(p):
            return jnp.sum(jnp.abs(model.apply(p, y, b, s)) ** 2)

        g = jax.grad(loss)(params)["params"]["trunk"]
        glam = float(jnp.abs(g["g_0"]["lambda"]))
        zlam = float(jnp.abs(g["z_0"]["lambda"]))
        if expect_zero:
            assert glam == 0.0 and zlam == 0.0, (glam, zlam)
        else:
            assert glam > 0.0 and zlam > 0.0, (glam, zlam)


def test_learned_sensing_option():
    cfg = ModelConfig(spec=ProblemSpec(Nb=4, Nd=4), num_layers=1, learned_sensing=True)
    model = PhiEstADMMNet(cfg=cfg)
    y, b, s = _inputs(cfg)
    params = model.init(jax.random.PRNGKey(0), y, b, s)
    assert "sensing" in params["params"]["trunk"]
    # identity init: same output as without sensing at init
    cfg0 = ModelConfig(spec=ProblemSpec(Nb=4, Nd=4), num_layers=1)
    m0 = PhiEstADMMNet(cfg=cfg0)
    p0 = m0.init(jax.random.PRNGKey(0), y, b, s)
    np.testing.assert_allclose(
        np.abs(np.asarray(model.apply(params, y, b, s))),
        np.abs(np.asarray(m0.apply(p0, y, b, s))),
        atol=1e-5,
    )


def np_basic_parameter_loss(tau_p, f_p, conf, tau_t, f_t, L_t):
    """Per-sample loop oracle transcribing reference loss.py:6-30 math."""
    B = tau_p.shape[0]
    total = 0.0
    for i in range(B):
        L = int(L_t[i])
        if L == 0:
            total += np.sum(conf[i] ** 2)
        else:
            total += (
                np.mean((tau_p[i, :L] - tau_t[i, :L]) ** 2)
                + np.mean((f_p[i, :L] - f_t[i, :L]) ** 2)
                + 0.1 * np.mean((conf[i, :L] - 1.0) ** 2)
            )
    return total / B


def test_basic_parameter_loss_matches_loop_oracle():
    rng = np.random.default_rng(0)
    B, L = 6, 3
    tau_p = rng.uniform(0, 1, (B, L)).astype(np.float32)
    f_p = rng.uniform(-0.5, 0.5, (B, L)).astype(np.float32)
    conf = rng.uniform(0, 1, (B, L)).astype(np.float32)
    tau_t = rng.uniform(0, 1, (B, L)).astype(np.float32)
    f_t = rng.uniform(-0.5, 0.5, (B, L)).astype(np.float32)
    L_t = np.array([3, 2, 1, 0, 3, 0], np.int32)
    got = float(
        basic_parameter_loss(
            jnp.asarray(tau_p), jnp.asarray(f_p), jnp.asarray(conf),
            jnp.asarray(tau_t), jnp.asarray(f_t), jnp.asarray(L_t),
        )
    )
    want = np_basic_parameter_loss(tau_p, f_p, conf, tau_t, f_t, L_t)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_phi_alignment_loss_wrapping():
    phi_t = np.exp(1j * np.array([[0.1, 3.0]])).astype(np.complex64)
    phi_p = np.exp(1j * np.array([[0.1 + 2 * np.pi, -3.0]])).astype(np.complex64)
    total, parts = phi_alignment_loss(jnp.asarray(phi_p), jnp.asarray(phi_t))
    # amplitude identical; phase diff [0, -6 rad wrapped to +0.283]
    assert float(parts["amplitude_loss"]) < 1e-10
    want_phase = np.mean([0.0, (2 * np.pi - 6.0) ** 2])
    np.testing.assert_allclose(float(parts["phase_loss"]), want_phase, rtol=1e-4)


def test_basic_anm_loss_reg_term():
    B, L, n = 2, 3, 8
    rng = np.random.default_rng(1)
    phi = (rng.normal(size=(B, n)) + 1j * rng.normal(size=(B, n))).astype(np.complex64)
    zeros = np.zeros((B, L), np.float32)
    total, parts = basic_anm_loss(
        jnp.asarray(zeros), jnp.asarray(zeros), jnp.asarray(zeros),
        jnp.asarray(phi), jnp.asarray(zeros), jnp.asarray(zeros),
        jnp.asarray(np.zeros(B, np.int32)),
    )
    want_reg = 1e-4 * np.mean(np.linalg.norm(phi, axis=-1))
    np.testing.assert_allclose(float(parts["reg_loss"]), want_reg, rtol=1e-5)


def test_chebyshev_matrix_function_exact_on_smooth_filter():
    """apply_spectral_filter matches the eigh route for a smooth filter."""
    import jax.numpy as jnp

    from admmnet_tpu.ops.chebyshev import apply_spectral_filter
    from admmnet_tpu.ops.projections import hermitian_eigh

    rng = np.random.default_rng(0)
    X = (rng.normal(size=(3, 33, 33)) + 1j * rng.normal(size=(3, 33, 33))).astype(
        np.complex64
    )
    M = jnp.asarray((X + np.conj(np.swapaxes(X, -1, -2))) / 2)

    f = lambda w: jnp.tanh(w) + 0.1 * w**2
    # Gaussian matrices are the worst case for the safe Frobenius spectral
    # bound (true radius ~2 sqrt(n) vs ||M||_F ~ n), so the filter is sharp
    # in the normalized domain: tanh needs degree ~ O(||M||_F / width).
    out = np.asarray(apply_spectral_filter(M, f, degree=96))
    w, V = hermitian_eigh(M)
    ref = np.asarray(
        jnp.einsum("...ij,...j,...kj->...ik", V, f(w).astype(M.dtype), jnp.conj(V))
    )
    err = np.linalg.norm(out - ref, axis=(1, 2)) / np.linalg.norm(ref, axis=(1, 2))
    # float32 Clenshaw accumulation floors around ~1e-3 at this degree
    assert err.max() < 2e-3, err.max()

    # at the radius the lifted GLayer matrices actually have (O(1) spectra,
    # froNorm tight-ish), a modest degree is already accurate
    Ms = M / 20.0
    out = np.asarray(apply_spectral_filter(Ms, f, degree=40))
    w, V = hermitian_eigh(Ms)
    ref = np.asarray(
        jnp.einsum("...ij,...j,...kj->...ik", V, f(w).astype(Ms.dtype), jnp.conj(V))
    )
    err = np.linalg.norm(out - ref, axis=(1, 2)) / np.linalg.norm(ref, axis=(1, 2))
    assert err.max() < 1e-4, err.max()


def test_glayer_chebyshev_mode_close_to_eigh_at_init():
    """Same params, both modes: the learned filter is piecewise-smooth, so
    degree-64 Chebyshev tracks the eigh evaluation closely at init."""
    import jax
    import jax.numpy as jnp

    from admmnet_tpu.models.layers import GLayer

    n = 16
    rng = np.random.default_rng(1)
    phi = jnp.asarray(
        (rng.normal(size=(4, n)) + 1j * rng.normal(size=(4, n))).astype(np.complex64)
        * 0.1
    )
    h = jnp.asarray(np.abs(rng.normal(size=(4, n))).astype(np.float32) * 0.01)
    Z = jnp.zeros((4, n + 1, n + 1), np.complex64)

    ge = GLayer(dim=n, mode="eigh")
    gc = GLayer(dim=n, mode="chebyshev", cheb_degree=64)
    params = ge.init(jax.random.PRNGKey(0), phi, h, Z)
    out_e = np.asarray(ge.apply(params, phi, h, Z))
    out_c = np.asarray(gc.apply(params, phi, h, Z))
    err = np.linalg.norm(out_c - out_e, axis=(1, 2)) / (
        np.linalg.norm(out_e, axis=(1, 2)) + 1e-12
    )
    assert err.max() < 0.05, err.max()


def test_phinet_chebyshev_mode_trains():
    """g_mode=chebyshev: forward + grads are finite and nonzero through the
    matmul-only spectral filter (no detached eigenvectors)."""
    import jax
    import jax.numpy as jnp

    from admmnet_tpu.core.config import ModelConfig, ProblemSpec
    from admmnet_tpu.models import PhiEstADMMNet

    spec = ProblemSpec(Nb=4, Nd=4, L_max=2)
    cfg = ModelConfig(spec=spec, num_layers=2, g_mode="chebyshev", cheb_degree=24)
    model = PhiEstADMMNet(cfg=cfg)
    rng = np.random.default_rng(2)
    n = spec.n
    y = jnp.asarray(
        (rng.normal(size=(4, n)) + 1j * rng.normal(size=(4, n))).astype(np.complex64)
    )
    b = jnp.asarray(np.exp(1j * np.pi / 4 * rng.integers(0, 4, (4, n))).astype(
        np.complex64))
    sigma = jnp.asarray(np.full(4, 2.0, np.float32))
    params = model.init(jax.random.PRNGKey(0), y, b, sigma)

    def loss(p):
        phi = model.apply(p, y, b, sigma)
        return jnp.mean(jnp.abs(phi) ** 2)

    val, grads = jax.value_and_grad(loss)(params)
    leaves = jax.tree_util.tree_leaves(grads)
    assert np.isfinite(float(val))
    assert all(np.all(np.isfinite(np.asarray(g))) for g in leaves)
    # the GLayer filter params receive gradient (no detach in this mode)
    gsum = sum(float(np.sum(np.abs(np.asarray(g)))) for g in leaves)
    assert gsum > 0


def test_spectrum_head_localizes_atoms_and_carries_gradient():
    """SpectrumPeakHead on phi = sum of atoms: even untrained it must
    localize each target to well under the 0.05 match tolerance (geometric
    search), and position/confidence outputs must carry gradient back to
    phi (through the soft-argmax and conf MLP)."""
    from admmnet_tpu.models.peak_head import SpectrumPeakHead
    from admmnet_tpu.ops.atoms import atom

    Nb = Nd = 10
    head = SpectrumPeakHead(M=Nb, N=Nd, L_max=3)
    taus_t = np.array([0.45, 0.2, 0.78], np.float32)
    fs_t = np.array([-0.25, 0.1, 0.33], np.float32)
    phi = sum(
        np.asarray(atom(t, f, Nb, Nd)) * g
        for t, f, g in zip(taus_t, fs_t, [1.0, 0.8, 0.6])
    )
    phi = jnp.asarray(phi[None, :])
    params = head.init(jax.random.PRNGKey(0), phi)
    tau, f, conf = head.apply(params, phi)
    assert tau.shape == f.shape == conf.shape == (1, 3)
    for tt, ff in zip(taus_t, fs_t):
        d = np.abs(np.asarray(tau)[0] - tt) + np.abs(np.asarray(f)[0] - ff)
        assert d.min() < 5e-3, (tt, ff, d)

    def loss(pair):
        t, fr, c = head.apply(params, pair[0] + 1j * pair[1])
        return jnp.sum(t) + jnp.sum(fr) + jnp.sum(c)

    g = jax.grad(loss)((jnp.real(phi), jnp.imag(phi)))
    assert float(jnp.linalg.norm(g[0])) > 0
    assert float(jnp.linalg.norm(g[1])) > 0


def test_admmnet_spectrum_head_forward_shapes():
    cfg = ModelConfig(
        spec=ProblemSpec(Nb=4, Nd=4, L_max=3), num_layers=2, head="spectrum"
    )
    model = ADMMNet(cfg=cfg)
    y, b, sigma = _inputs(cfg)
    params = model.init(jax.random.PRNGKey(0), y, b, sigma)
    tau, f, conf, phi = model.apply(params, y, b, sigma)
    assert tau.shape == f.shape == conf.shape == (3, 3)
    assert phi.shape == (3, 16)
    assert np.all((np.asarray(tau) >= 0) & (np.asarray(tau) <= 1))
    assert np.all((np.asarray(conf) >= 0) & (np.asarray(conf) <= 1))


def test_spectral_contrast_loss_descends_toward_targets():
    """Gradient descent on spectral_contrast_loss alone must (a) decrease the
    loss and (b) increase the spectrum alignment at EVERY true target (the
    log form forbids collapsing onto a subset of targets)."""
    from admmnet_tpu.ops.atoms import atom
    from admmnet_tpu.peaks.spectrum import spectrum_at
    from admmnet_tpu.train.losses import spectral_contrast_loss

    Nb = Nd = 8
    taus_t = jnp.asarray([[0.3, 0.7]], jnp.float32)
    fs_t = jnp.asarray([[-0.2, 0.25]], jnp.float32)
    L_true = jnp.asarray([2], jnp.int32)

    # start from a phi correlated with the targets but contaminated
    rng = np.random.default_rng(3)
    phi0 = (
        np.asarray(atom(0.3, -0.2, Nb, Nd))
        + np.asarray(atom(0.7, 0.25, Nb, Nd))
        + 3.0 * (rng.normal(size=Nb * Nd) + 1j * rng.normal(size=Nb * Nd))
    ).astype(np.complex64)[None, :]

    def loss(pair):
        phi = pair[0] + 1j * pair[1]
        return spectral_contrast_loss(phi, taus_t, fs_t, L_true, Nb, Nd)

    def aligns(pair):
        phi = pair[0] + 1j * pair[1]
        z = spectrum_at(phi, taus_t, fs_t, Nb, Nd)
        e = jnp.sum(jnp.abs(phi) ** 2, axis=-1, keepdims=True)
        return z / (e * Nb * Nd)

    pair = (jnp.real(jnp.asarray(phi0)), jnp.imag(jnp.asarray(phi0)))
    a0 = np.asarray(aligns(pair))
    l0 = float(loss(pair))
    g = jax.jit(jax.grad(loss))
    for _ in range(200):
        gr = g(pair)
        pair = (pair[0] - 0.5 * gr[0], pair[1] - 0.5 * gr[1])
    a1 = np.asarray(aligns(pair))
    l1 = float(loss(pair))
    assert l1 < l0
    assert (a1 > a0).all(), (a0, a1)
    assert a1.min() > 0.1, a1  # both targets hold substantial mass


def test_chebyshev_default_precision_matches_and_stays_hermitian():
    """precision=DEFAULT path (TF32 on the GPU): on CPU the precision
    flag is a no-op so the result must match HIGHEST to f32 noise, and the
    per-step re-projection must keep the output exactly Hermitian."""
    import jax
    from admmnet_tpu.ops.chebyshev import apply_spectral_filter

    rng = np.random.default_rng(5)
    A = rng.normal(size=(2, 16, 16)) + 1j * rng.normal(size=(2, 16, 16))
    M = jnp.asarray((A + np.conj(np.swapaxes(A, -1, -2))) / 2, jnp.complex64)

    def f(w):
        return jax.nn.softplus(w - 0.1)

    hi = np.asarray(apply_spectral_filter(M, f, degree=32))
    lo = np.asarray(
        apply_spectral_filter(M, f, degree=32,
                              precision=jax.lax.Precision.DEFAULT)
    )
    assert np.allclose(hi, lo, atol=1e-4), np.abs(hi - lo).max()
    np.testing.assert_array_equal(lo, np.conj(np.swapaxes(lo, -1, -2)))


def test_model_config_validates_enums():
    """A typo in a string option must raise, not silently fall through
    GLayer's string dispatch onto another evaluation path."""
    import pytest

    with pytest.raises(ValueError, match="cheb_precision"):
        ModelConfig(cheb_precision="high")
    with pytest.raises(ValueError, match="g_mode"):
        ModelConfig(g_mode="cheby")
    with pytest.raises(ValueError, match="head"):
        ModelConfig(head="Attention")
    for mode in ("eigh", "chebyshev"):
        assert ModelConfig(g_mode=mode).g_mode == mode
