"""The XLA Clenshaw recurrence (ops/chebyshev.py) as a matrix function, and
its autodiff VJP against central finite differences."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from admmnet_tpu.ops.chebyshev import apply_spectral_filter


def _hermitian(seed, batch=2, m=12):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(batch, m, m)) + 1j * rng.normal(size=(batch, m, m))
    return jnp.asarray((A + np.conj(np.swapaxes(A, -1, -2))) / 2, jnp.complex64)


def _eig_filter(M, f):
    w, V = np.linalg.eigh(np.asarray(M, np.complex128))
    fw = np.asarray(f(jnp.asarray(w, jnp.float32)), np.float64)
    return np.einsum("bij,bj,bkj->bik", V, fw, np.conj(V))


@pytest.mark.parametrize("name,f", [
    ("softplus", lambda w: jax.nn.softplus(w - 0.2)),
    ("relu_smooth", lambda w: 0.5 * (w + jnp.sqrt(w * w + 0.25))),
    ("gaussian", lambda w: jnp.exp(-0.05 * w * w)),
])
def test_clenshaw_equals_eigen_filter(name, f):
    """f_mat(M) from the recurrence equals V f(L) V^H from eigh."""
    M = _hermitian(1)
    got = np.asarray(apply_spectral_filter(M, f, degree=48))
    want = _eig_filter(M, f)
    err = np.linalg.norm(got - want, axis=(1, 2)) / np.linalg.norm(want, axis=(1, 2))
    assert err.max() < 2e-3, (name, err)


def _fd_check(loss, x, direction, eps):
    """Directional derivative from jax.jvp vs a central difference."""
    _, jvp = jax.jvp(loss, (x,), (direction,))
    fd = (loss(x + eps * direction) - loss(x - eps * direction)) / (2 * eps)
    return float(jvp), float(fd)


def test_clenshaw_vjp_wrt_filter_parameter_matches_fd():
    M = _hermitian(2)
    W = _hermitian(3)

    def loss(t):
        out = apply_spectral_filter(M, lambda w: jax.nn.softplus(w - t), 32)
        return jnp.real(jnp.sum(jnp.conj(W) * out))

    g = float(jax.grad(loss)(jnp.float32(0.3)))
    jvp, fd = _fd_check(loss, jnp.float32(0.3), jnp.float32(1.0), 1e-2)
    assert abs(g - jvp) <= 1e-4 * (1 + abs(g))
    assert abs(g - fd) <= 2e-2 * (1 + abs(g)), (g, fd)


def test_clenshaw_vjp_wrt_matrix_matches_fd():
    M = _hermitian(4)
    D = _hermitian(5)
    W = _hermitian(6)

    def loss(X):
        out = apply_spectral_filter(X, lambda w: jax.nn.softplus(w - 0.1), 32)
        return jnp.real(jnp.sum(jnp.conj(W) * out))

    # VJP contracted with the direction == forward-mode derivative (JAX's
    # gradient of a real function of complex x is conjugated: Re(g . D))
    g = jax.grad(loss)(M)
    vjp_dir = float(jnp.real(jnp.sum(g * D)))
    jvp, fd = _fd_check(loss, M, D, 1e-2)
    assert abs(vjp_dir - jvp) <= 1e-3 * (1 + abs(jvp)), (vjp_dir, jvp)
    assert abs(jvp - fd) <= 2e-2 * (1 + abs(jvp)), (jvp, fd)
