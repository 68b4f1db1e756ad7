"""Atom / steering-vector factory for the joint delay-Doppler dictionary.

Design: everything is expressed so that spectrum evaluation over a grid of
candidate (tau, f) points becomes ONE dense complex matmul,
instead of the reference's nested Python loops over grid points
(reference utils/peakSearchUtils.py:37-60).

Functional parity targets:
- ``vander_vec``   ~ reference utils/mathUtils.py:4-21
- ``khatri_rao``   ~ reference utils/mathUtils.py:24-50
- atom layout      ~ ``kron(s(f), conj(d(tau)))`` as used in reference
                     main.py:29 and utils/peakSearchUtils.py:27-31
"""

from __future__ import annotations

import jax.numpy as jnp

COMPLEX = jnp.complex64


def vander_vec(start: float, stop: float, length: int) -> jnp.ndarray:
    """Unit-modulus Vandermonde-style vector exp(2j*pi*linspace(start, stop)).

    Matches reference utils/mathUtils.py:4-21 but returns a flat (length,)
    vector (the reference reshapes to a column; callers always flatten back).
    """
    fre = jnp.linspace(start, stop, length)
    return jnp.exp(2j * jnp.pi * fre).astype(COMPLEX)


def doppler_steering(f, Nb: int) -> jnp.ndarray:
    """s(f) = exp(2j*pi*f*[0..Nb-1]); f may be scalar or batched (...,).

    Returns (..., Nb).  Equivalent to vander_vec(0, (Nb-1)*f, Nb) since
    linspace(0, (Nb-1)*f, Nb) == f*[0..Nb-1] (reference main.py:24).
    """
    f = jnp.asarray(f)
    m = jnp.arange(Nb, dtype=jnp.float32)
    return jnp.exp(2j * jnp.pi * f[..., None] * m).astype(COMPLEX)


def delay_steering(tau, Nd: int) -> jnp.ndarray:
    """d(tau) = exp(2j*pi*tau*[0..Nd-1]); returns (..., Nd)."""
    tau = jnp.asarray(tau)
    k = jnp.arange(Nd, dtype=jnp.float32)
    return jnp.exp(2j * jnp.pi * tau[..., None] * k).astype(COMPLEX)


def khatri_rao(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Column-wise Kronecker product: (m, n) x (p, n) -> (m*p, n).

    Vectorized replacement for the reference's per-column Python loop
    (utils/mathUtils.py:24-50): one broadcasted outer product + reshape.
    """
    m, n = A.shape
    p, n2 = B.shape
    if n != n2:
        raise ValueError(f"column mismatch {n} vs {n2}")
    return (A[:, None, :] * B[None, :, :]).reshape(m * p, n)


def atom(tau, f, Nb: int, Nd: int) -> jnp.ndarray:
    """Flattened atom a(tau, f) = kron(s(f), conj(d(tau))), shape (..., Nb*Nd).

    Layout index m*Nd + k: a[..., m*Nd + k] = exp(2j*pi*(f*m - tau*k)),
    matching the reference's kr(S, conj(D)) columns (main.py:19-29).
    """
    s = doppler_steering(f, Nb)  # (..., Nb)
    d_conj = jnp.conj(delay_steering(tau, Nd))  # (..., Nd)
    out = s[..., :, None] * d_conj[..., None, :]  # (..., Nb, Nd)
    return out.reshape(*out.shape[:-2], Nb * Nd)


def atom_matrix(taus, fs, Nb: int, Nd: int) -> jnp.ndarray:
    """Dictionary matrix over paired (tau, f) points: (n_points, Nb*Nd).

    ``taus`` and ``fs`` are 1-D of equal length; row i is atom(taus[i], fs[i]).
    Feed its conj-transpose to a matmul against batched phi for spectrum
    evaluation: z = |A conj(phi)| style products (see peaks.spectrum).
    """
    return atom(jnp.asarray(taus), jnp.asarray(fs), Nb, Nd)


def target_signal(taus, fs, gains, Nb: int, Nd: int) -> jnp.ndarray:
    """Superposition Psi = sum_l gains[l] * a(tau_l, f_l), shape (..., Nb*Nd).

    Replaces the reference's per-target loop + kr(...) @ C matmul
    (main.py:19-29, generate_data.py:147-155).  Batched: taus/fs/gains may be
    (..., L); the leading dims broadcast.
    """
    a = atom(jnp.asarray(taus), jnp.asarray(fs), Nb, Nd)  # (..., L, n)
    return jnp.sum(jnp.asarray(gains).astype(COMPLEX)[..., None] * a, axis=-2)
