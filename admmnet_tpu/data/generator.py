"""Synthetic OFDM-ISAC dataset generation, batched on device.

Functional target: reference generate_data.py:9-516 (OFDMDatasetGenerator and
DatasetGeneratorCreatePhi).  Distributions reproduced exactly
(generate_data.py:133-221):

- tau ~ U(0.1, 0.9), f ~ U(-0.4, 0.4), L = L_max targets per sample;
- complex gains C = N(0, 0.7^2) + j N(0, 0.7^2);
- QPSK symbols with demod errors at SNR_e = 7 dB (awgn -> hard decision);
- observation y = diag(b + e) Psi + w at SNR_w ~ U(5, 25) dB per sample;
- sigma = ||e/b|| + 1.

Unlike the reference's per-sample Python loop (~10k sequential iterations,
each invoking the classical solver for the phi-labelled variant,
generate_data.py:380-452), the whole split is generated as one batched jit
program, and phi labels come from the batched fixed-iteration solver.

On-disk layout matches the reference (.npy per key under <dir>/<split>/ plus
dataset_config.json) so tooling expectations carry over.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, Optional

import jax
import jax.numpy as jnp
import numpy as np

from admmnet_tpu.core.config import ADMMOptions, DataConfig
from admmnet_tpu.ops.atoms import target_signal
from admmnet_tpu.ops.signal import awgn, pskdemod, pskmod

SPLIT_KEYS = (
    "y_real", "y_imag", "b_real", "b_imag", "tau", "f",
    "C_real", "C_imag", "L_true", "sigma", "ser",
)


def _generate_device(key, cfg: DataConfig, batch: int):
    """One batched sample draw; runs under jit.  Returns a dict of arrays."""
    spec = cfg.spec
    n = spec.n
    L = spec.L_max
    k = jax.random.split(key, 9)

    tau = jax.random.uniform(k[0], (batch, L), minval=cfg.tau_range[0], maxval=cfg.tau_range[1])
    f = jax.random.uniform(k[1], (batch, L), minval=cfg.f_range[0], maxval=cfg.f_range[1])
    C = cfg.gain_std * (
        jax.random.normal(k[2], (batch, L)) + 1j * jax.random.normal(k[3], (batch, L))
    )

    Psi = target_signal(tau, f, C, spec.Nb, spec.Nd)  # (batch, n)

    data = jax.random.randint(k[4], (batch, n), 0, cfg.psk_order)
    sig = pskmod(data, cfg.psk_order, jnp.pi / cfg.psk_order)
    sig_n = awgn(k[5], sig, cfg.snr_demod)
    b = pskmod(pskdemod(sig_n, cfg.psk_order, jnp.pi / cfg.psk_order),
               cfg.psk_order, jnp.pi / cfg.psk_order)
    e = sig - b
    ser = 100.0 * jnp.mean((jnp.abs(e) > 1e-6).astype(jnp.float32), axis=-1)

    real_y = (b + e) * Psi
    snr_w = jax.random.uniform(
        k[6], (batch,), minval=cfg.snr_range[0], maxval=cfg.snr_range[1]
    )
    w = jnp.sqrt(0.5) * (
        jax.random.normal(k[7], (batch, n)) + 1j * jax.random.normal(k[8], (batch, n))
    )
    w_var = jnp.sum(jnp.abs(real_y) ** 2, axis=-1, keepdims=True) / (
        10.0 ** (snr_w[:, None] / 10.0) * n
    )
    y = real_y + jnp.sqrt(w_var).astype(jnp.complex64) * w.astype(jnp.complex64)
    sigma = jnp.sqrt(jnp.sum(jnp.abs(e / b) ** 2, axis=-1)) + 1.0

    return {
        "y": y, "b": b, "tau": tau, "f": f, "C": C,
        "L_true": jnp.full((batch,), L, jnp.int32),
        "sigma": sigma, "ser": ser,
    }


def generate_batch(
    key, cfg: DataConfig, batch: int, chunk: int = 2048
) -> Dict[str, np.ndarray]:
    """Generate a batch on device and fetch to host numpy.

    Generation runs in fixed-size ``chunk`` pieces so ONE compiled program
    serves every call regardless of split size.
    """
    fn = jax.jit(_generate_device, static_argnums=(1, 2))
    if batch < 256:  # tiny (test-sized) batches keep their exact shape
        return jax.device_get(fn(key, cfg, batch))
    outs = []
    produced = 0
    while produced < batch:
        key, sub = jax.random.split(key)
        outs.append(jax.device_get(fn(sub, cfg, chunk)))
        produced += chunk
    return {k: np.concatenate([o[k] for o in outs])[:batch] for k in outs[0]}


def label_phi(
    y: np.ndarray,
    b: np.ndarray,
    sigma: np.ndarray,
    opts: Optional[ADMMOptions] = None,
    iters: int = 100,
    lambda_val: float = 1.0,
    chunk: int = 1024,
) -> np.ndarray:
    """Label instances with classical-solver phi (batched replacement for the
    reference's per-sample solver loop, generate_data.py:444-452).

    Default solver mode is the phi-exact ``g_update="polar"`` (phi NMSE vs
    the eigh solve <= 1e-5).  phi accuracy is the labelling contract
    (reference trainPhi.py:89-94), so the detection-grade ``polar_fast``
    should NOT be passed here."""
    from admmnet_tpu.solver import admm_solve_fixed

    opts = opts or ADMMOptions(g_update="polar")
    run = jax.jit(
        lambda y, b, s: admm_solve_fixed(y, b, s, iters, lambda_val, opts)
    )
    N = y.shape[0]
    # keep ONE compiled shape across all splits: small inputs pad up to 256,
    # everything else pads up to ``chunk``
    chunk = chunk if N >= 256 else 256
    outs = []
    import time as _time

    for i in range(0, N, chunk):
        _t0 = _time.time()
        ye, be, se = y[i : i + chunk], b[i : i + chunk], sigma[i : i + chunk]
        pad = chunk - ye.shape[0]
        if pad:  # pad the tail chunk so every call shares ONE compiled shape
            ye = np.concatenate([ye, np.repeat(ye[-1:], pad, 0)])
            be = np.concatenate([be, np.repeat(be[-1:], pad, 0)])
            se = np.concatenate([se, np.repeat(se[-1:], pad, 0)])
        phi = np.asarray(run(ye, be, se))
        print(f"[label] chunk {i // chunk + 1}/{-(-N // chunk)} "
              f"({_time.time() - _t0:.1f}s)", flush=True)
        outs.append(phi[: chunk - pad] if pad else phi)
    return np.concatenate(outs, axis=0)


class DatasetGenerator:
    """Generate/save/load train/val/test splits (reference
    generate_data.py:46-300 surface)."""

    def __init__(self, cfg: DataConfig = DataConfig(), data_dir="./ofdm_dataset"):
        self.cfg = cfg
        self.data_dir = Path(data_dir)

    def generate_complete_dataset(
        self, total_samples: int = 10000, seed: int = 0, with_phi: bool = False,
        phi_opts: Optional[ADMMOptions] = None, phi_iters: int = 100,
    ):
        cfg = self.cfg
        n_train = int(total_samples * cfg.train_ratio)
        n_val = int(total_samples * cfg.val_ratio)
        n_test = total_samples - n_train - n_val
        key = jax.random.PRNGKey(seed)
        kt, kv, ks = jax.random.split(key, 3)
        splits = {}
        import time as _time

        for name, k, count in (
            ("train", kt, n_train), ("val", kv, n_val), ("test", ks, n_test)
        ):
            t0 = _time.time()
            raw = generate_batch(k, cfg, count)
            print(f"[datagen] {name}: generated {count} samples "
                  f"({_time.time() - t0:.1f}s)", flush=True)
            if with_phi:
                t0 = _time.time()
                phi = label_phi(
                    raw["y"], raw["b"], raw["sigma"], phi_opts, phi_iters
                )
                raw["phi"] = phi
                print(f"[datagen] {name}: phi-labelled "
                      f"({_time.time() - t0:.1f}s)", flush=True)
            splits[name] = raw
            self._save_split(name, raw)
        self._save_config(total_samples, n_train, n_val, n_test, with_phi)
        return splits

    def _save_split(self, name: str, raw: Dict[str, np.ndarray]):
        d = self.data_dir / name
        d.mkdir(parents=True, exist_ok=True)
        flat = {
            "y_real": raw["y"].real.astype(np.float32),
            "y_imag": raw["y"].imag.astype(np.float32),
            "b_real": raw["b"].real.astype(np.float32),
            "b_imag": raw["b"].imag.astype(np.float32),
            "tau": raw["tau"].astype(np.float32),
            "f": raw["f"].astype(np.float32),
            "C_real": raw["C"].real.astype(np.float32),
            "C_imag": raw["C"].imag.astype(np.float32),
            "L_true": raw["L_true"].astype(np.int32),
            "sigma": raw["sigma"].astype(np.float32),
            "ser": raw["ser"].astype(np.float32),
        }
        if "phi" in raw:
            flat["phi_real"] = raw["phi"].real.astype(np.float32)
            flat["phi_imag"] = raw["phi"].imag.astype(np.float32)
        for k, v in flat.items():
            np.save(d / f"{k}.npy", v)

    def _save_config(self, total, n_train, n_val, n_test, with_phi):
        self.data_dir.mkdir(parents=True, exist_ok=True)
        cfg = self.cfg
        info = {
            "Nb": cfg.spec.Nb, "Nd": cfg.spec.Nd, "L_max": cfg.spec.L_max,
            "snr_range": list(cfg.snr_range), "total_samples": total,
            "train_samples": n_train, "val_samples": n_val,
            "test_samples": n_test, "with_phi": with_phi,
        }
        with open(self.data_dir / "dataset_config.json", "w") as fp:
            json.dump(info, fp, indent=2)

    def load_split(self, split: str) -> Dict[str, np.ndarray]:
        d = self.data_dir / split
        if not d.exists():
            raise FileNotFoundError(f"split {split} not generated under {self.data_dir}")
        arrays = {p.stem: np.load(p) for p in d.glob("*.npy")}
        out = {
            "y": arrays["y_real"] + 1j * arrays["y_imag"],
            "b": arrays["b_real"] + 1j * arrays["b_imag"],
            "tau": arrays["tau"],
            "f": arrays["f"],
            "C": arrays["C_real"] + 1j * arrays["C_imag"],
            "L_true": arrays["L_true"],
            "sigma": arrays["sigma"],
            "ser": arrays["ser"],
        }
        if "phi_real" in arrays:
            out["phi"] = arrays["phi_real"] + 1j * arrays["phi_imag"]
        return out


def iterate_batches(
    data: Dict[str, np.ndarray],
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = False,
) -> Iterator[Dict[str, np.ndarray]]:
    """Host-side minibatch iterator (replaces the torch DataLoader surface,
    reference generate_data.py:258-300)."""
    N = data["y"].shape[0]
    idx = np.arange(N)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    stop = N - (N % batch_size) if drop_remainder else N
    for i in range(0, stop, batch_size):
        sel = idx[i : i + batch_size]
        yield {k: v[sel] for k, v in data.items()}
