"""Option surface: retired names raise, old run configs still load, and the
compile-cache location rule."""

import json
from pathlib import Path

import pytest

from admmnet_tpu.core.config import ADMMOptions, ModelConfig, TrainConfig, _from_dict

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("mode", ["fused_fast", "fused_exact", "Polar"])
def test_retired_or_unknown_g_update_raises(mode):
    with pytest.raises(ValueError, match="g_update"):
        ADMMOptions(g_update=mode)


@pytest.mark.parametrize("field", [
    "fused_kblk", "fused_schedule", "fused_proj_iters", "fused_exact_schedule",
    "polar_fast_hi_steps", "polar_bf16_store",
])
def test_retired_admm_option_fields_raise(field):
    with pytest.raises(TypeError, match=field):
        ADMMOptions(**{field: 1})


@pytest.mark.parametrize("field", ["cheb_impl", "cheb_kblk"])
def test_retired_model_config_fields_raise(field):
    with pytest.raises(TypeError, match=field):
        ModelConfig(**{field: 1})


@pytest.mark.parametrize("run", [
    "phi_long", "spec50k_sense", "train_net3_r05", "train_net5_r05",
    "train_pal_r05", "train_xla_r05",
])
def test_old_run_config_with_retired_fields_loads(run):
    """Checkpoints' config.json files written with ``cheb_impl`` /
    ``cheb_kblk`` load: unknown keys are skipped, the rest round-trips."""
    raw = json.loads((REPO / "runs" / run / "config.json").read_text())
    assert "cheb_impl" in raw["model"]
    mcfg = _from_dict(ModelConfig, raw["model"])
    tcfg = _from_dict(TrainConfig, raw["train"])
    assert mcfg.g_mode == raw["model"]["g_mode"]
    assert mcfg.num_layers == raw["model"]["num_layers"]
    assert mcfg.spec.n == raw["model"]["spec"]["Nb"] * raw["model"]["spec"]["Nd"]
    assert tcfg.batch_size == raw["train"]["batch_size"]


def test_compile_cache_uses_env_dir_and_sets_nothing(monkeypatch, tmp_path):
    import jax

    from admmnet_tpu.utils import enable_compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_defaults_to_fixed_checkout_path(monkeypatch):
    import jax

    from admmnet_tpu.utils import enable_compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = str(REPO / ".cache" / "jax")
    assert enable_compile_cache() == want
    assert enable_compile_cache() == want  # stable: no pid/time in the path
    assert calls == [("jax_compilation_cache_dir", want)] * 2
