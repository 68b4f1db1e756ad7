"""Auxiliary subsystems: profiling timers, NaN guards, JSONL metrics."""

import numpy as np
import pytest
import jax.numpy as jnp

from admmnet_tpu.train.metrics_io import MetricsWriter
from admmnet_tpu.utils.debug import check_finite, nan_guard
from admmnet_tpu.utils.profiling import StepTimer, timed_fetch


def test_step_timer_summary():
    t = StepTimer(items_per_step=10)
    for _ in range(3):
        with t.step():
            pass
    s = t.summary()
    assert s["steps"] == 3 and s["items_per_s"] > 0


def test_timed_fetch_barriers():
    import jax

    f = jax.jit(lambda x: (x * 2).sum())
    out, dt = timed_fetch(f, jnp.ones(16))
    assert float(out) == 32.0 and dt >= 0


def test_check_finite_flags_nan():
    check_finite({"ok": jnp.ones(3)})
    with pytest.raises(FloatingPointError, match="bad"):
        check_finite({"bad": jnp.asarray([1.0, np.nan])})


def test_nan_guard_raises_at_producing_op():
    import jax

    with nan_guard():
        with pytest.raises(FloatingPointError):
            jax.jit(lambda x: jnp.log(x))(jnp.asarray(-1.0)) + 1


def test_metrics_writer_roundtrip(tmp_path):
    w = MetricsWriter(tmp_path)
    w.log("epoch", epoch=1, loss=0.5)
    w.log("epoch", epoch=2, loss=0.25)
    recs = w.read_jsonl()
    assert [r["epoch"] for r in recs] == [1, 2]
    w.write_history({"train_loss": [0.5, 0.25]})
    assert (tmp_path / "training_history.json").exists()


def test_split_events_union_idle_and_stages():
    from admmnet_tpu.utils.profiling import split_events

    evs = [
        (0, 10, "gemm jit(f)/while/body/psd_projection/dot"),
        (5, 10, "fusion jit(f)/while/body/psd_projection/add"),  # overlaps
        (30, 10, "reduce jit(f)/while/body/h_projection/reduce"),
        (45, 5, "transpose jit(f)/while/body/add"),
    ]
    r = split_events(evs, ("psd_projection", "h_projection"))
    assert r["events"] == 4
    assert abs(r["window_s"] - 50e-9) < 1e-15
    assert abs(r["busy_s"] - 30e-9) < 1e-15  # [0,15] + [30,40] + [45,50]
    assert abs(r["idle_share"] - 0.4) < 1e-12
    assert r["stage_s"] == {"psd_projection": 20e-9, "h_projection": 10e-9,
                            "other": 5e-9}
    empty = split_events([], ("x",))
    assert empty["idle_share"] is None and empty["events"] == 0


def test_device_stage_split_on_cpu_trace_finds_no_gpu_events(tmp_path):
    """A CPU trace has no GPU plane: the reduction returns zero events (the
    card's trace is what it is for) and a missing trace raises."""
    import jax

    from admmnet_tpu.utils.profiling import device_stage_split, trace

    with trace(str(tmp_path)):
        jax.block_until_ready(jax.jit(lambda x: x * 2)(jnp.ones(4)))
    assert device_stage_split(str(tmp_path), ("a",))["events"] == 0
    with pytest.raises(FileNotFoundError):
        device_stage_split(str(tmp_path / "none"), ("a",))


def test_hlo_op_names_maps_instructions_to_scopes():
    """The trace's hlo_op names resolve to op_name metadata (named scopes)
    through the compiled module's text."""
    import jax

    from admmnet_tpu.utils.profiling import hlo_op_names

    def f(x):
        with jax.named_scope("psd_projection"):
            y = jnp.sin(x) @ x
        return y + 1.0

    x = jnp.ones((8, 8))
    names = hlo_op_names(jax.jit(f).lower(x).compile().as_text())
    assert names and all(not k.startswith("%") for k in names)
    assert any("psd_projection" in v for v in names.values())
