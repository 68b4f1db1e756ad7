"""Tracing / profiling helpers (SURVEY.md section 5).

The reference's only instrumentation is ad-hoc ``time.perf_counter`` brackets
(reference test/test_time_admm.py:90-93, train.py:159,287).  Here:

- ``trace(logdir)``: context manager around ``jax.profiler`` emitting a
  TensorBoard-loadable device trace;
- ``StepTimer``: wall-clock step timing and throughput accounting;
- ``timed_fetch``: time a single jitted call to completion
  (``jax.block_until_ready`` on its outputs);
- ``device_stage_split``: device busy/idle share and per-stage device time
  from a ``jax.profiler`` trace, attributing each kernel to the first
  ``jax.named_scope`` name found in its HLO instruction's op metadata.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler device trace into ``logdir``."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timed_fetch(fn, *args) -> tuple:
    """(result, seconds): runs fn(*args) and waits for every output."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def split_events(
    events: Iterable[Tuple[float, float, str]], stages: Sequence[str]
) -> Dict[str, float]:
    """Reduce device events ``(start_ns, duration_ns, label)`` to seconds.

    ``window_s`` spans the first start to the last end; ``busy_s`` is the
    union of the event intervals, so overlapping streams count once;
    ``idle_share`` is 1 - busy/window.  Each event's duration goes to the
    first of ``stages`` that occurs in its label, else to ``"other"``.
    """
    evs = sorted((float(s), float(s) + float(d), lab) for s, d, lab in events)
    out = {st: 0.0 for st in stages}
    out["other"] = 0.0
    if not evs:
        return {"window_s": 0.0, "busy_s": 0.0, "idle_share": None,
                "stage_s": out, "events": 0}
    busy, cur_s, cur_e = 0.0, evs[0][0], evs[0][1]
    for s, e, lab in evs:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        out[next((st for st in stages if st in lab), "other")] += e - s
    busy += cur_e - cur_s
    window = max(e for _, e, _ in evs) - evs[0][0]
    return {
        "window_s": window * 1e-9,
        "busy_s": busy * 1e-9,
        "idle_share": 1.0 - busy / window if window > 0 else 0.0,
        "stage_s": {k: v * 1e-9 for k, v in out.items()},
        "events": len(evs),
    }


def hlo_op_names(hlo_text: str) -> Dict[str, str]:
    """HLO instruction name -> ``op_name`` metadata (which carries the
    ``jax.named_scope`` path), from a compiled module's ``as_text()``."""
    import re

    pat = re.compile(
        r'^\s*(?:ROOT\s+)?%?(\S+)\s*=.*?metadata=\{[^}]*?op_name="([^"]*)"',
        re.M,
    )
    return dict(pat.findall(hlo_text))


def device_stage_split(
    trace_dir: str, stages: Sequence[str], hlo_text: Optional[str] = None
) -> Dict:
    """``split_events`` over every GPU kernel in the newest trace under
    ``trace_dir``.  A kernel's label is its name, its ``tf_op`` stat and,
    given the compiled module's ``hlo_text``, the ``op_name`` of its
    ``hlo_op``.  Kernels replayed from a CUDA graph report ``hlo_op=
    command_buffer`` and land in ``"other"``, so trace with
    ``XLA_FLAGS=--xla_gpu_enable_command_buffer=`` to attribute stages."""
    import glob
    import os

    from jax.profiler import ProfileData

    files = sorted(
        glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True),
        key=os.path.getmtime,
    )
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    op_names = hlo_op_names(hlo_text) if hlo_text else {}
    events = []
    for plane in ProfileData.from_file(files[-1]).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                op = op_names.get(str(stats.get("hlo_op", "")), "")
                events.append((ev.start_ns, ev.duration_ns,
                               f"{ev.name} {stats.get('tf_op', '')} {op}"))
    return split_events(events, stages)


class StepTimer:
    """Accumulate per-step wall times; report mean/percentiles/throughput."""

    def __init__(self, items_per_step: int = 1):
        self.items_per_step = items_per_step
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        assert self._t0 is not None, "start() not called"
        self.times.append(time.perf_counter() - self._t0)
        self._t0 = None

    @contextlib.contextmanager
    def step(self):
        self.start()
        yield
        self.stop()

    def summary(self) -> Dict[str, float]:
        import numpy as np

        t = np.asarray(self.times)
        if t.size == 0:
            return {}
        return {
            "steps": int(t.size),
            "mean_s": float(t.mean()),
            "p50_s": float(np.median(t)),
            "p95_s": float(np.percentile(t, 95)),
            "items_per_s": float(self.items_per_step / t.mean()),
        }
