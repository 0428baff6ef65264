"""Port of the profiling helpers against the JAX package's: StepTimer's
arithmetic on the same clock ticks, and a trace that names what ran in it."""

import glob
import json
import math
import os

import pytest
import torch

from real_esrgan_tpu.utils import profiling as jax_profiling
from real_esrgan_tpu_torch.utils import profiling

TICKS = (10.0, 10.9, 11.5, 11.52, 11.55, 11.61, 11.64)  # two slow warmup steps, then fast


def _timer(module, monkeypatch, ticks, skip_first=2):
    clock = iter(ticks)
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(clock))
    timer = module.StepTimer(skip_first=skip_first)
    for _ in ticks:
        timer.tick()
    return timer


@pytest.mark.parametrize("ticks,skip_first", [(TICKS, 2), (TICKS, 0), (TICKS[:3], 2),
                                              (TICKS[:1], 2)],
                         ids=["warmup_skipped", "nothing_skipped", "no_samples",
                              "one_tick"])
def test_step_timer_equals_jax(monkeypatch, ticks, skip_first):
    ours = _timer(profiling, monkeypatch, ticks, skip_first)
    ref = _timer(jax_profiling, monkeypatch, ticks, skip_first)
    if math.isnan(ref.steady_mean):
        assert math.isnan(ours.steady_mean)
        assert ours.summary() == ref.summary() == "no steady-state samples"
        return
    assert ours.steady_mean == ref.steady_mean
    for items in (1.0, 8, 16.5):
        assert ours.summary(items_per_step=items) == ref.summary(items_per_step=items)


def test_empty_timer_is_nan():
    timer = profiling.StepTimer()
    assert math.isnan(timer.steady_mean)
    assert timer.summary() == "no steady-state samples"


def test_trace_writes_a_chrome_trace_naming_the_op(tmp_path):
    logdir = str(tmp_path / "trace")
    x = torch.ones(8, 8)
    with profiling.trace(logdir) as prof:
        y = torch.mm(x, x) * 2
    assert float(y.sum()) == 8 * 8 * 8 * 2
    files = glob.glob(os.path.join(logdir, "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())
