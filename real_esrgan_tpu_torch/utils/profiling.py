"""Profiling helpers: a torch.profiler trace and a wall-clock step timer.
The port of real_esrgan_tpu/utils/profiling.py.

``trace()`` records the host's operators and, on a GPU, the device's kernels
with ``torch.profiler`` and writes one Chrome trace (which TensorBoard's
profile plugin and ``chrome://tracing`` open) under ``logdir`` when the block
ends; ``StepTimer`` summarises steady-state step time, leaving out the first
steps (the kernels' first build, cuDNN's first choices).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(logdir: str = "torch-trace") -> Iterator[profile]:
    """Record the block with ``torch.profiler`` (the CPU's operators, and the
    CUDA kernels where CUDA is available) and write
    ``logdir/trace-<pid>-<n>.json`` when it ends; yields the profiler, whose
    ``key_averages()`` sums the block by operator and kernel."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the block's kernels end inside the trace
    n = len(os.listdir(logdir))
    prof.export_chrome_trace(os.path.join(logdir, f"trace-{os.getpid()}-{n}.json"))


class StepTimer:
    """Steady-state step timing that discards warmup steps."""

    def __init__(self, skip_first: int = 2):
        self.skip_first = skip_first
        self._times: List[float] = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
        self._last = now

    @property
    def steady_mean(self) -> float:
        samples = self._times[self.skip_first:]
        return sum(samples) / len(samples) if samples else float("nan")

    def summary(self, items_per_step: float = 1.0) -> str:
        m = self.steady_mean
        return (f"{m * 1000:.1f} ms/step, {items_per_step / m:.2f} items/s"
                if m == m else "no steady-state samples")
