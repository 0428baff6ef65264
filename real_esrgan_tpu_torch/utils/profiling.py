"""Profiling helpers: a torch.profiler trace, a wall-clock step timer, and
spans and work counters of each request.  The port of
real_esrgan_tpu/utils/profiling.py, with the request spans added.

``trace()`` records the host's operators and, on a GPU, the device's kernels
with ``torch.profiler`` and writes one Chrome trace (which TensorBoard's
profile plugin and ``chrome://tracing`` open) under ``logdir`` when the block
ends; ``StepTimer`` summarises steady-state step time, leaving out the first
steps (the kernels' first build, cuDNN's first choices).

``span(name)`` times a stage of a request on ``time.perf_counter_ns``.  The
outermost open span of a thread is the request's root: it opens a
``Record``, its children add their durations to the record's ``stages`` by
name, and ``add`` adds to the record's work counters (outside any span it
does nothing, so code that counts runs the same with no request open).  When the root closes
the record goes into ``RING``, the last ``RING_SIZE`` requests of the
process, which ``requests()`` reads; nothing is written out.  While a torch
profiler is active each span also opens ``torch.profiler.record_function``
of its name, so the stage lies on the profiler's clock beside the device's
kernels (a ``trace()`` shows it), and the record is flagged ``profiled``;
with none, no range is made.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import os
import time
from collections import deque
from typing import Deque, Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as autograd_profiler
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


@dataclasses.dataclass
class Record:
    """One request: its root span's name and ``perf_counter_ns`` interval,
    the nanoseconds of its child spans summed by name (``stages``), and its
    work counters.  ``profiled``: a torch profiler was active during one of
    its spans; ``failed``: an exception left one of them; ``owner``: set by
    the code that opened the root, for readers that share the process (an
    HTTP app keeps to its own requests)."""
    id: int
    name: str
    profiled: bool
    start_ns: int = 0
    end_ns: int = 0
    failed: bool = False
    stages: Dict[str, int] = dataclasses.field(default_factory=dict)
    px_useful: int = 0     # input pixels the image holds
    px_run: int = 0        # input pixels the generator ran, counted at its call
    tiles: int = 0
    owner: object = None

    @property
    def tiled(self) -> int:
        return int(self.tiles > 0)

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


RING_SIZE = 4096
RING: Deque[Record] = deque(maxlen=RING_SIZE)
_OPEN: contextvars.ContextVar[Optional["span"]] = contextvars.ContextVar(
    "real_esrgan_tpu_torch_open_span", default=None)
_IDS = itertools.count(1)


class span:
    """A span of the stage ``name``, a context manager: a child of the
    thread's open span, or a new request's root where none is open.  Once
    entered it holds its ``parent`` span (None for a root) and its request's
    ``record`` (whose ``id`` is the request's), and once closed ``start_ns``
    and ``end_ns``."""

    __slots__ = ("name", "parent", "record", "start_ns", "end_ns", "_token", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        self.parent = _OPEN.get()
        profiled = autograd_profiler._is_profiler_enabled
        if self.parent is None:
            self.record = Record(next(_IDS), self.name, profiled)
        else:
            self.record = self.parent.record
            self.record.profiled |= profiled
        self._range = None
        if profiled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._token = _OPEN.set(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.end_ns = time.perf_counter_ns()
        _OPEN.reset(self._token)
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        record = self.record
        if exc_type is not None:
            record.failed = True
        if self.parent is None:
            record.start_ns, record.end_ns = self.start_ns, self.end_ns
            RING.append(record)
        else:
            record.stages[self.name] = (record.stages.get(self.name, 0)
                                        + self.end_ns - self.start_ns)
        return False


def add(**counters: int) -> None:
    """Adds to the open request's counters (``Record``'s integer fields);
    outside any span, nothing."""
    open_span = _OPEN.get()
    if open_span is None:
        return
    record = open_span.record
    for name, n in counters.items():
        setattr(record, name, getattr(record, name) + n)


def requests() -> List[Record]:
    """The finished requests still in ``RING``, oldest first."""
    return list(RING)
