"""What every driver of the benchmark shares: the run's context and
outcome, CUDA-event spans, the profiled sub-window, and the statistics.

A driver (``drivers/<name>.py``, named by the traffic file's ``driver``)
sets the program up, warms every shape its traffic uses, measures for the
run's seconds, reads the device's peak memory, frees the program's state,
and has the plain reference judge what the timed path produced.  It fills
an ``Outcome``; the metric readers (``metrics/<metric>.py``) take their
numbers from it.
"""

from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

BENCH_DIR = Path(__file__).resolve().parent


@dataclasses.dataclass
class Context:
    workload: str
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic file's contents
    limits: dict          # the cell's limits file: number name -> limit
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float        # perf_counter at process start
    # set-up's phases on the host clock, name -> seconds (``lap``)
    setup_phases: Dict[str, float] = dataclasses.field(default_factory=dict)

    def lap(self, phase: str) -> float:
        """Adds to set-up's phase ``phase`` the time since the last lap (the
        first from process start); returns the host clock."""
        now = time.perf_counter()
        since = now - self.t_start - sum(self.setup_phases.values())
        self.setup_phases[phase] = self.setup_phases.get(phase, 0.0) + since
        return now


@dataclasses.dataclass
class Check:
    """One number the correctness comparison computed, beside its limit:
    the run is correct when every number is at or under its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit)  # NaN fails


@dataclasses.dataclass
class Outcome:
    setup_s: float = math.nan
    window_s: float = math.nan
    attempted: int = 0
    failed: int = 0
    values: Dict[str, object] = dataclasses.field(default_factory=dict)
    spans_ms: Dict[str, float] = dataclasses.field(default_factory=dict)
    profile: Optional[dict] = None
    checks: List[Check] = dataclasses.field(default_factory=list)
    memory_peak_bytes: int = 0

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


class Spans:
    """Device time between pairs of CUDA events, summed by name over the
    window.  ``mark(name)`` records an event; ``pair(begin, end, span)``
    declares that the time from each ``begin`` mark to the ``end`` mark
    after it adds to ``span``.  Events are read once the window has
    closed, so marking does not wait for the device."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List[tuple] = []
        self.pairs: List[tuple] = []

    def mark(self, name: str) -> None:
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
        else:  # the CPU tests: host time
            event = _HostMark()
        self.marks.append((name, event))

    def pair(self, begin: str, end: str, span: str) -> None:
        self.pairs.append((begin, end, span))

    def totals_ms(self) -> Dict[str, float]:
        if self.cuda:
            torch.cuda.synchronize()
        totals: Dict[str, float] = {}
        for begin, end, span in self.pairs:
            opened = None
            for name, event in self.marks:
                if name == begin:
                    opened = event
                elif name == end and opened is not None:
                    totals[span] = totals.get(span, 0.0) + opened.elapsed_time(event)
                    opened = None
        return totals


class _HostMark:
    def __init__(self):
        self.t = time.perf_counter()

    def elapsed_time(self, later: "_HostMark") -> float:
        return (later.t - self.t) * 1e3


def percentile_nearest_rank(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (the smallest value with at least
    q% of the values at or below it); inf where a value is missing."""
    ordered = sorted(values)
    if not ordered:
        return math.nan
    return float(ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)])


def _live_sq(out: torch.Tensor, ref: torch.Tensor):
    """Per image of (B, H, W, C) outputs in [0, 1]: the sum of squares of
    ``out - ref`` over the values that either side leaves inside (0, 1) (the
    values both sides clamp to one bound are equal by construction and would
    only dilute the gap), their count, and whether ``out`` holds a value
    outside [0, 1] or not finite."""
    out, ref = out.float(), ref.float()
    live = ((ref > 0) & (ref < 1)) | ((out > 0) & (out < 1))
    sq = torch.where(live, (out - ref) ** 2, torch.zeros_like(out)).flatten(1).sum(1)
    bad = ~torch.isfinite(out).flatten(1).all(1) | (out < 0).flatten(1).any(1) | \
        (out > 1).flatten(1).any(1)
    return sq, live.flatten(1).sum(1), bad


class GapRatio:
    """The serving cells' number: the RMS of the program's gap to the float32
    reference over the live values of every image judged, in units of the
    same RMS of a plain bfloat16 computation of the reference (the
    configuration's precision, rounded at each conv's output).

    The raw gap scales with how far a seed's random weights amplify, so
    seeds spread it several times over; the ratio reads about 1 for any
    sound bfloat16 program and several times that for float8.  An output
    out of range or not finite makes it inf."""

    def __init__(self):
        self.sq = self.n = self.sq_low = self.n_low = 0.0
        self.bad = False

    def add(self, out: torch.Tensor, ref: torch.Tensor, ref_bf16: torch.Tensor) -> None:
        if out.shape != ref.shape:
            self.bad = True
            return
        sq, n, bad = _live_sq(out, ref)
        sq_low, n_low, _ = _live_sq(ref_bf16, ref)
        self.sq += float(sq.sum())
        self.n += float(n.sum())
        self.sq_low += float(sq_low.sum())
        self.n_low += float(n_low.sum())
        self.bad |= bool(bad.any())

    def value(self) -> float:
        if self.bad or self.n == 0 or self.sq_low == 0:
            return math.inf
        return math.sqrt(self.sq / self.n) / math.sqrt(self.sq_low / self.n_low)


def sync_now(device: torch.device) -> float:
    """The host clock once ``device`` has finished all queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def profiled(run_units: Callable[[], None], device: torch.device, top: int = 10) -> dict:
    """``run_units`` under torch.profiler: the device's busy seconds (the
    union of its activities' intervals), the host's wall seconds around the
    call ending in a synchronise, and the breakdown: the device operations
    that took most time and the idle gaps summed by what the host was doing
    halfway through each (the benchmark's span and the innermost torch
    operation; "host outside torch" for sleeps and NumPy).  Nothing here
    counts events, which the profiler may drop."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":  # the CPU tests: no device to trace
        t0 = time.perf_counter()
        run_units()
        return {"window_s": time.perf_counter() - t0, "busy_s": None}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_units()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = prof.events()
    # the benchmark's own ranges are mirrored on the device as annotations:
    # they are spans, not device work
    device = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                    if e.device_type == DeviceType.CUDA and not e.name.startswith("bench.")
                    and not getattr(e, "is_user_annotation", False))
    if not device:
        return {"window_s": wall_s, "busy_s": None}
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == DeviceType.CPU]
    busy_us, reach, gaps = 0.0, device[0][0], []
    for start, end, _ in device:
        if start > reach:  # a gap, named by what the host did halfway through it
            gaps.append((start - reach, (start + reach) / 2))
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    by_name: Dict[str, float] = {}
    for start, end, name in device:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    def host_at(t: float) -> str:
        active = [(s, n) for s, e, n in host if s <= t < e]
        spans = [n for s, n in sorted(active) if n.startswith("bench.")]
        ops = [n for s, n in sorted(active) if not n.startswith("bench.")]
        return "/".join(([spans[-1]] if spans else []) + ([ops[-1]] if ops else [])) or \
            "host outside torch"

    gap_by_name: Dict[str, float] = {}
    for length, at in sorted(gaps, reverse=True)[:200]:
        name = host_at(at)
        gap_by_name[name] = gap_by_name.get(name, 0.0) + length / 1e6
    idle_gaps = sorted(gap_by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"window_s": wall_s, "busy_s": busy_us / 1e6,
            "breakdown": {"device_ops": [[n[:120], s] for n, s in device_ops],
                          "idle_gaps": [[n[:120], s] for n, s in idle_gaps]}}


def image_source() -> np.ndarray:
    """The benchmark's photograph: (1024, 2048, 3) uint8 RGB, a copy of the
    repository's test image ``tree_sr.png`` stored as a NumPy array."""
    with np.load(BENCH_DIR / "data" / "tree_sr.npz") as data:
        return data["image"]


def seeded_crops(rng: np.random.Generator, image: np.ndarray, n: int, h: int, w: int
                 ) -> np.ndarray:
    """``n`` (h, w) crops of ``image`` at seeded corners, each flipped at
    random across either axis: (n, h, w, 3) uint8."""
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        y = int(rng.integers(0, image.shape[0] - h + 1))
        x = int(rng.integers(0, image.shape[1] - w + 1))
        crop = image[y:y + h, x:x + w]
        if rng.random() < 0.5:
            crop = crop[::-1]
        if rng.random() < 0.5:
            crop = crop[:, ::-1]
        out[i] = crop
    return out


def free_device() -> None:
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def device_peaks(device: torch.device) -> Optional[dict]:
    """The published peaks (``peaks.json``) of ``device``'s kind, or None
    for a device the table does not hold (then no share of a peak is read)."""
    import json

    if device.type != "cuda":
        return None
    with open(BENCH_DIR / "peaks.json") as f:
        return json.load(f).get(torch.cuda.get_device_name(device))
