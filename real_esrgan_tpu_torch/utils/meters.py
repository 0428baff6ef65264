"""Console progress meters: the port's copy of real_esrgan_tpu/utils/meters.py.

Per-interval ``name current (avg)`` columns behind an ``Epoch: [N][ i/total]``
prefix.  Meters are small dataclasses holding running statistics; formatting
uses plain ``format()`` specs (e.g. ``"6.3f"``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Literal, Sequence

SummaryMode = Literal["avg", "sum", "count", "none"]


@dataclass
class AverageMeter:
    """Tracks the latest value and a sample-weighted running average."""

    name: str
    spec: str = "f"
    summary_mode: SummaryMode = "avg"
    val: float = 0.0
    sum: float = 0.0
    count: int = 0

    def __post_init__(self):
        # tolerate torch-style ":6.3f" specs
        self.spec = self.spec.lstrip(":")

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def reset(self) -> None:
        self.val, self.sum, self.count = 0.0, 0.0, 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    def __str__(self) -> str:
        return (f"{self.name} {format(self.val, self.spec)}"
                f" ({format(self.avg, self.spec)})")

    def summary(self) -> str:
        if self.summary_mode == "none":
            return ""
        stat = {"avg": self.avg, "sum": self.sum,
                "count": float(self.count)}[self.summary_mode]
        return f"{self.name} {stat:.2f}"


@dataclass
class ProgressMeter:
    """Joins a batch counter and a list of meters into one console line."""

    total_batches: int
    meters: Sequence[AverageMeter] = field(default_factory=list)
    prefix: str = ""

    def _counter(self, batch: int) -> str:
        width = len(str(self.total_batches))
        return f"[{batch:{width}d}/{self.total_batches}]"

    def display(self, batch: int) -> None:
        cols: List[str] = [self.prefix + self._counter(batch)]
        cols.extend(str(m) for m in self.meters)
        print("\t".join(cols), flush=True)

    def display_summary(self) -> None:
        stats = [s for s in (m.summary() for m in self.meters) if s]
        print(" ".join([" *", *stats]), flush=True)
