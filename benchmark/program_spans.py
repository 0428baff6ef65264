"""The program's own records of the requests cell's window: the request
spans and work counters that ``real_esrgan_tpu_torch.utils.profiling`` keeps
in memory, one record a call of ``SRPipeline.upscale`` (root span
``serve.upscale``).

The window is the last ``outcome.attempted`` records that no profiler was
active for: the warm-ups come before it, and the traced run's profiled
requests after it, flagged.  Where the records of one kind (untiled or
tiled) do not number as the driver's service times of that kind, the window
is not aligned and no record is given; so is it for a program that keeps no
spans."""

from __future__ import annotations

from typing import List, Optional

# the stages that block on the device: the copy out of an untiled and of a
# tiled request
WAITS = ("serve.wait", "tiling.wait")


def window(outcome, tiled: bool) -> Optional[List]:
    """The window's records of tiled (or untiled) requests, or None."""
    from real_esrgan_tpu_torch.utils import profiling

    requests = getattr(profiling, "requests", None)
    if requests is None:
        return None
    records = [r for r in requests() if r.name == "serve.upscale" and not r.profiled]
    n = outcome.attempted
    if not n or len(records) < n:
        return None
    chosen = [r for r in records[-n:] if bool(r.tiled) == tiled]
    times = outcome.values.get("service_s_tiled" if tiled else "service_s_untiled") or []
    return chosen if chosen and len(chosen) == len(times) else None


def host_ns(record) -> int:
    """A request's wall time outside the call that blocks on the device: the
    root span less its ``WAITS``.  The forward's enqueue, inside it,
    overlaps the device's work, so this is not time the device idles."""
    return record.duration_ns - sum(record.stages.get(name, 0) for name in WAITS)


def host_ms_p50(outcome, tiled: bool) -> Optional[float]:
    """Median milliseconds of ``host_ns`` over the window's requests."""
    import statistics

    records = window(outcome, tiled)
    return statistics.median(host_ns(r) for r in records) / 1e6 if records else None


def useful_px_share(outcome, tiled: bool) -> Optional[float]:
    """Percent of the input pixels the generator ran that the images hold:
    the sum of ``px_useful`` over the sum of ``px_run``."""
    records = window(outcome, tiled)
    if not records:
        return None
    return 100.0 * sum(r.px_useful for r in records) / sum(r.px_run for r in records)
