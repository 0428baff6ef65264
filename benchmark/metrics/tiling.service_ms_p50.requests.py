"""Median host milliseconds of ``SRPipeline.upscale`` (service, queueing
excluded) over the window's tiled requests (``parallel/tiling.py``)."""

import statistics


def read(outcome, ctx):
    times = outcome.values.get("service_s_tiled")
    return statistics.median(times) * 1e3 if times else None
