"""Median host milliseconds of ``SRPipeline.upscale`` (service, queueing
excluded) over the window's requests that were not tiled."""

import statistics


def read(outcome, ctx):
    times = outcome.values.get("service_s_untiled")
    return statistics.median(times) * 1e3 if times else None
