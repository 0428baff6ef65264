"""Nearest-rank 95th percentile of every request of the window, each timed
from when it was due to the return of ``SRPipeline.upscale``; a failed
request counts as infinitely late."""

from benchmark.harness import percentile_nearest_rank


def read(outcome, ctx):
    latencies = outcome.values.get("latency_s")
    return percentile_nearest_rank(latencies, 95) * 1e3 if latencies else None
