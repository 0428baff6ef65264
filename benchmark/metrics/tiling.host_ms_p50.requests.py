"""Median milliseconds of a tiled request's time before the call that
blocks on the device (and after it), read from the program's spans:
``serve.upscale`` less its ``tiling.wait`` (the copy out), over the window's
tiled requests (``benchmark/program_spans.py``).  The tile batches' enqueue
is inside it and overlaps the device's work: wall time on the host, not
time the device idles."""

from benchmark.program_spans import host_ms_p50


def read(outcome, ctx):
    return host_ms_p50(outcome, tiled=True)
