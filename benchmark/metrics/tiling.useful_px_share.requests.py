"""Percent of the pixels the generator ran in tiled requests that the
images hold, read from the program's span records: the counters
``px_useful`` (h x w) over ``px_run`` (the tiles' pixels, counted at the
generator's call), summed over the window's tiled requests
(``benchmark/program_spans.py``)."""

from benchmark.program_spans import useful_px_share


def read(outcome, ctx):
    return useful_px_share(outcome, tiled=True)
