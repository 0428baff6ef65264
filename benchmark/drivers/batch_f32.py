"""``batch.py``'s offline batch job with the program computing in the
traffic's ``dtype`` (float32: the ``inference`` and ``test`` CLIs' default)
in place of the configuration's.  The run's configuration is replaced by one
with that dtype before ``batch.run``, so the pipeline, the judge and the
metrics (the peak a share is read against, the bytes a roofline counts) all
see the dtype that ran.  The limit's denominator stays the reference's
bfloat16 composition, so the float32 program reads far below 1 and a
program that computes in bfloat16 reads about 1."""

from __future__ import annotations

from benchmark.drivers import batch
from benchmark.harness import Context, Outcome


def run(ctx: Context) -> Outcome:
    ctx.config = dict(ctx.config, dtype=ctx.traffic["dtype"])
    return batch.run(ctx)
