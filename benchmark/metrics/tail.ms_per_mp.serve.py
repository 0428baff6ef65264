"""Device milliseconds of the generator's tail (trunk end to forward end:
the trunk conv and residual, both upsamplings, the high-resolution and last
convs, the clamp) an output megapixel, over the window."""


def read(outcome, ctx):
    tail_ms = outcome.spans_ms.get("tail")
    mp = outcome.values.get("output_mp")
    return tail_ms / mp if tail_ms and mp else None
