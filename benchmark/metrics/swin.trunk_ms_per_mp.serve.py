"""Device milliseconds of the Swin trunk (the first RSTB's start to
``conv_after_body``'s end: 9 RSTBs, the final LayerNorm, ``conv_after_body``)
an output megapixel, over the window."""


def read(outcome, ctx):
    trunk_ms = outcome.spans_ms.get("trunk")
    mp = outcome.values.get("output_mp")
    return trunk_ms / mp if trunk_ms and mp else None
