"""Output megapixels completed in the window over the window's seconds
(the window closed by a synchronise)."""


def read(outcome, ctx):
    mp = outcome.values.get("output_mp")
    return mp / outcome.window_s if mp else None
