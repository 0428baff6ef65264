"""The whole forward's share of the chip's peak: closed-form model FLOP of
the window's forwards (``workcount.forward_flop``) over the window's
seconds, against the peak of the configuration's dtype."""

from benchmark.harness import device_peaks
from benchmark.workcount import forward_flop


def read(outcome, ctx):
    peaks = device_peaks(ctx.device)
    v = outcome.values
    if not peaks or not v.get("forwards"):
        return None
    flop = v["forwards"] * forward_flop(ctx.config, v["batch"], v["height"], v["width"])
    return 100.0 * flop / outcome.window_s / peaks["flops"][ctx.config["dtype"]]
