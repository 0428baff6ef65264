"""The window-attention kernel's share of its roofline: the closed-form
least time of its calls (``workcount_swinir.window_attn_least_seconds``:
q, k and v read once and the output written once over the memory rate,
against the attention's FLOP over the dtype's peak) over the device time
between CUDA events around each call, summed over the window's forwards."""

from benchmark.harness import device_peaks
from benchmark.workcount_swinir import window_attn_least_seconds


def read(outcome, ctx):
    peaks = device_peaks(ctx.device)
    attn_ms = outcome.spans_ms.get("window_attn")
    if not peaks or not attn_ms:
        return None
    v, cfg = outcome.values, ctx.config
    tokens = v["batch"] * v["height"] * v["width"]
    least = sum(cfg["depths"]) * window_attn_least_seconds(cfg, tokens, peaks)
    return 100.0 * least * v["forwards"] / (attn_ms / 1e3)
