"""The dense blocks' share of their roofline: the closed-form least time of
the trunk's 3 x num_block dense blocks (``workcount.dense_block_least_seconds``)
over the device time from the first block's start to the last block's end,
summed over the window's forwards.  The RRDBs' residual adds fall inside."""

from benchmark.harness import device_peaks
from benchmark.workcount import dense_block_least_seconds, trunk_pixels


def read(outcome, ctx):
    peaks = device_peaks(ctx.device)
    rdb_ms = outcome.spans_ms.get("rdb")
    if not peaks or not rdb_ms:
        return None
    v = outcome.values
    px = trunk_pixels(ctx.config, v["batch"] * v["height"] * v["width"])
    least = 3 * ctx.config["num_block"] * dense_block_least_seconds(ctx.config, px, peaks)
    return 100.0 * least * v["forwards"] / (rdb_ms / 1e3)
