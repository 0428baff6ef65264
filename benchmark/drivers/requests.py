"""Single images through ``SRPipeline.upscale`` (float32 NumPy in and out),
in an open loop: each request is sent when it is due, or at once when the
one before it returns late, and timed from when it was due to its return.

Traffic keys: ``rate_per_s`` (Poisson arrivals; the window holds
``round(rate * seconds)`` requests), ``side_min`` / ``side_max`` (height
and width log-uniform on that range, drawn apart), ``pipeline`` (the
serving settings handed to ``SRPipeline``), ``check_requests`` (requests
kept for the reference, drawn from the seed, with the largest among them)
and ``profile_requests`` (the profiled sub-window of a traced run).

The schedule is the same for every seed: the sizes and the gaps between
arrivals are the quantiles of the two distributions at (i + 0.5) / n, paired
and ordered by a fixed draw.  The seed draws each image's content (where
it is cut from the photograph, and a flip) and the weights.  With the order
drawn from the seed, where the large requests fall among the bursts moved
the p95 by a third between seeds on an H100 (353-645 ms on six seeds, each
repeating within 7%; PERF.md).  Set-up warms each distinct shape the
schedule holds: each padded bucket, and each tile grid."""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from benchmark.drivers.batch import build_pipeline
from benchmark.harness import (
    Check, Context, GapRatio, Outcome, free_device, image_source, profiled, sync_now,
)
from benchmark.reference import generator as reference
from benchmark.reference.serve import serve as reference_serve
from benchmark.weights import generator_params


SCHEDULE_SEED = 0  # the draw that pairs and orders the sizes and gaps, for every run


def schedule(traffic: dict, seed: int, seconds: float, image: np.ndarray) -> list:
    """[(due seconds from the window's start, (h, w, 3) float32 image)]."""
    fixed = np.random.default_rng(SCHEDULE_SEED)
    rate = traffic["rate_per_s"]
    n = max(1, round(rate * seconds))
    q = (np.arange(n) + 0.5) / n
    lo, hi = math.log(traffic["side_min"]), math.log(traffic["side_max"])
    sides = np.rint(np.exp(lo + q * (hi - lo))).astype(int)
    heights, widths = fixed.permutation(sides), fixed.permutation(sides)
    due = np.cumsum(fixed.permutation(-np.log1p(-q) / rate))
    rng = np.random.default_rng(seed)
    out = []
    for t, h, w in zip(due, heights, widths):
        y = int(rng.integers(0, image.shape[0] - h + 1))
        x = int(rng.integers(0, image.shape[1] - w + 1))
        crop = image[y:y + h, x:x + w]
        if rng.random() < 0.5:
            crop = crop[:, ::-1]
        out.append((float(t), np.ascontiguousarray(crop, np.float32) / np.float32(255.0)))
    return out


def sample_indices(requests: list, seed: int, k: int) -> set:
    """The requests the reference judges: ``k`` drawn from the seed, and the
    largest."""
    rng = np.random.default_rng([seed, 1])
    largest = max(range(len(requests)), key=lambda i: requests[i][1].shape[0]
                  * requests[i][1].shape[1])
    return set(rng.choice(len(requests), min(len(requests), k), replace=False).tolist()) | {
        largest}


def shape_key(pipe, image: np.ndarray) -> tuple:
    """What fixes the shapes a request runs: its padded bucket, or its tile grid."""
    h, w, _ = image.shape
    if max(h, w) > pipe.tile_threshold:
        core = pipe.tile - 2 * pipe.tile_overlap
        return ("tiles", math.ceil(h / core), math.ceil(w / core))
    return ("bucket", math.ceil(h / pipe.bucket), math.ceil(w / pipe.bucket))


def is_tiled(pipe, image: np.ndarray) -> bool:
    return max(image.shape[:2]) > pipe.tile_threshold


def open_loop(pipe, requests, keep=frozenset(), label: str = "bench.request") -> dict:
    """Sends ``requests`` on their schedule, one at a time; returns each
    request's latency from due to return, service time, how late it was
    sent, and the outputs of the indices in ``keep``."""
    latency, service, late, kept, failed = [], [], [], {}, 0
    start = time.perf_counter()
    for i, (due, image) in enumerate(requests):
        wait = start + due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        sent = time.perf_counter()
        try:
            with torch.profiler.record_function(label):
                sr = pipe.upscale(image)
        except RuntimeError as exc:  # a failed request counts as missing
            print(f"request {i} failed: {exc}", file=sys.stderr)
            failed += 1
            sr = None
        done = time.perf_counter()
        latency.append(done - start - due if sr is not None else math.inf)
        service.append(done - sent)
        late.append(sent - start - due)
        if i in keep and sr is not None:
            kept[i] = sr
    return {"latency": latency, "service": service, "late": late, "kept": kept,
            "failed": failed, "end": time.perf_counter(), "start": start}


def run(ctx: Context) -> Outcome:
    t, cfg, dev = ctx.traffic, ctx.config, ctx.device
    out = Outcome()
    params = generator_params(cfg, ctx.seed, dev)
    sync_now(dev)
    ctx.lap("weights")
    pipe = build_pipeline(ctx, params)
    ctx.lap("pipeline")
    requests = schedule(t, ctx.seed, ctx.seconds, image_source())
    sample = sample_indices(requests, ctx.seed, t["check_requests"])
    ctx.lap("inputs")
    firsts = {}
    for _, image in requests:
        firsts.setdefault(shape_key(pipe, image), image)
    for i, image in enumerate(firsts.values()):
        pipe.upscale(image)
        sync_now(dev)
        ctx.lap("first_forward" if i == 0 else "warmup")

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out.setup_s = ctx.lap("warmup") - ctx.t_start
    loop = open_loop(pipe, requests, keep=sample)
    out.window_s = loop["end"] - loop["start"]
    tiled = [is_tiled(pipe, image) for _, image in requests]
    out.attempted, out.failed = len(requests), loop["failed"]
    out.values.update(
        latency_s=loop["latency"],
        service_s_tiled=[s for s, k in zip(loop["service"], tiled) if k],
        service_s_untiled=[s for s, k in zip(loop["service"], tiled) if not k])
    late = sorted(loop["late"])
    print(f"generator: {len(requests)} requests, {len(firsts)} shapes warmed, "
          f"sent late by p50 {late[len(late) // 2] * 1e3:.3f} ms, max {late[-1] * 1e3:.3f} ms "
          f"(the server was busy), tiled share {sum(tiled) / len(tiled):.3f}", file=sys.stderr)
    if ctx.trace:
        head = requests[:t["profile_requests"]]
        out.profile = profiled(lambda: open_loop(pipe, head), dev)
    if dev.type == "cuda":
        out.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)

    serving = dict(bucket=pipe.bucket, tile_threshold=pipe.tile_threshold, tile=pipe.tile,
                   overlap=pipe.tile_overlap)
    del pipe
    free_device()
    reference.plain_float32()
    gap = GapRatio()
    if len(loop["kept"]) < len(sample):
        gap.bad = True  # a judged request never came back
    for i, sr in loop["kept"].items():
        image = requests[i][1]
        gap.add(torch.from_numpy(sr)[None],
                torch.from_numpy(reference_serve(params, image, cfg, dev, **serving))[None],
                torch.from_numpy(reference_serve(params, image, cfg, dev, **serving,
                                                 dtype=torch.bfloat16))[None])
    out.checks.append(Check("out_err_ratio", gap.value(), ctx.limits["out_err_ratio"]))
    return out
