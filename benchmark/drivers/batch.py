"""Offline batch super-resolution: batches of LR crops through
``SRPipeline.apply``, back to back, each waited for.

Traffic keys: ``batch``, ``height``, ``width`` (the input batch),
``distinct_batches`` (made from the seed before the window and used in
turn), ``warmup_forwards``, ``check_forwards`` (outputs kept for the
reference, drawn from the seed over the whole window by reservoir
sampling), ``profile_forwards`` (the profiled sub-window of a traced run)
and ``reference_block`` (images a reference forward).

With ``--trace 1`` CUDA events mark, in every forward, the first dense
block's start and the last one's end (the ``rdb`` span: the 3 x
``num_block`` dense blocks, with the RRDBs' residual adds between them) and
the trunk's end to the forward's end (the ``tail`` span: the trunk conv and
residual, both upsamplings, the high-resolution and last convs, the clamp).
The hooks are found by the state dict's module names.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import (
    Check, Context, GapRatio, Outcome, Spans, free_device, image_source, profiled,
    seeded_crops, sync_now,
)
from benchmark.reference import generator as reference
from benchmark.weights import generator_params
from real_esrgan_tpu_torch.serve import SRPipeline


def build_pipeline(ctx: Context, params) -> SRPipeline:
    cfg = ctx.config
    if (cfg["num_feat"], cfg["num_grow_ch"], cfg["num_in_ch"], cfg["num_out_ch"]) != \
            (64, 32, 3, 3):
        raise ValueError("SRPipeline serves 64 features, growth 32 and RGB")
    pipe = SRPipeline(upscale_factor=cfg["scale"], num_rrdb=cfg["num_block"],
                      bfloat16=cfg["dtype"] == "bfloat16", device=ctx.device,
                      **ctx.traffic.get("pipeline", {}))
    for model in pipe.models:
        model.load_state_dict(params)
    return pipe


def trunk_hooks(model: torch.nn.Module, cfg: dict, spans: Spans) -> list:
    modules = dict(model.named_modules())
    last = f"trunk.{cfg['num_block'] - 1}"
    handles = [
        modules["trunk.0.rdb1"].register_forward_pre_hook(lambda *_: spans.mark("rdb_start")),
        modules[f"{last}.rdb3"].register_forward_hook(lambda *_: spans.mark("rdb_end")),
        modules[last].register_forward_hook(lambda *_: spans.mark("tail_start")),
        model.register_forward_hook(lambda *_: spans.mark("tail_end")),
    ]
    spans.pair("rdb_start", "rdb_end", "rdb")
    spans.pair("tail_start", "tail_end", "tail")
    return handles


def batch_inputs(ctx: Context, rng: np.random.Generator) -> torch.Tensor:
    """(distinct_batches, batch, height, width, 3) float32 crops on the device."""
    t = ctx.traffic
    crops = seeded_crops(rng, image_source(), t["distinct_batches"] * t["batch"],
                         t["height"], t["width"])
    return (torch.from_numpy(crops).to(ctx.device).float() / 255.0).reshape(
        t["distinct_batches"], t["batch"], t["height"], t["width"], 3)


def run(ctx: Context) -> Outcome:
    t, cfg, dev = ctx.traffic, ctx.config, ctx.device
    out = Outcome()
    rng = np.random.default_rng(ctx.seed)
    params = generator_params(cfg, ctx.seed, dev)
    sync_now(dev)
    ctx.lap("weights")
    pipe = build_pipeline(ctx, params)
    ctx.lap("pipeline")
    inputs = batch_inputs(ctx, rng)
    sync_now(dev)
    ctx.lap("inputs")
    for i in range(t["warmup_forwards"]):
        pipe.apply(inputs[i % len(inputs)])
        sync_now(dev)
        ctx.lap("first_forward" if i == 0 else "warmup")

    spans = Spans(dev)
    handles = trunk_hooks(pipe.model, cfg, spans) if ctx.trace else []
    kept, n = [], 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    start = ctx.lap("warmup")
    out.setup_s = start - ctx.t_start
    while time.perf_counter() - start < ctx.seconds:
        with torch.profiler.record_function("bench.forward"):
            sr = pipe.apply(inputs[n % len(inputs)])
        sync_now(dev)
        # reservoir sampling: each forward of the window equally likely kept
        if len(kept) < t["check_forwards"]:
            kept.append((n, sr))
        else:
            j = int(rng.integers(0, n + 1))
            if j < t["check_forwards"]:
                kept[j] = (n, sr)
        del sr
        n += 1
    out.window_s = sync_now(dev) - start
    for h in handles:
        h.remove()
    out.spans_ms = spans.totals_ms() if ctx.trace else {}
    out.attempted = n * t["batch"]
    out.values.update(forwards=n, batch=t["batch"], height=t["height"], width=t["width"],
                      output_mp=n * t["batch"] * t["height"] * t["width"]
                      * cfg["scale"] ** 2 / 1e6)
    if ctx.trace:
        def units():
            for i in range(t["profile_forwards"]):
                with torch.profiler.record_function("bench.forward"):
                    pipe.apply(inputs[i % len(inputs)])
                sync_now(dev)
        out.profile = profiled(units, dev)
    if dev.type == "cuda":
        out.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)

    del pipe
    free_device()
    out.checks.append(Check("out_err_ratio", judge(ctx, params, inputs, kept),
                            ctx.limits["out_err_ratio"]))
    return out


def judge(ctx: Context, params, inputs, kept) -> float:
    """``GapRatio`` of the kept forwards against the plain reference on the
    same inputs and weights."""
    reference.plain_float32()
    gap = GapRatio()
    block = ctx.traffic["reference_block"]
    for n, sr in kept:
        x = inputs[n % len(inputs)]
        gap.add(sr, reference.forward_in_blocks(params, x, ctx.config, block),
                reference.forward_in_blocks(params, x, ctx.config, block, dtype=torch.bfloat16))
    return gap.value()
