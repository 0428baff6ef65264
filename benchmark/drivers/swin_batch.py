"""Offline batch super-resolution with SwinIR: batches of LR crops through
``SRPipeline(arch="swinir_l").apply``, back to back, each waited for; the
same job as ``batch.py``'s on another network.

Traffic keys: those of ``batch.py`` (``batch``, ``height``, ``width``,
``distinct_batches``, ``warmup_forwards``, ``check_forwards``,
``profile_forwards``, ``reference_block``).  The compute type is the
configuration's ``dtype``; the traffic's ``dtype`` names it for the reader.

With ``--trace 1`` CUDA events mark, in every forward: the first RSTB's
start and ``conv_after_body``'s end (the ``trunk`` span: the 9 RSTBs, the
final LayerNorm and ``conv_after_body``); ``conv_before_upsample``'s start
and the forward's end (the ``tail`` span: ``conv_before_upsample``, both
upsamplings, the high-resolution and last convs, the crop and clamp); and
the start and end of each call of the window-attention kernel, through the
submodule that wraps the call alone (the ``window_attn`` span, 54 a
forward).  The hooks are found by module names.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.drivers.batch import batch_inputs
from benchmark.harness import (
    Check, Context, GapRatio, Outcome, Spans, free_device, profiled, sync_now,
)
from benchmark.reference import swinir as reference
from benchmark.weights_swinir import swinir_params
from real_esrgan_tpu_torch.serve import SRPipeline

ARCH = "swinir_l"  # SRPipeline's name of the network


def build_pipeline(ctx: Context, params) -> SRPipeline:
    cfg = ctx.config
    pipe = SRPipeline(arch=ARCH, upscale_factor=cfg["upscale"],
                      bfloat16=cfg["dtype"] == "bfloat16", device=ctx.device,
                      **ctx.traffic.get("pipeline", {}))
    for model in pipe.models:
        model.load_state_dict(params)  # strict: the configuration's widths are the program's
    return pipe


def span_hooks(model: torch.nn.Module, spans: Spans) -> list:
    modules = dict(model.named_modules())
    handles = [
        modules["layers.0"].register_forward_pre_hook(lambda *_: spans.mark("trunk_start")),
        modules["conv_after_body"].register_forward_hook(lambda *_: spans.mark("trunk_end")),
        modules["conv_before_upsample"].register_forward_pre_hook(
            lambda *_: spans.mark("tail_start")),
        model.register_forward_hook(lambda *_: spans.mark("tail_end")),
    ]
    for name, module in modules.items():
        if name.endswith(".attn.core"):
            handles += [module.register_forward_pre_hook(lambda *_: spans.mark("attn_start")),
                        module.register_forward_hook(lambda *_: spans.mark("attn_end"))]
    spans.pair("trunk_start", "trunk_end", "trunk")
    spans.pair("tail_start", "tail_end", "tail")
    spans.pair("attn_start", "attn_end", "window_attn")
    return handles


def run(ctx: Context) -> Outcome:
    t, cfg, dev = ctx.traffic, ctx.config, ctx.device
    out = Outcome()
    rng = np.random.default_rng(ctx.seed)
    params = swinir_params(cfg, ctx.seed, dev)
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
    handles = span_hooks(pipe.model, spans) if ctx.trace else []
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
                      * cfg["upscale"] ** 2 / 1e6)
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
