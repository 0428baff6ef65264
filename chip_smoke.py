#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``real_esrgan_tpu_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, no arguments

1. prints the card's name and power limit, as nvidia-smi gives them;
2. builds the CUDA kernels of the port from ``real_esrgan_tpu_torch/csrc``
   with nvcc (one process a source, all at once), printing each source's
   build seconds, registers, spills and shared memory, the tensor-core, TMA,
   mbarrier and shared-memory instructions of each kernel as ``cuobjdump
   -sass`` shows them (the bf16 RDB kernel, every ``mm_grid``, every
   ``mm_resident`` and every ``conv3x3`` kernel must have ``HGMMA`` and
   ``UTMALDG`` and no ``HMMA``, the f32 RDB kernel ``HMMA``; neither RDB
   kernel, nor ``conv3x3``, nor ``mm_resident`` may have ``LDL``/``STL``; no
   build may warn C7520, serialised ``wgmma``), the RDB kernels' block plan
   (``rdb_plan``: tile, threads, shared memory, ring), ``mm_grid``'s and
   ``mm_resident``'s at the gate's shapes (``mm_grid_plan``,
   ``mm_resident_plan``) and ``conv3x3``'s at the tool's default shape
   (``conv3x3_plan``), each beside what the built library reports;
3. drives the x4 serving path: ``SRPipeline`` with
   ``assets/inenv10_esrnet_ema.npz`` answers requests in bfloat16 and in
   float32 (the whole test image, a bucketed crop, a tiled wide image, and
   the ragged crop the committed JAX golden output covers), with every
   kernel's launch count set to 0 just before and read just after, and the
   shape of every input the RDB kernel gets recorded; one more forward of
   the test image in each dtype keeps the inputs of all 69 RDBs;
4. checks the outputs: finite, in [0, 1], the f32 crop within 1e-4 of the
   JAX golden output, the bf16 crop's PSNR against it, and the tiled image's
   interior seam error against a whole-image forward; profiles one warm
   forward of the test image (device busy time, idle share, time by kernel);
5. drives the conv/matmul experiment tool (``tools/conv_exp.py``: default
   run, ``--mm``, ``--gate``, and the ``mm_grid`` probe) on the card, with the
   launch counts of ``conv3x3``, ``mm_grid`` and ``mm_resident`` set to 0
   just before and read just after, and holds those three kernels against
   their plain versions at every shape that run gave them, smaller and
   ragged ones, and ``mm_grid``, ``mm_resident`` and ``conv3x3`` to exact
   one-hot probes of their operand layouts (and ``mm_resident``'s k split);
6. drives the evaluation path: ``real_esrgan_tpu_torch.test`` (float32 and
   ``--bfloat16``) and ``scripts.eval_pair`` on three crops of the test
   image, recording the RDB kernel's input shapes here too, and NIQE of
   ``tests/data/tree_sr.png`` on the card against the committed JAX score
   and against the port's own CPU score, with TF32 allowed, so a filter that
   fell into TF32 would fail here;
7. holds the RDB kernel against its plain PyTorch version on the card, with
   the trained weights of several RDBs, at every shape the serving and the
   evaluation path gave it in each dtype, a ragged batch, a block smaller
   than a tile and a batch of three ragged images, and in each dtype on the
   real inputs of all 69 RDBs kept in step 3 (|x| up to about 59, where the
   f32 kernel's three bf16 products have the least room), and checks that
   it raises under autograd (it has no backward);
8. drives the second-order degradation (``ops/degradation.py``, stock
   PyTorch ops, no kernel of its own) under PyTorch's default TF32 flags:
   at the CLI's geometry (hr 400 -> crop 256, batch 8) one CPU draw for
   each (up1, up2) applied on the CPU and on the card, and the JAX golden
   ``tests/data/jax_degrade_b2_hr128.npz`` applied on the card (at least 99%
   of the 8-bit LR values equal, LR PSNR >= 50 dB, HR crops bit-identical);
   ``python -m real_esrgan_tpu_torch.scripts.make_degraded_eval`` on the
   card on the 10 tiles of ``tests/data/tree_sr.png`` (10 aligned pairs,
   each degraded), scored by ``eval_pair`` with ``--bicubic`` and with the
   committed weights; ``degrade`` (draw + apply) timed per batch at batch 8
   and 48 for each (up1, up2), one batch of each size profiled, and the
   port's bf16 blur timed beside cuDNN's at batch 48;
9. times each kernel against its plain version, its bound and, where one
   PyTorch call computes the same function, that call (K1 and its plain
   version, K2 and cuDNN, K3, K4 and cuBLAS also inside a CUDA graph,
   without the host's gaps), and prints
   one JSON line ``{"kernels": [...]}``; the last line is
   ``{"ok": true, "device": {...}}``.

Every check raises on failure, so the script exits non-zero and prints no
result; without CUDA it exits non-zero at once.  f32 phases run with TF32
off, the degradation with PyTorch's defaults.  Needs one GPU and no network.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from real_esrgan_tpu_torch import configuration as degrade_cfg
from real_esrgan_tpu_torch import test as test_cli
from real_esrgan_tpu_torch.metrics.niqe import NIQE, niqe_features
from real_esrgan_tpu_torch.models.rrdbnet import ResidualDenseBlock
from real_esrgan_tpu_torch.ops import _build
from real_esrgan_tpu_torch.ops.degradation import (
    apply_degradation, degrade, draw_degradation, draws_from_arrays,
)
from real_esrgan_tpu_torch.ops.conv3x3 import (
    built_conv3x3_plan, conv3x3, conv3x3_plain, conv3x3_plan,
)
from real_esrgan_tpu_torch.ops.fused_rdb import (
    BUILT_PLAN_KEYS, box_rdb_weights, built_rdb_plan, fused_rdb, pack_rdb_weights, rdb_plain,
    rdb_plan, split_rdb_weights,
)
from real_esrgan_tpu_torch.ops.mm_probe import (
    RESIDENT_MAX_K_BOXES, RESIDENT_WIDTHS, built_mm_grid_plan, built_mm_resident_plan, mm_grid,
    mm_grid_plain, mm_grid_plan, mm_resident, mm_resident_plain, mm_resident_plan,
)
from real_esrgan_tpu_torch.ops.resize import matlab_resize
from real_esrgan_tpu_torch.scripts import eval_pair, make_degraded_eval
from real_esrgan_tpu_torch.serve import SRPipeline
from real_esrgan_tpu_torch.tools import conv_exp
from real_esrgan_tpu_torch.train.checkpoint import load_generator_params
from real_esrgan_tpu_torch.utils.imgio import load_image_rgb, read_png, write_png

ROOT = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(ROOT, "assets", "inenv10_esrnet_ema.npz")
TREE = os.path.join(ROOT, "tests", "data", "tree_lr.png")
GOLDEN = os.path.join(ROOT, "tests", "data", "jax_sr_tree_crop67x93_f32.npy")
TREE_SR = os.path.join(ROOT, "tests", "data", "tree_sr.png")
NIQE_GOLDEN = os.path.join(ROOT, "tests", "data", "jax_niqe_tree_sr.json")
DEGRADE_GOLDEN = os.path.join(ROOT, "tests", "data", "jax_degrade_b2_hr128.npz")
CROP = (slice(64, 131), slice(128, 221))  # the golden file's input crop

RDBS_PER_FORWARD = 69  # 23 RRDBs x 3 RDBs
# 2 * 9 * (64*32 + 96*32 + 128*32 + 160*32 + 192*64) FLOP per pixel
RDB_FLOP_PER_PIXEL = 479_232
RDB_WEIGHTS = RDB_FLOP_PER_PIXEL // 2
# H100 SXM, NVIDIA data sheet: dense bf16 tensor-core rate, f32 rate on the
# CUDA cores, HBM3 rate.  K1 runs on the tensor cores in both dtypes: bf16 as
# it is (wgmma), f32 as three bf16 products (hi*hi + hi*lo + lo*hi), so its operation
# bound is PRODUCTS x its FLOPs at the bf16 rate; the f32 record gives beside
# it the bound of the same FLOPs on the CUDA cores.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_CUDA_CORE_FLOPS = 67e12
PRODUCTS = {torch.bfloat16: 1, torch.float32: 3}
PEAK_BYTES = 3.35e12
CHECK_RDBS = ("trunk.0.rdb1", "trunk.11.rdb2", "trunk.22.rdb3")
TOLERANCE = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-2, 2e-2)}  # atol, rtol
DTYPE_NAME = {torch.float32: "f32", torch.bfloat16: "bf16"}
# K1's kernels in csrc/fused_rdb.cu, as the profiler names them
RDB_KERNEL_NAMES = ("rdb_bf16_wgmma_kernel", "rdb_f32_split_kernel")
# the kernels sass_counts names, by the name in their mangled symbols
KERNEL_NAMES = RDB_KERNEL_NAMES + ("mm_grid_kernel", "mm_resident_kernel", "conv3x3_kernel")
# SASS instructions counted per kernel: tensor cores (HMMA: mma.sync; HGMMA:
# wgmma), ldmatrix, cp.async, TMA loads, mbarrier operations, barriers,
# local memory
SASS_OPS = ("HMMA", "HGMMA", "LDSM", "LDGSTS", "UTMALDG", "SYNCS", "BAR", "LDL", "STL")
# mm_grid's ragged edges beyond the tool's shapes: k = 96 (a chunk past k)
# with m = 64, n = 32 (a 64-wide block past n), n = 160 (192-wide)
MM_RAGGED_SHAPES = ((64, 96, 192), (128, 64, 32), (128, 96, 160))
# beyond the main paths' shapes: a ragged batch, a block smaller than a tile
# (fragment tail and clamp), three ragged images (masks at T=16, batch index)
K1_EXTRA_SHAPES = {(2, 67, 93, 64), (1, 5, 3, 64), (3, 17, 40, 64)}
# interior seam error of the bf16 tiled output against a whole-image forward,
# 8-bit levels: bf16 rounding gives a max near 5 and a mean near 0.12; a tile
# computed wrong gives far more
SEAM_LIMIT = {"max": 16.0, "mean": 0.5}
KERNEL_SOURCES = ("fused_rdb", "conv3x3", "mm_probe")
CONV_SHAPE = (8, 256, 256, 64, 192, 32)  # the tool's default: B, H, W, Cin, Cout, tile
# K2's shapes beside the tool's default ((B, H, W, Cin), Cout, tile): Cin = 32
# (zeros past Cin), W = 48 and Cout = 64 (the 64-wide kernel)
CONV_EXTRA_SHAPES = (((2, 64, 48, 32), 96, 16), ((1, 64, 48, 64), 64, 16))
# K2's one-hot probes: ((B, H, W, Cin), Cout, tile), each at all nine taps
CONV_PROBE_SHAPES = (((1, 64, 48, 64), 64, 16), ((2, 16, 32, 32), 96, 8),
                     ((1, 16, 32, 64), 192, 8))
MM_REPS = 32
# K4's one-hot probes: the k of each (64 a box, split between the two
# warpgroups in the middle of one at 192 and 576) and the reps
RESIDENT_PROBE_K = (192, 576)
RESIDENT_PROBE_REPS = (1, MM_REPS)
BF16_TOLERANCE = TOLERANCE[torch.bfloat16]
# crops of the test image the evaluation path scores: (top, left, height, width)
EVAL_CROPS = {"a_64x64.png": (0, 0, 64, 64), "b_96x128.png": (100, 200, 96, 128),
              "c_50x70.png": (30, 400, 50, 70)}
# the degradation: the CLI's geometry (hr 400 -> crop 256, x4) at its batch
# of 8 and at the trainer's batch of 48 (TrainConfig.batch_size); each
# (up1, up2) combination picks its own canvases
DEGRADE_GEO = degrade_cfg.PipelineGeometry(hr_size=400, crop_size=256, scale=4)
DEGRADE_BATCHES = (8, 48)
UP_FLAGS = ((False, False), (False, True), (True, False), (True, True))
# card against the port's CPU on the same draws, and against the JAX golden:
# 8-bit LR values equal, LR PSNR, HR crops bit-identical
DEGRADE_LR_EQUAL_SHARE, DEGRADE_LR_PSNR_DB = 0.99, 50.0
DEGRADE_WARMUP, DEGRADE_TIMED = 3, 10


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def rdb_pack(state_dict, name: str, dtype: torch.dtype):
    convs = [(state_dict[f"{name}.conv{k}.weight"], state_dict[f"{name}.conv{k}.bias"])
             for k in range(1, 6)]
    packed = pack_rdb_weights([w for w, _ in convs], [b for _, b in convs], 64, 32, dtype)
    return [t.cuda() for t in packed]


def kernel_name(symbol: str) -> str:
    """A kernel's name from its mangled symbol, with its integer template
    arguments: ``mm_grid_kernel<192>``, ``conv3x3_kernel<96,1>``."""
    base = next((k for k in KERNEL_NAMES if k in symbol), symbol)
    args = re.search(rf"{base}I((?:Li\d+E)+)E", symbol)
    if args is None:
        return base
    return f"{base}<{','.join(re.findall(r'Li(-?\d+)E', args.group(1)))}>"


def sass_counts(name: str) -> dict:
    """The SASS_OPS instructions of each kernel in the built library, as
    ``cuobjdump -sass`` lists them (whole words: HMMA does not match HGMMA);
    empty where the toolkit lacks cuobjdump."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(_build.library_path(name))], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            kernel = kernel_name(found.group(1))
            counts[kernel] = dict.fromkeys(SASS_OPS, 0)
        elif kernel is not None:
            for op in counts[kernel]:
                counts[kernel][op] += bool(re.search(rf"\b{op}\b", line))
    return counts


def build_kernels() -> None:
    """Builds every kernel source anew, all at once, so the build times and
    the ptxas lines printed are this run's."""
    for name in KERNEL_SOURCES:
        _build.library_path(name).unlink(missing_ok=True)
    t0 = time.perf_counter()
    _build.build_all(KERNEL_SOURCES)
    wall = time.perf_counter() - t0
    for name in KERNEL_SOURCES:
        log = _build.BUILD_LOG[name]
        emit(build={name: {"nvcc_seconds": round(log["seconds"], 3),
                           "ptxas": [line.strip() for line in log["log"].splitlines()
                                     if re.search(r"Used \d+ registers|spill|entry function|C7520",
                                                  line)]}})
        check("C7520" not in log["log"], f"ptxas serialised wgmma in {name}.cu (C7520)")
    emit(build_wall_seconds=round(wall, 3))
    sass = {name: sass_counts(name) for name in KERNEL_SOURCES}
    emit(sass=sass)
    if sass["fused_rdb"]:
        check(sorted(sass["fused_rdb"]) == sorted(RDB_KERNEL_NAMES),
              f"fused_rdb.cu builds {sorted(sass['fused_rdb'])}, not {RDB_KERNEL_NAMES}")
    for kernel, ops in sass["fused_rdb"].items():
        check(ops["LDL"] + ops["STL"] == 0, f"{kernel} uses local memory: {ops}")
    f32_rdb = sass["fused_rdb"].get("rdb_f32_split_kernel", {"HMMA": 1})
    check(f32_rdb["HMMA"] > 0, f"rdb_f32_split_kernel is not an mma.sync kernel: {f32_rdb}")
    hopper = {k: v for name in ("mm_probe", "conv3x3", "fused_rdb") for k, v in sass[name].items()
              if k.startswith(("mm_grid_kernel", "mm_resident_kernel", "conv3x3_kernel",
                               "rdb_bf16_wgmma_kernel"))}
    built = sorted(k.split("<")[0] for k in hopper)
    resident_instances = len(RESIDENT_WIDTHS) * RESIDENT_MAX_K_BOXES  # (BN, k boxes)
    check(not sass["mm_probe"] or built == ["conv3x3_kernel"] * 5 + ["mm_grid_kernel"] * 4
          + ["mm_resident_kernel"] * resident_instances + ["rdb_bf16_wgmma_kernel"],
          f"TMA + wgmma kernels built: {sorted(hopper)}")
    for kernel, ops in hopper.items():
        check(ops["HGMMA"] > 0 and ops["UTMALDG"] > 0 and ops["HMMA"] == 0,
              f"{kernel} is not a TMA + wgmma kernel: {ops}")
        check(not kernel.startswith(("conv3x3", "mm_resident")) or ops["LDL"] + ops["STL"] == 0,
              f"{kernel} uses local memory: {ops}")
    rdb_blocks = {DTYPE_NAME[d]: {**rdb_plan(d), "built": built_rdb_plan(d)} for d in TOLERANCE}
    emit(fused_rdb_blocks=rdb_blocks)
    for name, plan in rdb_blocks.items():
        stated = {key: plan[key] for key in BUILT_PLAN_KEYS}
        check(plan["built"] == stated,
              f"fused_rdb {name}: built {plan['built']}, rdb_plan {stated}")
    blocks = {f"{m}x{k}x{n}": {"plan": mm_grid_plan(m, k, n), "built": built_mm_grid_plan(m, k, n)}
              for m, k, n in conv_exp.GATE_SHAPES}
    emit(mm_grid_blocks=blocks)
    for shape, pair in blocks.items():
        check(pair["plan"] == pair["built"], f"mm_grid at {shape}: built {pair['built']}, "
                                             f"mm_grid_plan {pair['plan']}")
    resident = {f"{m}x{k}x{n}": {"plan": mm_resident_plan(m, k, n),
                                 "built": built_mm_resident_plan(m, k, n)}
                for m, k, n in conv_exp.GATE_SHAPES}
    emit(mm_resident_blocks=resident)
    for shape, pair in resident.items():
        check(pair["plan"] == pair["built"], f"mm_resident at {shape}: built {pair['built']}, "
                                             f"mm_resident_plan {pair['plan']}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    conv = {"plan": conv3x3_plan(*CONV_SHAPE, sms), "built": built_conv3x3_plan(*CONV_SHAPE, sms)}
    emit(conv3x3_blocks={"shape": list(CONV_SHAPE), "sms": sms, **conv})
    check(conv["plan"] == conv["built"], f"conv3x3 at {CONV_SHAPE}: built {conv['built']}, "
                                         f"conv3x3_plan {conv['plan']}")
    emit(dynamic_smem_bytes={
        "conv3x3[64->192, 96 channels a block]": conv["plan"]["smem_bytes"],
        **{f"mm_resident[k={k}, {pair['plan']['bn']} columns a block]": pair["plan"]["smem_bytes"]
           for (_, k, _), pair in zip(conv_exp.GATE_SHAPES, resident.values())}})


def record_rdb_shapes(shapes: dict):
    """Adds the NHWC shape of every input any RDB in the process gets to
    ``shapes[dtype]``, whoever built the model; returns the hook's handle."""
    def hook(module, args):
        if isinstance(module, ResidualDenseBlock):
            b, c, h, w = args[0].shape
            shapes[args[0].dtype].add((b, h, w, c))
    return torch.nn.modules.module.register_module_forward_pre_hook(hook)


def rdb_weights(packed) -> dict:
    """The weights the dtype's kernel reads, made once a pack as the model
    makes them: the f32 split or the bf16 boxes, as fused_rdb's keyword."""
    if packed[0].dtype == torch.float32:
        return {"split": split_rdb_weights(packed)}
    return {"boxes": box_rdb_weights(packed)}


def capture_trunk_inputs(pipe: SRPipeline, image: np.ndarray) -> dict:
    """The NHWC input of each of the 69 RDBs in one forward of ``image``."""
    inputs, hooks = {}, []
    for name, module in pipe.model.named_modules():
        if isinstance(module, ResidualDenseBlock):
            def keep(module, args, name=name):
                inputs[name] = args[0].permute(0, 2, 3, 1).contiguous().clone()
            hooks.append(module.register_forward_pre_hook(keep))
    pipe.apply(torch.from_numpy(image)[None].cuda())
    for hook in hooks:
        hook.remove()
    check(len(inputs) == RDBS_PER_FORWARD, f"kept the inputs of {len(inputs)} RDBs")
    return inputs


def check_trunk_activations(state_dict, inputs: dict, dtype: torch.dtype) -> None:
    """K1 against rdb_plain on the real inputs of every RDB of the tree
    forward in ``dtype`` (|x| up to about 59): the f32 split's 16 bits have
    the least room there, bf16 rounds in its largest steps, and N(0, 0.5^2)
    reaches neither.  A line for each of CHECK_RDBS, and one for the worst
    of all 69."""
    atol, rtol = TOLERANCE[dtype]
    worst = {"max_abs_diff": -1.0}
    for name, x in inputs.items():
        packed = rdb_pack(state_dict, name, dtype)
        ok, err = within(fused_rdb(x, packed, **rdb_weights(packed)), rdb_plain(x, packed),
                         TOLERANCE[dtype])
        line = {"dtype": DTYPE_NAME[dtype], "rdb": name, "shape": list(x.shape),
                "max_abs_x": x.abs().max().item(), "max_abs_diff": err, "atol": atol,
                "rtol": rtol, "ok": ok}
        if name in CHECK_RDBS:
            emit(k1_trunk_check=line)
        if err > worst["max_abs_diff"]:
            worst = line
        check(ok, f"fused_rdb {DTYPE_NAME[dtype]} {name} disagrees with rdb_plain on the trunk's "
                  f"activations: {err}")
    emit(k1_trunk_worst={"rdbs": len(inputs), **worst})


def check_kernels(state_dict, main_shapes: dict) -> None:
    """K1 against rdb_plain on the card, trained weights, N(0, 0.5^2) inputs,
    at every shape the main paths gave it in each dtype and K1_EXTRA_SHAPES."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype, (atol, rtol) in TOLERANCE.items():
        for name in CHECK_RDBS:
            packed = rdb_pack(state_dict, name, dtype)
            weights = rdb_weights(packed)
            for shape in sorted(main_shapes[dtype] | K1_EXTRA_SHAPES):
                x = (torch.randn(shape, generator=gen, device="cuda") * 0.5).to(dtype)
                out = fused_rdb(x, packed, **weights).float()
                ref = rdb_plain(x, packed).float()
                torch.cuda.synchronize()
                diff = (out - ref).abs()
                ok = bool(torch.isfinite(out).all()) and bool((diff <= atol + rtol * ref.abs()).all())
                emit(k1_check={"dtype": DTYPE_NAME[dtype], "rdb": name, "shape": list(shape),
                               "max_abs_diff": diff.max().item(), "atol": atol, "rtol": rtol,
                               "ok": ok})
                check(ok, f"fused_rdb {DTYPE_NAME[dtype]} {name} {shape} disagrees with rdb_plain")


def check_autograd_guard(state_dict) -> None:
    """fused_rdb has no backward: with autograd on, a CUDA input or packed
    weight that requires grad raises instead of cutting the graph; under
    no_grad the same call runs."""
    packed = rdb_pack(state_dict, "trunk.0.rdb1", torch.float32)
    x = torch.zeros(1, 16, 16, 64, device="cuda", requires_grad=True)
    before = fused_rdb.launches
    raised = {}
    for name, args in (("input", (x, packed)),
                       ("weight", (x.detach(), [packed[0].clone().requires_grad_()] + packed[1:]))):
        try:
            fused_rdb(*args)
            raised[name] = False
        except RuntimeError as err:
            raised[name] = "no backward" in str(err)
    with torch.no_grad():
        fused_rdb(x, packed)
    torch.cuda.synchronize()
    emit(autograd_guard={"raised": raised, "launches_under_no_grad": fused_rdb.launches - before})
    check(all(raised.values()), f"fused_rdb did not raise under autograd: {raised}")
    check(fused_rdb.launches - before == 1, "fused_rdb under no_grad did not launch once")


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return math.inf if mse == 0 else 10.0 * math.log10(1.0 / mse)


def serve(pipe: SRPipeline, dtype: torch.dtype, tree: np.ndarray, wide: np.ndarray) -> dict:
    """The main path's requests through one pipeline; checks each output and
    its launch count.  Returns the outputs the later checks need."""
    core = pipe.tile - 2 * pipe.tile_overlap
    n_tiles = math.ceil(wide.shape[0] / core) * math.ceil(wide.shape[1] / core)
    requests = [("tree", tree, 1), ("tree_again", tree, 1), ("crop50x70", tree[:50, :70], 1),
                ("wide_tiled", wide, math.ceil(n_tiles / pipe.tile_batch))]
    outputs = {}
    for name, image, forwards in requests:
        before = fused_rdb.launches
        t0 = time.perf_counter()
        out = pipe.upscale(image)
        seconds = time.perf_counter() - t0
        launched = fused_rdb.launches - before
        h, w, _ = image.shape
        emit(request={"dtype": DTYPE_NAME[dtype], "name": name, "in": [h, w],
                      "out": list(out.shape), "seconds": round(seconds, 4),
                      "fused_rdb_launches": launched})
        check(out.shape == (4 * h, 4 * w, 3), f"{name} output shape {out.shape}")
        check(bool(np.isfinite(out).all()), f"{name} output not finite")
        check(float(out.min()) >= 0.0 and float(out.max()) <= 1.0, f"{name} output outside [0, 1]")
        check(launched == RDBS_PER_FORWARD * forwards,
              f"{name}: fused_rdb launched {launched} times, expected {RDBS_PER_FORWARD * forwards}")
        outputs[name] = out
    # the golden crop is a plain Generator forward of the ragged 67x93 input
    before = fused_rdb.launches
    crop = torch.from_numpy(np.ascontiguousarray(tree[CROP]))[None].cuda()
    outputs["crop67x93"] = pipe.apply(crop)[0].cpu().numpy()
    check(fused_rdb.launches - before == RDBS_PER_FORWARD, "crop67x93 launch count")
    return outputs


def seam_error(pipe: SRPipeline, wide: np.ndarray, tiled: np.ndarray) -> dict:
    """Tiled against whole-image output in 8-bit levels, as tools/tile_sweep.py
    measures it: the 64-pixel output border (16 input pixels) is left out of
    the interior, since reflect padding and zero padding differ there."""
    whole = pipe.apply(torch.from_numpy(wide)[None].cuda())[0].float().cpu().numpy()
    diff = np.abs(whole - tiled) * 255.0
    interior = diff[64:-64, 64:-64]
    stats = lambda d: {"max": float(d.max()), "mean": float(d.mean()),  # noqa: E731
                       "p999": float(np.quantile(d, 0.999))}
    return {"all_8bit": stats(diff), "interior_8bit": stats(interior)}


def profile_device(call) -> dict:
    """One call under torch.profiler: its device activities' union (busy
    time) against the host wall clock around the call, and device time by
    kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return {"wall_ms": wall_ms, "device": "not measured: the profiler saw no device activity"}
    busy_us, reach = 0.0, spans[0][0]
    for start, end in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e3 / wall_ms, "by_name": by_name}


def profile_forward(pipe: SRPipeline, image: np.ndarray) -> dict:
    """Where one warm forward's time goes on the card (``profile_device``),
    with the RDB kernel's share of the busy time and the six longest kernels."""
    x = torch.from_numpy(image)[None].cuda()
    pipe.apply(x)
    torch.cuda.synchronize()
    profile = profile_device(lambda: pipe.apply(x))
    if "by_name" not in profile:
        return profile
    by_name = profile.pop("by_name")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    rdb_ms = sum(ms for name, (ms, _) in by_name.items()
                 if any(kernel in name for kernel in RDB_KERNEL_NAMES))
    return {**profile, "fused_rdb_ms": rdb_ms,
            "fused_rdb_share_of_busy": rdb_ms / profile["device_busy_ms"],
            "top": [[name[:70], ms, n] for name, (ms, n) in top]}


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(kernel, plain, reps: int):
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    plain_a, kernel_a = time_ms(plain, reps), time_ms(kernel, reps)
    kernel_b, plain_b = time_ms(kernel, reps), time_ms(plain, reps)
    return (kernel_a + kernel_b) / 2, (plain_a + plain_b) / 2


def graph_ms(fn, launches: int) -> float:
    """Time of one call of ``fn`` inside a CUDA graph of ``launches`` calls:
    the device's time for the launch alone, without the host's gaps between
    launches, so it reads a kernel that is shorter than its launch through
    the host."""
    return conv_exp.time_in_graph(fn, launches, torch.device("cuda")) * 1e3


def kernel_record(state_dict, dtype: torch.dtype, launches: int) -> dict:
    """fused_rdb at the tree image's trunk shape (1, 256, 512, 64): its time,
    its plain version's, both in turns (plain, kernel, kernel, plain), both
    again inside a CUDA graph of 10 launches (``device_ms``,
    ``plain_device_ms``: the plain version's 15 cuDNN convolutions and
    elementwise passes without the host's gaps between them), and its bound,
    the larger of its tensor-core FLOPs (PRODUCTS x the RDB's) over the bf16
    rate and bytes over HBM's rate.  f32 adds ``cuda_core_bound_ms``, the
    RDB's FLOPs over the CUDA cores' f32 rate, and ``device_tc_tflops``, the
    tensor-core FLOPs a second.  The f32 weights are split, the bf16 ones
    laid out as boxes, before the timing, as the model does once a pack."""
    shape = (1, 256, 512, 64)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = (torch.randn(shape, generator=gen, device="cuda") * 0.5).to(dtype)
    packed = rdb_pack(state_dict, "trunk.11.rdb2", dtype)
    weights = rdb_weights(packed)
    out, ref = fused_rdb(x, packed, **weights).float(), rdb_plain(x, packed).float()
    atol, rtol = TOLERANCE[dtype]
    check(bool(((out - ref).abs() <= atol + rtol * ref.abs()).all()),
          f"fused_rdb {DTYPE_NAME[dtype]} disagrees with rdb_plain at {shape}")
    err = (out - ref).abs().max().item()
    kernel, plain = (lambda: fused_rdb(x, packed, **weights)), (lambda: rdb_plain(x, packed))
    ms, plain_ms = in_turns(kernel, plain, 10)
    plain_device_ms = graph_ms(plain, 10)
    device_ms = graph_ms(kernel, 10)
    pixels = shape[0] * shape[1] * shape[2]
    flops = RDB_FLOP_PER_PIXEL * pixels
    moved = (2 * pixels * 64 + RDB_WEIGHTS) * x.element_size() + 5 * 64 * 4
    t_ops = PRODUCTS[dtype] * flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = moved / PEAK_BYTES * 1e3
    record = {"name": f"fused_rdb[{DTYPE_NAME[dtype]}]", "route": "cuda",
              "source": "real_esrgan_tpu_torch/csrc/fused_rdb.cu",
              "replaces": "real_esrgan_tpu/ops/pallas_rdb.py:188",
              "launches": launches, "max_abs_err": err, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
              "bound_by": "operations" if t_ops >= t_bytes else "bytes",
              "library_ms": None, "device_ms": device_ms, "plain_device_ms": plain_device_ms,
              "shape": list(shape), "products": PRODUCTS[dtype], "tflops": flops / ms / 1e9,
              "device_tflops": flops / device_ms / 1e9}
    if dtype == torch.float32:
        record.update(cuda_core_bound_ms=flops / PEAK_F32_CUDA_CORE_FLOPS * 1e3,
                      device_tc_tflops=PRODUCTS[dtype] * flops / device_ms / 1e9)
    return record


def within(out: torch.Tensor, ref: torch.Tensor, tolerance=BF16_TOLERANCE):
    """(all within atol + rtol |ref|, max abs difference), after a synchronize."""
    torch.cuda.synchronize()
    atol, rtol = tolerance
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    ok = bool(torch.isfinite(out).all()) and bool((diff <= atol + rtol * ref.abs()).all())
    return ok, diff.max().item()


def conv_operands(shape, cout, seed=2):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(shape, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(3, 3, shape[-1], cout, generator=gen, device="cuda") * 0.05
    return x, w


def one_hot_probes():
    """Exact probes of mm_grid's operand layouts, (name, a, b): a = I with b
    coded by position (arange mod 251, integers bf16 holds exactly), so c =
    b; and b = three 64-column identities scaled by 1, 2, 4 with a coded by
    position, so c's column block j is 2^j a.  A wrong swizzle, LBO or SBO
    shows as a permutation of the codes."""
    code = lambda r, c: (torch.arange(r * c, device="cuda") % 251).reshape(r, c)  # noqa: E731
    eye = torch.eye(64, device="cuda")
    scaled = torch.cat([eye * 2.0 ** j for j in range(3)], dim=1)
    return [(name, a.to(torch.bfloat16), b.to(torch.bfloat16))
            for name, a, b in (("a_identity", eye, code(64, 192)),
                               ("b_identity", code(128, 64), scaled))]


def resident_one_hot_probes(k: int):
    """Exact probes of mm_resident's operand layouts and k split, (name, a,
    b): a = I (k x k) with b (k x 192) coded by position, so c = reps b; and
    b (k x k) diagonal, 1, 2, 4 by 64-column box, with a (128 x k) coded, so
    c's column c is 2^(c // 64 % 3) reps a's.  Each output is one product,
    the other warpgroup adds exact zeros, and 32 equal products sum exactly
    in f32: a wrong fragment, swizzle, descriptor or reduction shows as a
    permutation of the codes."""
    code = lambda r, c: (torch.arange(r * c, device="cuda") % 251).reshape(r, c)  # noqa: E731
    scale = 2.0 ** (torch.arange(k, device="cuda") // 64 % 3)
    return [(name, a.to(torch.bfloat16), b.to(torch.bfloat16))
            for name, a, b in (("a_identity", torch.eye(k, device="cuda"), code(k, 192)),
                               ("b_identity", code(128, k), torch.diag(scale)))]


def conv_one_hot_probe(shape, cout: int, tap: int):
    """An exact probe of conv3x3's window and weight layouts, (x, w): x coded
    by position (7 * flat index mod 61: integers bf16 holds exactly; a chunk
    of 8 channels or a pixel apart always differ) and w zero but for tap
    ``tap`` = (dy, dx), where output channel o takes input channel o % Cin
    scaled by 2^(o // Cin).  The output is x shifted by the tap, exactly; a
    wrong swizzle, halo, tap or weight row shows as a permutation."""
    b, h, width, cin = shape
    x = (torch.arange(b * h * width * cin, device="cuda") * 7 % 61).reshape(shape)
    w = torch.zeros(3, 3, cin, cout, device="cuda")
    o = torch.arange(cout, device="cuda")
    w[tap // 3, tap % 3, o % cin, o] = 2.0 ** (o // cin).float()
    return x.to(torch.bfloat16), w


def check_tool_kernels() -> None:
    """K2-K4 against their plain versions on the card, at every shape the
    tool's run gives them (its default conv, the five of ``--mm``), smaller
    and ragged ones, which between them take every width the kernels are
    built for: atol/rtol 2e-2 for the products, equality for the conv's copy
    modes and the one-hot probes of mm_grid, mm_resident and conv3x3, the
    shape alone for ``dots``."""
    atol, rtol = BF16_TOLERANCE
    b, h, w_, cin, cout, tile = CONV_SHAPE
    for shape, n_out, rows in (((b, h, w_, cin), cout, tile), *CONV_EXTRA_SHAPES):
        x, w = conv_operands(shape, n_out)
        ok, err = within(conv3x3(x, w, tile=rows), conv3x3_plain(x, w))
        exact = {mode: bool(torch.equal(conv3x3(x, w, tile=rows, mode=mode),
                                        conv3x3_plain(x, w, mode))) for mode in ("patch", "dma")}
        dots = conv3x3(x, w, tile=rows, mode="dots")
        torch.cuda.synchronize()
        ok = ok and all(exact.values()) and tuple(dots.shape) == (*shape[:3], n_out)
        emit(kernel_check={"kernel": "conv3x3", "shape": [*shape, n_out], "tile": rows,
                           "max_abs_diff": err, "atol": atol, "rtol": rtol,
                           "copy_modes_equal": exact, "ok": ok})
        check(ok, f"conv3x3 disagrees with conv3x3_plain at {shape} -> {n_out}")
    for shape, n_out, rows in CONV_PROBE_SHAPES:
        exact = {}
        for tap in range(9):
            x, w = conv_one_hot_probe(shape, n_out, tap)
            out = conv3x3(x, w, tile=rows)
            torch.cuda.synchronize()
            exact[f"{tap // 3}{tap % 3}"] = bool(torch.equal(out, conv3x3_plain(x, w)))
        ok = all(exact.values())
        emit(kernel_check={"kernel": "conv3x3", "probe": "one_hot_taps", "shape": [*shape, n_out],
                           "tile": rows, "exact": exact, "ok": ok})
        check(ok, f"conv3x3's one-hot probes at {shape} -> {n_out} are not exact: {exact}")
    for name, a, bm in one_hot_probes():
        out = mm_grid(a, bm)
        torch.cuda.synchronize()
        exact = bool(torch.equal(out, mm_grid_plain(a, bm)))
        emit(kernel_check={"kernel": "mm_grid", "probe": name,
                           "shape": [a.shape[0], a.shape[1], bm.shape[1]], "exact": exact,
                           "ok": exact})
        check(exact, f"mm_grid's one-hot probe {name} is not exact")
    for k in RESIDENT_PROBE_K:
        for name, a, bm in resident_one_hot_probes(k):
            exact = {}
            for reps in RESIDENT_PROBE_REPS:
                out = mm_resident(a, bm, reps)
                torch.cuda.synchronize()
                exact[f"reps{reps}"] = bool(torch.equal(out, mm_resident_plain(a, bm, reps)))
            ok = all(exact.values())
            emit(kernel_check={"kernel": "mm_resident", "probe": name,
                               "shape": [a.shape[0], a.shape[1], bm.shape[1]], "exact": exact,
                               "ok": ok})
            check(ok, f"mm_resident's one-hot probe {name} at k = {k} is not exact: {exact}")
    for m, k, n in (*conv_exp.MM_SHAPES, (256, 96, 160), (128, 64, 64), *MM_RAGGED_SHAPES):
        a, bm = conv_exp.mm_operands(m, k, n, 0.05, torch.device("cuda"), seed=3)
        for name, out, ref in (("mm_grid", mm_grid(a, bm), mm_grid_plain(a, bm)),
                               ("mm_resident", mm_resident(a, bm, MM_REPS),
                                mm_resident_plain(a, bm, MM_REPS))):
            ok, err = within(out, ref)
            emit(kernel_check={"kernel": name, "shape": [m, k, n], "max_abs_diff": err,
                               "atol": atol, "rtol": rtol, "ok": ok})
            check(ok, f"{name} disagrees with its plain version at ({m}, {k}) @ ({k}, {n})")


def drive_conv_exp() -> dict:
    """The experiment tool in process on the card: default run, ``--mm``,
    ``--gate``, and the ``mm_grid`` probe, which the tool keeps callable.
    Returns the launch counts of the run and the gate's verdict."""
    wrappers = {"conv3x3": conv3x3, "mm_grid": mm_grid, "mm_resident": mm_resident}
    for wrapper in wrappers.values():
        wrapper.launches = 0
    conv_exp.main([])
    conv_exp.main(["--mm"])
    verdict = conv_exp.main(["--gate"])
    for m, k, n in conv_exp.GATE_SHAPES:  # one launch is shorter than its launch through the host
        conv_exp.bench_mm_grid(m, k, n, 200, torch.device("cuda"), timer=conv_exp.time_in_graph)
    launches = {name: wrapper.launches for name, wrapper in wrappers.items()}
    emit(conv_exp={"launches": launches, "gate": verdict})
    for name, count in launches.items():
        check(count > 0, f"the experiment tool never launched {name}")
    check(set(verdict) >= {"value", "threshold", "library_tflops", "unparked", "device", "shapes"},
          "gate verdict lacks a key")
    return launches


def drive_eval(tree: np.ndarray, rdb_shapes: dict) -> dict:
    """The evaluation entry points on three crops of the test image at full
    width and depth, with the RDB kernel's input shapes added to
    ``rdb_shapes``.  Returns fused_rdb's launch counts by dtype."""
    launches = {}
    seen = {dtype: set() for dtype in rdb_shapes}
    hook = record_rdb_shapes(seen)
    with tempfile.TemporaryDirectory() as tmp:
        lr_dir, hr_dir = os.path.join(tmp, "lr"), os.path.join(tmp, "hr")
        os.makedirs(lr_dir), os.makedirs(hr_dir)
        for name, (top, left, h, w) in EVAL_CROPS.items():
            lr = np.ascontiguousarray(tree[top:top + h, left:left + w])
            hr = matlab_resize(torch.from_numpy(lr).cuda(), 4.0).clamp(0, 1).cpu().numpy()
            write_png(os.path.join(lr_dir, name), np.round(lr * 255.0).astype(np.uint8))
            write_png(os.path.join(hr_dir, name), np.round(hr * 255.0).astype(np.uint8))

        def run(label, dtype, call):
            fused_rdb.launches = 0
            t0 = time.perf_counter()
            result = call()
            seconds = time.perf_counter() - t0
            launched = fused_rdb.launches
            launches[dtype] = launches.get(dtype, 0) + launched
            emit(eval={"entry": label, "dtype": DTYPE_NAME[dtype], "seconds": round(seconds, 3),
                       "fused_rdb_launches": launched, "result": result})
            check(launched == RDBS_PER_FORWARD * len(EVAL_CROPS),
                  f"{label}: fused_rdb launched {launched} times for {len(EVAL_CROPS)} images")
            return result

        for flag, dtype in (([], torch.float32), (["--bfloat16"], torch.bfloat16)):
            sr_dir = os.path.join(tmp, "sr_" + DTYPE_NAME[dtype])
            args = test_cli.build_parser().parse_args(
                ["--lr_dir", lr_dir, "--hr_dir", hr_dir, "--sr_dir", sr_dir,
                 "--model_path", WEIGHTS, *flag])
            avg = run("test", dtype, lambda: test_cli.main(args))
            check(math.isfinite(avg) and 0.0 < avg <= 100.0, f"test: mean NIQE {avg}")
            check(sorted(os.listdir(sr_dir)) == sorted(EVAL_CROPS), "test: files written")
            for name, (_, _, h, w) in EVAL_CROPS.items():
                check(read_png(os.path.join(sr_dir, name)).shape == (4 * h, 4 * w, 3),
                      f"test: {name} is not 4x its input")
        summary = run("eval_pair", torch.bfloat16, lambda: eval_pair.main(
            ["--weights", WEIGHTS, "--lr-dir", lr_dir, "--hr-dir", hr_dir]))
        check(summary["n"] == len(EVAL_CROPS) and math.isfinite(summary["psnr_mean"])
              and summary["niqe_mean"] is not None and math.isfinite(summary["niqe_mean"]),
              f"eval_pair summary {summary}")
    hook.remove()
    for dtype, shapes in seen.items():
        emit(rdb_shapes={"path": "eval", "dtype": DTYPE_NAME[dtype],
                         "shapes": [list(s) for s in sorted(shapes)]})
        check(len(shapes) > 0, f"the evaluation path gave fused_rdb no {DTYPE_NAME[dtype]} input")
        rdb_shapes[dtype] |= shapes
    return launches


def check_niqe() -> None:
    """NIQE of tests/data/tree_sr.png on the card, with TF32 allowed for
    float32 products and convolutions, against the committed JAX score (1e-2)
    and the port's own CPU score of this run (1e-3); times the features on
    the card and the float64 tail on the host."""
    with open(NIQE_GOLDEN) as f:
        golden = json.load(f)
    image = load_image_rgb(TREE_SR)[None]
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        card = float(NIQE(crop_border=golden["crop_border"], device="cuda")(image)[0])
        batch = torch.from_numpy(image).cuda()
        features_ms = time_ms(lambda: niqe_features(batch, golden["crop_border"]), 5)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    scorer = NIQE(crop_border=golden["crop_border"], device="cpu")
    feats = niqe_features(torch.from_numpy(image), golden["crop_border"]).numpy()
    t0 = time.perf_counter()
    cpu = float(scorer.score_features(feats)[0])
    tail_ms = (time.perf_counter() - t0) * 1e3
    emit(niqe={"image": "tests/data/tree_sr.png", "card": card, "cpu": cpu,
               "jax_golden": golden["score"], "card_minus_cpu": card - cpu,
               "card_minus_golden": card - golden["score"], "tf32_allowed": True,
               "features_ms_on_card": features_ms, "host_f64_tail_ms": tail_ms})
    check(abs(card - golden["score"]) <= 1e-2, f"NIQE {card} on the card, JAX {golden['score']}")
    check(abs(card - cpu) <= 1e-3, f"NIQE {card} on the card, {cpu} on the CPU")


class pytorch_default_tf32:
    """PyTorch's default TF32 flags (cuDNN convolutions in TF32, matrix
    products not) for the block, restored after it: a float32 product or
    convolution of the degradation that missed its guard would show."""

    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved


def lr_agreement(ours: torch.Tensor, ref: torch.Tensor) -> dict:
    """Share of equal 8-bit LR values, the largest difference in levels and
    the PSNR of ``ours`` against ``ref``."""
    ours, ref = ours.detach().cpu().double(), ref.detach().cpu().double()
    levels = (torch.round(ours * 255.0) - torch.round(ref * 255.0)).abs()
    mse = float(((ours - ref) ** 2).mean())
    return {"equal_share": float((levels == 0).double().mean()), "max_levels": float(levels.max()),
            "psnr_db": math.inf if mse == 0 else 10.0 * math.log10(1.0 / mse)}


def check_lr_agreement(name: str, stats: dict) -> None:
    check(stats["equal_share"] >= DEGRADE_LR_EQUAL_SHARE and stats["psnr_db"] >= DEGRADE_LR_PSNR_DB,
          f"{name}: LR agreement {stats} below {DEGRADE_LR_EQUAL_SHARE} / {DEGRADE_LR_PSNR_DB} dB")


def degrade_tiles(tree_sr: np.ndarray) -> np.ndarray:
    """The 2 x 5 grid of 400-pixel uint8 tiles of the 1024 x 2048 test image,
    as the CLI cuts them."""
    size = DEGRADE_GEO.hr_size
    return np.stack([tree_sr[y:y + size, x:x + size]
                     for y in range(0, tree_sr.shape[0] - size + 1, size)
                     for x in range(0, tree_sr.shape[1] - size + 1, size)])


def check_degrade_card_against_cpu(tiles: np.ndarray) -> None:
    """The degradation at the CLI's geometry and batch of 8, each (up1, up2):
    one draw on the CPU, applied on the CPU and, moved there, on the card."""
    kcfg, dcfg = degrade_cfg.KernelSynthesisConfig(), degrade_cfg.DegradationConfig()
    hr = torch.from_numpy(tiles[:8])
    for i, (up1, up2) in enumerate(UP_FLAGS):
        gen = torch.Generator().manual_seed(100 + i)
        draws = draw_degradation(gen, 8, DEGRADE_GEO, kcfg, dcfg, up1, up2, augment=True)
        t0 = time.perf_counter()
        lr_cpu, hr_cpu = apply_degradation(hr, draws, DEGRADE_GEO, kcfg, dcfg, up1, up2)
        cpu_seconds = time.perf_counter() - t0
        lr, hr_card = apply_degradation(hr.cuda(), draws.to("cuda"), DEGRADE_GEO, kcfg, dcfg,
                                        up1, up2)
        stats = lr_agreement(lr, lr_cpu)
        hr_identical = bool(torch.equal(hr_card.cpu(), hr_cpu))
        emit(degrade_card_vs_cpu={"up1": up1, "up2": up2, "batch": 8, "lr": list(lr.shape),
                                  "hr_identical": hr_identical, "cpu_seconds": cpu_seconds,
                                  "branches": {"gaussian": [draws.noise1.gaussian,
                                                            draws.noise2.gaussian],
                                               "blur2": draws.blur2, "order": draws.order,
                                               "methods": [draws.method1, draws.method2,
                                                           draws.method3]},
                                  **stats})
        check(hr_identical, f"degrade ({up1}, {up2}): HR crops differ between the card and the CPU")
        check_lr_agreement(f"degrade ({up1}, {up2}) card against CPU", stats)


def check_degrade_golden() -> None:
    """The port on the card, applied to the JAX package's own draws, against
    JAX's LR and HR (tests/test_torch_degradation.py writes the golden)."""
    with np.load(DEGRADE_GOLDEN) as g:
        draws = draws_from_arrays({k[6:]: g[k] for k in g.files if k.startswith("draws.")})
        hr_in, lr_ref, hr_ref = (torch.from_numpy(g[k]) for k in ("hr_uint8", "lr", "hr"))
        key = int(g["key"])
    geo = degrade_cfg.PipelineGeometry(hr_size=128, crop_size=64, scale=4)
    lr, hr = apply_degradation(hr_in.cuda(), draws.to("cuda"), geo,
                               degrade_cfg.KernelSynthesisConfig(),
                               degrade_cfg.DegradationConfig(), True, True)
    stats = lr_agreement(lr, lr_ref)
    hr_identical = bool(torch.equal(hr.cpu(), hr_ref))
    emit(degrade_jax_golden={"golden": os.path.relpath(DEGRADE_GOLDEN, ROOT), "key": key,
                             "hr_identical": hr_identical, **stats})
    check(hr_identical, "degrade: HR crops differ from the JAX golden")
    check_lr_agreement("degrade card against the JAX golden", stats)


def drive_degraded_eval_cli(tiles: np.ndarray) -> None:
    """The CLI end to end on the card (no --cpu): 10 tiles of 400, seed 0, 2
    batches of 8 (the second padded); 10 aligned pairs, each LR more than 2
    levels from a clean area downscale of its HR; both pairs scored by
    eval_pair, --bicubic and with the committed weights."""
    with tempfile.TemporaryDirectory() as tmp:
        gt_dir, out = os.path.join(tmp, "gt"), os.path.join(tmp, "pairs")
        os.makedirs(gt_dir)
        for i, tile in enumerate(tiles):
            write_png(os.path.join(gt_dir, f"tree_{i:02d}.png"), tile)
        t0 = time.perf_counter()
        make_degraded_eval.main(["--gt-dir", gt_dir, "--output-dir", out, "--seed", "0"])
        seconds = time.perf_counter() - t0
        lr_dir, hr_dir = os.path.join(out, "LRx4"), os.path.join(out, "GTmod4")
        names = sorted(os.listdir(lr_dir))
        check(names == sorted(os.listdir(hr_dir)) and len(names) == len(tiles),
              f"make_degraded_eval wrote {len(names)} LR files for {len(tiles)} tiles")
        min_levels = math.inf
        for name in names:
            lr, hr = read_png(os.path.join(lr_dir, name)), read_png(os.path.join(hr_dir, name))
            check(lr.shape == (64, 64, 3) and hr.shape == (256, 256, 3),
                  f"{name}: LR {lr.shape}, HR {hr.shape}")
            clean = hr.astype(np.float64).reshape(64, 4, 64, 4, 3).mean(axis=(1, 3))
            levels = float(np.abs(lr.astype(np.float64) - clean).max())
            min_levels = min(min_levels, levels)
            check(levels > 2, f"{name}: LR within {levels} levels of a clean downscale")
        scores = {}
        for which, flags in (("bicubic", ["--bicubic"]),
                             ("inenv10_esrnet_ema", ["--weights", WEIGHTS])):
            summary = eval_pair.main([*flags, "--lr-dir", lr_dir, "--hr-dir", hr_dir])
            check(summary["n"] == len(names) and math.isfinite(summary["psnr_mean"]),
                  f"eval_pair {which}: {summary}")
            scores[which] = summary["psnr_mean"]
    emit(degraded_eval_cli={"tiles": len(tiles), "pairs": len(names), "seconds": seconds,
                            "min_levels_from_clean_downscale": min_levels,
                            "psnr_mean_db": scores})


def time_degrade(tiles: np.ndarray) -> None:
    """degrade (draw + apply) a batch on the card, between two CUDA events
    around DEGRADE_TIMED batches after DEGRADE_WARMUP, at each batch size and
    (up1, up2); then one profiled batch of each size with both flags up."""
    kcfg, dcfg = degrade_cfg.KernelSynthesisConfig(), degrade_cfg.DegradationConfig()
    gen = torch.Generator(device="cuda").manual_seed(0)
    host = torch.Generator().manual_seed(0)
    for batch in DEGRADE_BATCHES:
        hr = torch.from_numpy(tiles[np.arange(batch) % len(tiles)]).cuda()

        def one(up1, up2):
            return degrade(gen, hr, DEGRADE_GEO, kcfg, dcfg, True, up1, up2, host)
        for up1, up2 in UP_FLAGS:
            for _ in range(DEGRADE_WARMUP):
                one(up1, up2)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(DEGRADE_TIMED):
                lr, _ = one(up1, up2)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / DEGRADE_TIMED
            check(bool(torch.isfinite(lr).all()), "degrade gave a non-finite LR")
            emit(degrade_time={"batch": batch, "up1": up1, "up2": up2,
                               "canvases": [DEGRADE_GEO.canvas1_for(up1),
                                            DEGRADE_GEO.canvas2_for(up2)],
                               "ms_per_batch": ms, "images_per_second": batch / ms * 1e3,
                               "batches_timed": DEGRADE_TIMED})
        profile = profile_device(lambda: one(True, True))
        by_name = profile.pop("by_name", {})
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
        emit(degrade_profile={"batch": batch, "up1": True, "up2": True, **profile,
                              "kernel_launches": sum(n for _, n in by_name.values()),
                              "top5": [[name[:80], ms, n] for name, (ms, n) in top]})


def time_degrade_blur() -> None:
    """The second blur at batch 48 on the up canvas (608 + 20 pixels of
    reflect padding, per-sample 21 x 21 kernels), as the port takes it (bf16
    operands, the sum in float64, one rounding) beside cuDNN's bf16 depthwise
    convolution of the same operands (its own float32 sum, then the
    rounding): times in a CUDA-event window of 5 calls, and the share of
    outputs the two round alike."""
    from real_esrgan_tpu_torch.ops.filter2d import filter2d

    gen = torch.Generator(device="cuda").manual_seed(3)
    b, size, k = 48, DEGRADE_GEO.canvas1_for(True), 21
    x = torch.rand(b, size, size, 3, generator=gen, device="cuda")
    kernels = torch.rand(b, k, k, generator=gen, device="cuda") ** 4
    kernels = kernels / kernels.sum(dim=(1, 2), keepdim=True)
    planes = x.permute(0, 3, 1, 2).reshape(1, b * 3, size, size).bfloat16()
    planes = torch.nn.functional.pad(planes, (k // 2,) * 4, mode="reflect")
    weight = kernels.bfloat16().repeat_interleave(3, dim=0)[:, None]

    def library():
        return torch.nn.functional.conv2d(planes, weight, groups=b * 3)
    port = filter2d(x, kernels, compute_dtype=torch.bfloat16)
    cudnn = library().reshape(b, 3, size, size).permute(0, 2, 3, 1).float()
    emit(degrade_blur={"batch": b, "canvas": size, "kernel": k,
                       "port_f64_sum_ms": time_ms(lambda: filter2d(x, kernels, torch.bfloat16), 5),
                       "cudnn_bf16_ms": time_ms(library, 5),
                       "rounded_alike_share": float((port == cudnn).float().mean())})


def drive_degrade(tree_sr: np.ndarray) -> None:
    """The degradation phase, under PyTorch's default TF32 flags."""
    tiles = degrade_tiles(tree_sr)
    with pytorch_default_tf32():
        check_degrade_card_against_cpu(tiles)
        check_degrade_golden()
        drive_degraded_eval_cli(tiles)
        time_degrade(tiles)
        time_degrade_blur()


def bound(flops: float, moved: float) -> dict:
    """The least time the card could take: operations over the bf16 peak
    against bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, moved / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def conv_record(launches: int) -> dict:
    """conv3x3 mode ``full`` at the tool's default shape: in a host loop of
    20 launches (in turns with the plain version), and inside a CUDA graph
    of 20 launches (``device_ms``) beside cuDNN's ``F.conv2d`` (bf16,
    channels_last) in the same (``library_device_ms``)."""
    b, h, w_, cin, cout, tile = CONV_SHAPE
    x, w = conv_operands((b, h, w_, cin), cout)
    w = w.to(torch.bfloat16)
    weight = conv_exp.library_conv_weight(w)
    ok, err = within(conv3x3(x, w, tile=tile), conv3x3_plain(x, w))
    check(ok, "conv3x3 disagrees with conv3x3_plain at the tool's shape")
    ms, plain_ms = in_turns(lambda: conv3x3(x, w, tile=tile), lambda: conv3x3_plain(x, w), 20)
    library_device_ms = graph_ms(lambda: conv_exp.library_conv(x, weight), 20)
    device_ms = graph_ms(lambda: conv3x3(x, w, tile=tile), 20)
    flops = 2 * 9 * cin * cout * b * h * w_
    moved = 2 * (x.numel() + b * h * w_ * cout + w.numel())
    return {"name": "conv3x3[bf16]", "route": "cuda",
            "source": "real_esrgan_tpu_torch/csrc/conv3x3.cu",
            "replaces": "tools/pallas_conv_exp.py:86", "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, **bound(flops, moved),
            "library_ms": time_ms(lambda: conv_exp.library_conv(x, weight), 20),
            "device_ms": device_ms, "library_device_ms": library_device_ms,
            "shape": [b, h, w_, cin, cout], "mode": "full", "tile": tile,
            "tflops": flops / ms / 1e9, "device_tflops": flops / device_ms / 1e9}


def mm_record(kind: str, m: int, k: int, n: int, launches: int) -> dict:
    """mm_grid or mm_resident at one of the gate's shapes.  One mm_grid
    launch is shorter than its launch through the host, so ``ms``, over 200
    launches between two events, reads the host's launch rate; ``device_ms``
    is its time inside a CUDA graph of 50 launches.  mm_resident's library
    time is that of ``library_calls`` = 32 ``torch.matmul`` calls, a
    comparison of throughput: no one call computes 32 resident products, and
    ``torch.mm`` scaled by reps gives the same output with 1/32 of the work."""
    a, b = conv_exp.mm_operands(m, k, n, 0.05, torch.device("cuda"), seed=3)
    if kind == "mm_grid":
        reps, timed = 1, 200
        kernel, plain = (lambda: mm_grid(a, b)), (lambda: mm_grid_plain(a, b))
        library, line = (lambda: torch.matmul(a, b)), 119
    else:
        reps, timed = MM_REPS, 100
        kernel, plain = (lambda: mm_resident(a, b, reps)), (lambda: mm_resident_plain(a, b, reps))
        line = 159

        def library():
            for _ in range(reps):
                torch.matmul(a, b)
    ok, err = within(kernel(), plain())
    check(ok, f"{kind} disagrees with its plain version at ({m}, {k}) @ ({k}, {n})")
    ms, plain_ms = in_turns(kernel, plain, timed)
    flops = 2 * m * k * n * reps
    on_device = {"device_ms": graph_ms(kernel, 50), "library_device_ms": graph_ms(library, 50)}
    return {"name": f"{kind}[bf16,{m}x{k}x{n}]", "route": "cuda",
            "source": "real_esrgan_tpu_torch/csrc/mm_probe.cu",
            "replaces": f"tools/pallas_conv_exp.py:{line}", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_calls": reps,
            **bound(flops, 2 * (m * k + k * n + m * n)), "library_ms": time_ms(library, timed),
            "shape": [m, k, n], "reps": reps, "launches_timed": timed, **on_device,
            "tflops": flops / ms / 1e9, "device_tflops": flops / on_device["device_ms"] / 1e9}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(gpu, flush=True)
    build_kernels()

    state_dict = load_generator_params(WEIGHTS)
    tree = read_png(TREE).astype(np.float32) / 255.0          # 256 x 512
    wide = np.ascontiguousarray(np.tile(tree, (2, 4, 1)))      # 512 x 2048: 4 tiles of 528/8/8
    golden = np.load(GOLDEN)
    launches, outputs = {}, {}
    main_shapes = {dtype: set() for dtype in TOLERANCE}
    trunk_inputs = {}
    for dtype in (torch.bfloat16, torch.float32):
        pipe = SRPipeline(WEIGHTS, bfloat16=dtype == torch.bfloat16, device="cuda")
        hook = record_rdb_shapes(main_shapes)
        fused_rdb.launches = 0
        outputs[dtype] = serve(pipe, dtype, tree, wide)
        launches[dtype] = fused_rdb.launches
        hook.remove()
        check(launches[dtype] > 0, f"main path ({DTYPE_NAME[dtype]}) never launched fused_rdb")
        emit(rdb_shapes={"path": "serve", "dtype": DTYPE_NAME[dtype],
                         "shapes": [list(s) for s in sorted(main_shapes[dtype])]})
        profile = profile_forward(pipe, tree)
        emit(profile={"dtype": DTYPE_NAME[dtype], "request": "tree forward", **profile})
        trunk_inputs[dtype] = capture_trunk_inputs(pipe, tree)
        check("device_busy_ms" not in profile or profile["fused_rdb_ms"] > 0,
              f"the {DTYPE_NAME[dtype]} profile names no kernel of {RDB_KERNEL_NAMES}")
        if dtype == torch.bfloat16:
            seam = seam_error(pipe, wide, outputs[dtype]["wide_tiled"])
            emit(seam={"dtype": "bf16", "geometry": "528/8/8", "in": list(wide.shape[:2]),
                       "interior_limit_8bit": SEAM_LIMIT, **seam})
            for stat, limit in SEAM_LIMIT.items():
                check(seam["interior_8bit"][stat] <= limit,
                      f"tiled output's interior seam {stat} {seam['interior_8bit'][stat]} "
                      f"levels exceeds {limit}")
        del pipe
        torch.cuda.empty_cache()

    tool_launches = drive_conv_exp()
    check_tool_kernels()
    eval_launches = drive_eval(tree, main_shapes)
    check_niqe()
    check_kernels(state_dict, main_shapes)
    for dtype in (torch.bfloat16, torch.float32):
        check_trunk_activations(state_dict, trunk_inputs.pop(dtype), dtype)
    check_autograd_guard(state_dict)
    drive_degrade(read_png(TREE_SR))

    f32_err = float(np.abs(outputs[torch.float32]["crop67x93"] - golden).max())
    bf16_psnr = psnr(outputs[torch.bfloat16]["crop67x93"], golden)
    tree_psnr = psnr(outputs[torch.bfloat16]["tree"], outputs[torch.float32]["tree"])
    emit(golden={"f32_max_abs_err": f32_err, "f32_bound": 1e-4, "bf16_psnr_db": bf16_psnr,
                 "bf16_psnr_floor_db": 40.0, "tree_bf16_vs_f32_psnr_db": tree_psnr})
    check(f32_err <= 1e-4, f"f32 crop differs from the JAX golden output by {f32_err}")
    check(bf16_psnr >= 40.0, f"bf16 crop PSNR {bf16_psnr:.2f} dB against the JAX golden output")

    emit(fused_rdb_launches={DTYPE_NAME[d]: {"serve": launches[d], "eval": eval_launches[d]}
                             for d in launches})
    kernels = [kernel_record(state_dict, d, launches[d] + eval_launches[d])
               for d in (torch.bfloat16, torch.float32)]
    kernels.append(conv_record(tool_launches["conv3x3"]))
    kernels += [mm_record(kind, m, k, n, tool_launches[kind])
                for kind in ("mm_grid", "mm_resident") for m, k, n in conv_exp.GATE_SHAPES]
    emit(seconds=round(time.perf_counter() - t_start, 1))
    emit(kernels=kernels)
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
