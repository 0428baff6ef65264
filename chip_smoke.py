#!/usr/bin/env python3
"""End-to-end smoke of the PyTorch/CUDA port's serving path on one GPU.

    python3 chip_smoke.py          # from the repository root, no arguments

1. prints the card's name and power limit, as nvidia-smi gives them;
2. builds every CUDA kernel source of ``real_esrgan_tpu_torch/csrc`` anew
   with nvcc (all at once), printing each source's build seconds and the
   ptxas lines (registers, spills; no build may warn C7520, serialised
   ``wgmma``), the tensor-core, TMA, mbarrier, shared- and local-memory
   instructions of each kernel as ``cuobjdump -sass`` lists them (checked:
   the bf16 RDB kernel and every ``mm_grid``, ``mm_resident`` and
   ``conv3x3`` kernel on ``HGMMA`` and ``UTMALDG`` without ``HMMA``, the f32
   RDB kernel on ``HMMA``, no ``LDL``/``STL`` in either RDB kernel,
   ``conv3x3`` or ``mm_resident``), and each kernel's block plan beside what
   the built library reports (checked equal);
3. serves with ``SRPipeline`` and the committed weights
   (``assets/inenv10_esrnet_ema.npz``) in bfloat16 and float32: the test
   image twice, a bucketed crop, a wide image in 528/8/8 tiles and the
   ragged crop of the committed JAX golden output; every output finite, in
   [0, 1] and 4x its input; 69 RDB kernel and 3 tail kernel launches a
   forward; the bf16 tiled image's interior seam error against a
   whole-image forward; the f32 crop within 1e-4 of the JAX golden and the
   bf16 crop at 40 dB or more;
4. runs the experiment tool (``tools/conv_exp``: default, ``--mm``,
   ``--gate``, the ``mm_grid`` probe) with the K2-K4 launches counted from 0;
   and the evaluation entry points on three crops of the test image (the
   ``test`` CLI in f32 and bf16, ``eval_pair``): 69 RDB kernel launches an
   image, their outputs;
5. holds the RDB kernel against ``rdb_plain`` with the trained weights of
   three RDBs at every shape the serving and evaluation paths gave it and
   three more, and on the real inputs of all 69 RDBs of a forward of the test
   image (|x| up to about 59) in each dtype; and the tail kernel against
   ``bias_lrelu_plain``, bit for bit, at every shape the serving path gave
   it;
6. serves SwinIR-L (``SRPipeline(arch="swinir_l")``, the benchmark's
   configuration and seeded weights) on the test image and the wide image
   in both dtypes against the plain reference ``benchmark/reference/swinir.py``
   on the same geometry: float32 within SWINIR_F32_BOUND, bf16 within the
   ``swinir_l.batch256`` cell's ``out_err_ratio`` limit; 54 window-attention,
   110 LayerNorm and 3 tail kernel launches a forward;
7. drives the other ways into the generator's forward, each with its RDB and
   tail kernel launches: the JAX Orbax fixtures read (every leaf against
   ``leaves.json``) and served from (``SRPipeline`` bit for bit against the
   ``.npz`` cut, ``eval_pair`` in a subprocess); both trainers' per-epoch
   validation; the wide image over two replicas on the one card (f32 the
   same bits as one device, bf16 within the seam bound, no replica forward
   waits on the host); the HTTP front end (the test image and the wide
   image, bit for bit against ``SRPipeline.upscale``); ``graft_entry``;
   ``make_lr`` and ``validate_parity`` against a ``--cpu`` run; and
   ``tile_sweep``;
8. times each kernel against its plain version, its bound and, where one
   PyTorch call computes the same function, that call, in a host loop and
   inside a CUDA graph, and prints one JSON line ``{"kernels": [...]}`` with
   each kernel's launches over the run; the last line is
   ``{"ok": true, "device": {...}}``.

Every check raises on failure, so the script exits non-zero and prints no
result; without CUDA it exits non-zero at once.  TF32 is off.  Every other
check of the port on the card is a ``cuda`` test:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda*.py \\
        tests/test_torch_{tail_epilogue,swinir,layer_norm}.py
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import torch

from real_esrgan_tpu_torch import test as test_cli
from real_esrgan_tpu_torch.models import rrdbnet
from real_esrgan_tpu_torch.models.rrdbnet import ResidualDenseBlock
from real_esrgan_tpu_torch.ops import _build
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
from real_esrgan_tpu_torch.ops.layer_norm import layer_norm, layer_norm_plain
from real_esrgan_tpu_torch.ops.resize import matlab_resize
from real_esrgan_tpu_torch.ops.tail_epilogue import bias_lrelu, bias_lrelu_plain
from real_esrgan_tpu_torch.ops.window_attn import window_attn, window_attn_plain
from real_esrgan_tpu_torch.parallel.tiling import pad_for_tiles, tile_grid
from real_esrgan_tpu_torch.scripts import eval_pair
from real_esrgan_tpu_torch.serve import SRPipeline
from real_esrgan_tpu_torch.tools import conv_exp
from real_esrgan_tpu_torch.train.checkpoint import load_generator_params
from real_esrgan_tpu_torch.utils import zstd
from real_esrgan_tpu_torch.utils.imgio import read_png, write_png
from real_esrgan_tpu_torch.utils.orbax_read import read_pytree

ROOT = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(ROOT, "assets", "inenv10_esrnet_ema.npz")
TREE = os.path.join(ROOT, "tests", "data", "tree_lr.png")
GOLDEN = os.path.join(ROOT, "tests", "data", "jax_sr_tree_crop67x93_f32.npy")
TREE_SR = os.path.join(ROOT, "tests", "data", "tree_sr.png")
CROP = (slice(64, 131), slice(128, 221))  # the golden file's input crop

RDBS_PER_FORWARD = 69  # 23 RRDBs x 3 RDBs
TAIL_PER_FORWARD = 3  # the tail kernel after upsampling1, upsampling2 and conv3
# the tail kernel's launches by dtype name and path, as count_tail read them
TAIL_LAUNCHES = {"bf16": {}, "f32": {}}
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
BF16_TOLERANCE = TOLERANCE[torch.bfloat16]
DTYPE_NAME = {torch.float32: "f32", torch.bfloat16: "bf16"}
# K1's kernels in csrc/fused_rdb.cu, as cuobjdump names them
RDB_KERNEL_NAMES = ("rdb_bf16_wgmma_kernel", "rdb_f32_split_kernel")
# the kernels sass_counts names, by the name in their mangled symbols
KERNEL_NAMES = RDB_KERNEL_NAMES + ("mm_grid_kernel", "mm_resident_kernel", "conv3x3_kernel")
# SASS instructions counted per kernel: tensor cores (HMMA: mma.sync; HGMMA:
# wgmma), ldmatrix, cp.async, TMA loads, mbarrier operations, barriers,
# local memory
SASS_OPS = ("HMMA", "HGMMA", "LDSM", "LDGSTS", "UTMALDG", "SYNCS", "BAR", "LDL", "STL")
# beyond the serving path's shapes: a ragged batch, a block smaller than a tile
# (fragment tail and clamp), three ragged images (masks at T=16, batch index)
K1_EXTRA_SHAPES = {(2, 67, 93, 64), (1, 5, 3, 64), (3, 17, 40, 64)}
# interior seam error of the bf16 tiled output against a whole-image forward,
# 8-bit levels: bf16 rounding gives a max near 5 and a mean near 0.12; a tile
# computed wrong gives far more
SEAM_LIMIT = {"max": 16.0, "mean": 0.5}
KERNEL_SOURCES = ("fused_rdb", "conv3x3", "mm_probe", "window_attn", "layer_norm")
# SwinIR-L (models/swinir.py) at the benchmark's configuration and seeded
# weights: 54 window-attention launches, 110 LayerNorm launches and 3 of the
# tail kernel a forward;
# the serve path against the plain reference, float32 within SWINIR_F32_BOUND
# (TF32 off; sums in another order), bf16 by the cell's GapRatio limit
SWINIR_CONFIG = os.path.join(ROOT, "benchmark", "configs", "swinir_l_realsr_x4.json")
SWINIR_LIMITS = os.path.join(ROOT, "benchmark", "limits", "swinir_l.batch256.json")
SWINIR_SEED = 2 ** 31 + 22
WINDOW_ATTN_PER_FORWARD = 54
LAYER_NORM_PER_FORWARD = 110  # norm1 and norm2 of 54 Swin blocks, patch_embed.norm, norm
SWINIR_F32_BOUND = 1e-3
# the window-attention kernel's timed shape: the SwinIR cell's 16 x 256^2
# tokens of 3 x 240 channels
WINDOW_ATTN_SHAPE = (16, 256, 256, 720)
LAYER_NORM_SHAPE = (16, 256, 256, 240)  # the SwinIR cell's tokens, SwinIR-L's width
CONV_SHAPE = (8, 256, 256, 64, 192, 32)  # the tool's default: B, H, W, Cin, Cout, tile
MM_REPS = 32
# crops of the test image the evaluation path scores: (top, left, height, width)
EVAL_CROPS = {"a_64x64.png": (0, 0, 64, 64), "b_96x128.png": (100, 200, 96, 128),
              "c_50x70.png": (30, 400, 50, 70)}
ORBAX_DATA = os.path.join(ROOT, "tests", "data", "jax_orbax")
ORBAX_FIXTURES = ("g_c64_b1", "esrnet_c16/g_epoch_1", "gan_c16/g_epoch_1", "gan_c16/d_epoch_1")
ORBAX_G = os.path.join(ORBAX_DATA, "g_c64_b1")
# the trainers' validation images: crops of 300 of tests/data/tree_sr.png
# (centre-cropped to 256, LR 64)
VALID_CORNERS = ((0, 0), (400, 900), (700, 1700))
TILED_PSNR_DB = 40.0  # bf16 over two replicas against one device
# y, x, h, w: LR 64x64, 75x100 and 82x62, four or more NIQE blocks of 96 each
PARITY_CROPS = ((0, 0, 256, 256), (300, 700, 303, 401), (600, 1400, 330, 250))
PIXEL_MATCH_DB = 40.0
SWEEP_COMBOS = "528,8,8;272,8,16"


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


@contextlib.contextmanager
def record_tail_shapes(shapes: dict):
    """While open, adds (shape, shuffle) of every input the generator hands
    the tail kernel to ``shapes[dtype]``."""
    def recorded(y, bias, shuffle):
        shapes[y.dtype].add((tuple(y.shape), shuffle))
        return bias_lrelu(y, bias, shuffle)
    rrdbnet.bias_lrelu = recorded
    try:
        yield
    finally:
        rrdbnet.bias_lrelu = bias_lrelu


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


def tail_inputs(shape, shuffle: bool, dtype: torch.dtype, gen: torch.Generator):
    """y (N, G C, H, W) in channels_last from N(0, 2^2) and a float32 bias of C
    from N(0, 0.1^2), for the tail kernel."""
    n, gc, h, w = shape
    y = (torch.randn((n, h, w, gc), generator=gen, device="cuda") * 2.0).to(dtype)
    bias = torch.randn(gc // (4 if shuffle else 1), generator=gen, device="cuda") * 0.1
    return y.permute(0, 3, 1, 2), bias


def check_tail_kernel(shapes: dict) -> None:
    """The tail kernel against bias_lrelu_plain on the card, ``torch.equal``,
    at every (shape, shuffle) the serving path gave it in each dtype."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    for dtype in (torch.bfloat16, torch.float32):
        check(any(shuffle for _, shuffle in shapes[dtype])
              and not all(shuffle for _, shuffle in shapes[dtype]),
              f"the serving path gave the tail kernel {shapes[dtype]} in {DTYPE_NAME[dtype]}")
        for shape, shuffle in sorted(shapes[dtype]):
            y, bias = tail_inputs(shape, shuffle, dtype, gen)
            ref = bias_lrelu_plain(y, bias, shuffle)
            out = bias_lrelu(y.clone(memory_format=torch.channels_last), bias, shuffle)
            same = bool(torch.equal(out, ref)) and out.stride() == ref.stride()
            emit(tail_check={"dtype": DTYPE_NAME[dtype], "shape": list(shape),
                             "shuffle": shuffle, "equal": same})
            check(same, f"the tail kernel {DTYPE_NAME[dtype]} {shape} shuffle={shuffle} "
                        "differs from bias_lrelu_plain")
            del y, ref, out
            torch.cuda.empty_cache()


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
        before, tail_before = fused_rdb.launches, bias_lrelu.launches
        t0 = time.perf_counter()
        out = pipe.upscale(image)
        seconds = time.perf_counter() - t0
        launched, tail = fused_rdb.launches - before, bias_lrelu.launches - tail_before
        h, w, _ = image.shape
        emit(request={"dtype": DTYPE_NAME[dtype], "name": name, "in": [h, w],
                      "out": list(out.shape), "seconds": round(seconds, 4),
                      "fused_rdb_launches": launched, "bias_lrelu_launches": tail})
        check(out.shape == (4 * h, 4 * w, 3), f"{name} output shape {out.shape}")
        check(bool(np.isfinite(out).all()), f"{name} output not finite")
        check(float(out.min()) >= 0.0 and float(out.max()) <= 1.0, f"{name} output outside [0, 1]")
        check(launched == RDBS_PER_FORWARD * forwards,
              f"{name}: fused_rdb launched {launched} times, expected {RDBS_PER_FORWARD * forwards}")
        check(tail == TAIL_PER_FORWARD * forwards,
              f"{name}: the tail kernel launched {tail} times for {forwards} forwards")
        outputs[name] = out
    # the golden crop is a plain Generator forward of the ragged 67x93 input
    before, tail_before = fused_rdb.launches, bias_lrelu.launches
    crop = torch.from_numpy(np.ascontiguousarray(tree[CROP]))[None].cuda()
    outputs["crop67x93"] = pipe.apply(crop)[0].cpu().numpy()
    check(fused_rdb.launches - before == RDBS_PER_FORWARD
          and bias_lrelu.launches - tail_before == TAIL_PER_FORWARD, "crop67x93 launch count")
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


def count_tail(path: str, dtype: torch.dtype, launched: int, rdb_launched: int,
               rdbs_per_forward: int = RDBS_PER_FORWARD) -> None:
    """The tail kernel launched TAIL_PER_FORWARD times beside each forward's
    ``rdbs_per_forward`` RDB launches on ``path``; adds its launches to
    TAIL_LAUNCHES."""
    counts = TAIL_LAUNCHES[DTYPE_NAME[dtype]]
    counts[path] = counts.get(path, 0) + launched
    check(launched * rdbs_per_forward == TAIL_PER_FORWARD * rdb_launched,
          f"{path}: the tail kernel launched {launched} times beside {rdb_launched} RDB "
          f"launches, not {TAIL_PER_FORWARD} a forward of {rdbs_per_forward}")


def drive_conv_exp() -> dict:
    """The experiment tool in process on the card: default run, ``--mm``,
    ``--gate``, and the ``mm_grid`` probe, which the tool keeps callable.
    Returns the launch counts of the run, counted from 0."""
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


def write_eval_pairs(tree: np.ndarray, root: str) -> tuple:
    """EVAL_CROPS of the test image as LR PNGs and their x4 MATLAB-bicubic
    upscales as HR PNGs, under ``root``/lr and ``root``/hr."""
    lr_dir, hr_dir = os.path.join(root, "lr"), os.path.join(root, "hr")
    os.makedirs(lr_dir), os.makedirs(hr_dir)
    for name, (top, left, h, w) in EVAL_CROPS.items():
        lr = np.ascontiguousarray(tree[top:top + h, left:left + w])
        hr = matlab_resize(torch.from_numpy(lr).cuda(), 4.0).clamp(0, 1).cpu().numpy()
        write_png(os.path.join(lr_dir, name), np.round(lr * 255.0).astype(np.uint8))
        write_png(os.path.join(hr_dir, name), np.round(hr * 255.0).astype(np.uint8))
    return lr_dir, hr_dir


def drive_eval(tree: np.ndarray, rdb_shapes: dict) -> dict:
    """The evaluation entry points (the ``test`` CLI in f32 and bf16,
    ``eval_pair`` in bf16) on three crops of the test image at full width
    and depth, with the RDB kernel's input shapes added to ``rdb_shapes``.
    Returns fused_rdb's launch counts by dtype."""
    launches = {}
    seen = {dtype: set() for dtype in rdb_shapes}
    hook = record_rdb_shapes(seen)
    with tempfile.TemporaryDirectory() as tmp:
        lr_dir, hr_dir = write_eval_pairs(tree, tmp)

        def run(label, dtype, call):
            fused_rdb.launches = bias_lrelu.launches = 0
            result = call()
            launched = fused_rdb.launches
            count_tail(f"eval.{label}", dtype, bias_lrelu.launches, launched)
            launches[dtype] = launches.get(dtype, 0) + launched
            emit(eval={"entry": label, "dtype": DTYPE_NAME[dtype],
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


def orbax_leaves(tree, prefix=()):
    """(path, leaf) pairs of a tree read by ``read_pytree``, in the order and
    with the names of ``leaves.json``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from orbax_leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from orbax_leaves(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def orbax_read_fixtures() -> None:
    """Builds the zstd decoder (g++, at first use), then reads every leaf of
    every fixture against leaves.json (dtype, shape, SHA-256)."""
    zstd.library()
    with open(os.path.join(ORBAX_DATA, "leaves.json")) as f:
        expected = json.load(f)
    for name in ORBAX_FIXTURES:
        leaves = list(orbax_leaves(read_pytree(os.path.join(ORBAX_DATA, name))))
        check([p for p, _ in leaves] == [leaf["path"] for leaf in expected[name]],
              f"{name}: the leaves' paths differ from leaves.json")
        for (path, value), leaf in zip(leaves, expected[name]):
            if leaf["dtype"] is None:
                check(value is None, f"{name}/{path} is not None")
                continue
            if isinstance(value, torch.Tensor):
                got = ("bfloat16", list(value.shape), value.view(torch.int16).numpy().tobytes())
            else:
                arr = np.asarray(value)
                got = (str(arr.dtype), list(arr.shape), arr.tobytes())
            check((got[0], got[1], hashlib.sha256(got[2]).hexdigest())
                  == (leaf["dtype"], leaf["shape"], leaf["sha256"]),
                  f"{name}/{path} differs from leaves.json")
    emit(orbax_leaves={"fixtures": list(ORBAX_FIXTURES), "all_equal_to_leaves_json": True})


def orbax_serve(tree: np.ndarray, tmp: str) -> dict:
    """SRPipeline from the Orbax directory g_c64_b1 (one RRDB, full width) in
    both dtypes, bit for bit against the .npz cut to trunk_0.  Returns the
    Orbax route's RDB kernel launches by dtype."""
    cut = os.path.join(tmp, "c64_b1.npz")
    with np.load(WEIGHTS) as data:
        np.savez(cut, **{k: data[k] for k in data.files
                         if not k.startswith("trunk_") or k.startswith("trunk_0/")})
    launches = {}
    for dtype in (torch.bfloat16, torch.float32):
        outs = {}
        for route, path in (("orbax", ORBAX_G), ("npz_cut", cut)):
            pipe = SRPipeline(path, num_rrdb=1, bfloat16=dtype == torch.bfloat16, device="cuda")
            fused_rdb.launches = bias_lrelu.launches = 0
            outs[route] = pipe.upscale(tree)
            outs[route + "_launches"] = fused_rdb.launches
            count_tail(f"orbax_serve.{route}", dtype, bias_lrelu.launches, fused_rdb.launches,
                       rdbs_per_forward=3)
            del pipe
        launches[dtype] = outs["orbax_launches"]
        same = bool(np.array_equal(outs["orbax"], outs["npz_cut"]))
        emit(orbax_serve={"dtype": DTYPE_NAME[dtype], "weights": os.path.relpath(ORBAX_G, ROOT),
                          "num_rrdb": 1, "in": list(tree.shape[:2]),
                          "out": list(outs["orbax"].shape[:2]),
                          "fused_rdb_launches": outs["orbax_launches"],
                          "npz_cut_launches": outs["npz_cut_launches"],
                          "bit_equal_to_npz_cut": same,
                          "finite": bool(np.isfinite(outs["orbax"]).all())})
        check(outs["orbax_launches"] == 3 and outs["npz_cut_launches"] == 3,
              f"orbax serve ({DTYPE_NAME[dtype]}): fused_rdb launched {outs['orbax_launches']} "
              "times for one RRDB")
        check(same, f"orbax serve ({DTYPE_NAME[dtype]}) differs from the .npz route")
    torch.cuda.empty_cache()
    return launches


def orbax_eval_pair(tree: np.ndarray, tmp: str) -> int:
    """``python -m ...scripts.eval_pair --weights g_c64_b1 --num-rrdb 1`` on
    the evaluation pairs, its RDB kernel launches through
    FUSED_RDB_LAUNCH_LOG.  Returns them."""
    lr_dir, hr_dir = write_eval_pairs(tree, os.path.join(tmp, "pairs"))
    log = os.path.join(tmp, "eval_pair_launches.jsonl")
    run = subprocess.run([sys.executable, "-m", "real_esrgan_tpu_torch.scripts.eval_pair",
                          "--weights", os.path.relpath(ORBAX_G, ROOT), "--num-rrdb", "1",
                          "--lr-dir", lr_dir, "--hr-dir", hr_dir], cwd=ROOT,
                         env=dict(os.environ, FUSED_RDB_LAUNCH_LOG=log), capture_output=True,
                         text=True, timeout=300)
    check(run.returncode == 0, f"eval_pair on the Orbax directory exited {run.returncode}: "
                               f"{run.stderr[-2000:]}")
    summary = json.loads(run.stdout.strip().splitlines()[-1])
    with open(log) as f:
        launched = sum(json.loads(line)["launches"] for line in f)
    emit(orbax_eval_pair={"summary": summary, "fused_rdb_launches": launched})
    check(summary["n"] == len(EVAL_CROPS) and math.isfinite(summary["psnr_mean"]),
          f"eval_pair summary {summary}")
    check(launched == 3 * len(EVAL_CROPS),
          f"eval_pair launched fused_rdb {launched} times for {len(EVAL_CROPS)} images")
    return launched


def drive_orbax(tree: np.ndarray) -> dict:
    """The JAX Orbax fixtures read on the card's machine, and served from
    (``SRPipeline``, ``eval_pair``).  Returns the RDB kernel's launches by
    path and dtype."""
    orbax_read_fixtures()
    with tempfile.TemporaryDirectory() as tmp:
        launches = orbax_serve(tree, tmp)
        eval_launches = orbax_eval_pair(tree, tmp)
    return {torch.bfloat16: {"orbax_serve": launches[torch.bfloat16],
                             "orbax_eval_pair": eval_launches},
            torch.float32: {"orbax_serve": launches[torch.float32]}}


def drive_validation(state_dict, tree_sr: np.ndarray) -> dict:
    """Each trainer's per-epoch validation (``train_realesrnet.validate``, the
    evaluation model ``build_generator(training=False)`` at the trainer's
    configuration) with the committed weights on VALID_CORNERS crops of 300
    of tests/data/tree_sr.png: 69 RDB kernel launches an image, a finite
    NIQE.  Returns the launches by trainer."""
    from real_esrgan_tpu_torch import config as run_config
    from real_esrgan_tpu_torch import train_realesrnet
    from real_esrgan_tpu_torch.data.dataset import ValidImageDataset
    from real_esrgan_tpu_torch.metrics.niqe import NIQE
    from real_esrgan_tpu_torch.train.esrnet import build_generator, make_eval_fn

    geo, launches = run_config.geometry, {}
    params = {k: v.cuda() for k, v in state_dict.items()}
    niqe = NIQE(crop_border=run_config.model.upscale_factor, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        for i, (y, x) in enumerate(VALID_CORNERS):
            write_png(os.path.join(tmp, f"valid_{i}.png"), tree_sr[y:y + 300, x:x + 300])
        dataset = ValidImageDataset(tmp, geo.crop_size, geo.scale)
        for name, cfg in (("train_validation", run_config.train_esrnet),
                          ("gan_validation", run_config.train_esrgan)):
            eval_fn = make_eval_fn(build_generator(run_config.model, cfg, "cuda", training=False))
            dtype = torch.bfloat16 if cfg.use_bfloat16 else torch.float32
            fused_rdb.launches = bias_lrelu.launches = 0
            with contextlib.redirect_stdout(io.StringIO()):
                score = train_realesrnet.validate(eval_fn, params, dataset, niqe, "Valid", 0,
                                                  "cuda")
            launches[name] = fused_rdb.launches
            count_tail(name, dtype, bias_lrelu.launches, fused_rdb.launches)
            emit(validation={"trainer": name, "dtype": DTYPE_NAME[dtype], "images": len(dataset),
                             "niqe": score, "fused_rdb_launches": fused_rdb.launches})
            check(fused_rdb.launches == RDBS_PER_FORWARD * len(VALID_CORNERS),
                  f"{name}: fused_rdb launched {fused_rdb.launches} times for "
                  f"{len(VALID_CORNERS)} images")
            check(math.isfinite(score), f"{name}: validation NIQE {score}")
            del eval_fn
    torch.cuda.empty_cache()
    return launches


def tiled_devices(wide: np.ndarray, outputs: dict) -> dict:
    """Tiled serving over two replicas on the one card against one device
    on the wide image (4 tiles of 528/8/8, one batch of 8 split in two
    chunks of 2): f32 the same bits, bf16 within the seam bound of a
    whole-image forward and TILED_PSNR_DB of the one-device output; the RDB
    kernel's launches counted from 0; one forward of a replica under CUDA's
    sync debug mode, which raises if it waits on the host.  Returns the
    launches by dtype."""
    devices = [torch.device("cuda", 0)] * 2
    launches, record = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        pipe = SRPipeline(WEIGHTS, bfloat16=dtype == torch.bfloat16, devices=devices)
        core = pipe.tile - 2 * pipe.tile_overlap
        n_tiles = math.ceil(wide.shape[0] / core) * math.ceil(wide.shape[1] / core)
        chunks = sum(min(len(devices), n_tiles - start)
                     for start in range(0, n_tiles, pipe.tile_batch))
        fused_rdb.launches = bias_lrelu.launches = 0
        out = pipe.upscale(wide)
        launches[dtype] = fused_rdb.launches
        count_tail("tiled_devices", dtype, bias_lrelu.launches, launches[dtype])
        one = outputs[dtype]
        name = DTYPE_NAME[dtype]
        # a replica's forward must not wait on the host, or the devices could
        # not overlap: CUDA's sync debug mode raises on any synchronizing call
        tiles = torch.from_numpy(np.ascontiguousarray(wide[:pipe.tile, :pipe.tile]))[None].cuda()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.no_grad():
                pipe.models[1](tiles)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        record[name] = {"fused_rdb_launches": launches[dtype], "chunks": chunks,
                        "same_bits_as_one_device": bool(np.array_equal(out, one)),
                        "max_abs_vs_one_device": float(np.abs(out - one).max()),
                        "psnr_vs_one_device_db": psnr(out, one)}
        check(launches[dtype] == RDBS_PER_FORWARD * chunks,
              f"{name} tiled over two replicas launched fused_rdb {launches[dtype]} times, "
              f"expected {RDBS_PER_FORWARD * chunks}")
        check(out.shape == one.shape and bool(np.isfinite(out).all()), f"{name} tiled output")
        if dtype == torch.float32:
            check(record[name]["same_bits_as_one_device"],
                  "f32 tiled output over two replicas differs from one device's")
        else:
            record[name]["seam"] = seam_error(pipe, wide, out)
            for stat, limit in SEAM_LIMIT.items():
                check(record[name]["seam"]["interior_8bit"][stat] <= limit,
                      f"bf16 two-replica interior seam {stat} exceeds {limit}")
            check(record[name]["psnr_vs_one_device_db"] >= TILED_PSNR_DB,
                  "bf16 tiled output over two replicas against one device's")
        del pipe
        torch.cuda.empty_cache()
    emit(tiled_devices=record)
    return launches


def front_end_http(tree: np.ndarray, wide: np.ndarray) -> int:
    """The HTTP front end on 127.0.0.1 (bf16, the committed weights, warmup
    256): the tree image and the wide image (tiled) POSTed as PNGs; each
    answer the bits of ``SRPipeline.upscale`` quantised as the server does;
    ``/healthz`` and ``/stats``; K1's launches a request.  Returns them."""
    from real_esrgan_tpu_torch.scripts import serve_http
    from real_esrgan_tpu_torch.tools.dp_check import free_port
    from real_esrgan_tpu_torch.utils.imgio import decode_png, encode_png

    handler = serve_http.build_app(WEIGHTS, bfloat16=True, warmup_size=256)
    server = ThreadingHTTPServer(("127.0.0.1", free_port()), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    pipeline = handler.pipeline_ref
    launches, requests = 0, []
    try:
        for name, image in (("tree", tree), ("wide_tiled", wide)):
            body = encode_png((image * 255.0 + 0.5).astype(np.uint8))
            lr = decode_png(body).astype(np.float32) / 255.0
            before, tail_before = fused_rdb.launches, bias_lrelu.launches
            req = urllib.request.Request(url + "/upscale", data=body, method="POST")
            with urllib.request.urlopen(req, timeout=300) as resp:
                png = resp.read()
            launched = fused_rdb.launches - before
            count_tail(f"front_end_http.{name}", torch.bfloat16, bias_lrelu.launches - tail_before,
                       launched)
            got = decode_png(png)
            with torch.no_grad():
                expected = serve_http.quantize(pipeline.upscale(lr))
            check(np.array_equal(got, expected),
                  f"HTTP {name}: the PNG differs from SRPipeline.upscale's bits")
            core = pipeline.tile - 2 * pipeline.tile_overlap
            forwards = 1 if max(image.shape[:2]) <= pipeline.tile_threshold else math.ceil(
                math.ceil(image.shape[0] / core) * math.ceil(image.shape[1] / core)
                / pipeline.tile_batch)
            check(launched == RDBS_PER_FORWARD * forwards,
                  f"HTTP {name}: fused_rdb launched {launched} times, not "
                  f"{RDBS_PER_FORWARD * forwards}")
            launches += launched
            requests.append({"name": name, "in": list(image.shape[:2]), "out": list(got.shape),
                             "fused_rdb_launches": launched})
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        with urllib.request.urlopen(url + "/stats", timeout=30) as resp:
            stats = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    emit(front_end_http={"requests": requests, "healthz": health, "stats": stats})
    check(health == {"status": "ok", "device": "cuda", "served": 2}, f"/healthz gave {health}")
    check(stats.get("count") == 2, f"/stats gave {stats}")
    return launches


def front_end_graft_entry() -> int:
    """``graft_entry.entry()`` on the card (69 K1 launches, (1, 256, 256, 3),
    finite), then ``dryrun_multichip(2)`` (two gloo ranks on the CPU)."""
    from real_esrgan_tpu_torch import graft_entry

    fn, (params, x) = graft_entry.entry()
    before, tail_before = fused_rdb.launches, bias_lrelu.launches
    out = fn(params, x)
    torch.cuda.synchronize()
    launched = fused_rdb.launches - before
    count_tail("graft_entry", torch.bfloat16, bias_lrelu.launches - tail_before, launched)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        graft_entry.dryrun_multichip(2)
    lines = printed.getvalue().splitlines()
    emit(front_end_graft_entry={"device": str(out.device), "shape": list(out.shape),
                                "dtype": str(out.dtype), "fused_rdb_launches": launched,
                                "dryrun": lines})
    check(out.is_cuda and tuple(out.shape) == (1, 256, 256, 3), f"entry() gave {out.shape}")
    check(bool(torch.isfinite(out).all()), "entry()'s output is not finite")
    check(launched == RDBS_PER_FORWARD, f"entry() launched fused_rdb {launched} times")
    check(len(lines) == 3 and all(line.startswith("dryrun_multichip(2): ") for line in lines),
          f"dryrun_multichip(2) printed {lines}")
    return launched


def front_end_parity_scripts(tree_sr: np.ndarray) -> int:
    """``scripts.make_lr`` on the card over three crops of tree_sr.png, then
    ``scripts.validate_parity`` on the card (bf16) against a ``--cpu`` run's
    SR outputs (f32) of those LR images: the pixel match held at
    PIXEL_MATCH_DB; the NIQE entry printed, not held (these are not Set5
    images: ``--niqe-tol`` 1000).  Returns the card run's K1 launches."""
    from real_esrgan_tpu_torch.scripts import make_lr, validate_parity

    with tempfile.TemporaryDirectory() as tmp:
        gt_dir = os.path.join(tmp, "gt")
        os.makedirs(gt_dir)
        for i, (y, x, h, w) in enumerate(PARITY_CROPS):
            write_png(os.path.join(gt_dir, f"crop{i}.png"), tree_sr[y:y + h, x:x + w])
        pairs = os.path.join(tmp, "pairs")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            make_lr.main(["--gt-dir", gt_dir, "--output-dir", pairs])
        lr_dir = os.path.join(pairs, "LRbicx4")
        shapes = {name: list(read_png(os.path.join(lr_dir, name)).shape)
                  for name in sorted(os.listdir(lr_dir))}
        check(len(shapes) == len(PARITY_CROPS) and "on cuda" in printed.getvalue(),
              f"make_lr wrote {shapes}: {printed.getvalue()[-500:]}")
        common = ["--weights", WEIGHTS, "--model", "realesrnet", "--set5-lr", lr_dir,
                  "--niqe-tol", "1000"]
        verdicts, launched = {}, 0
        for name, extra in (("cpu", ["--cpu", "--sr-out-dir", os.path.join(tmp, "cpu_sr")]),
                            ("card", ["--reference-sr-dir", os.path.join(tmp, "cpu_sr", "Set5"),
                                      "--pixel-match-psnr", str(PIXEL_MATCH_DB)])):
            report = os.path.join(tmp, f"{name}.json")
            before, tail_before = fused_rdb.launches, bias_lrelu.launches
            with contextlib.redirect_stdout(io.StringIO()):
                rc = validate_parity.main(common + extra + ["--report", report])
            launched = fused_rdb.launches - before
            count_tail(f"parity_scripts.{name}", torch.bfloat16,
                       bias_lrelu.launches - tail_before, launched)
            with open(report) as f:
                verdicts[name] = {"rc": rc, **json.load(f)}
    emit(front_end_parity_scripts={"lr_shapes": shapes, "verdicts": verdicts,
                                   "card_fused_rdb_launches": launched})
    for name, verdict in verdicts.items():
        check(verdict["rc"] == 0, f"validate_parity ({name}) exited {verdict['rc']}")
    match = [c for c in verdicts["card"]["checks"] if c["check"] == "pixel_match_psnr"]
    check(len(match) == 1 and match[0]["ok"] and match[0]["value"] >= PIXEL_MATCH_DB,
          f"validate_parity's pixel match: {match}")
    check(launched == 2 * RDBS_PER_FORWARD * len(PARITY_CROPS),
          f"validate_parity on the card launched fused_rdb {launched} times")
    return launched


def front_end_tile_sweep() -> int:
    """``tools.tile_sweep --combos SWEEP_COMBOS --seam`` at 2048 on the card:
    one row a combo, each with a rate above 0 and a finite seam error.
    Returns its K1 launches."""
    from real_esrgan_tpu_torch.tools import tile_sweep

    printed = io.StringIO()
    before, tail_before = fused_rdb.launches, bias_lrelu.launches
    with contextlib.redirect_stdout(printed):
        tile_sweep.main(["--combos", SWEEP_COMBOS, "--seam"])
    launched = fused_rdb.launches - before
    count_tail("tile_sweep", torch.bfloat16, bias_lrelu.launches - tail_before, launched)
    rows = [json.loads(line) for line in printed.getvalue().splitlines() if line.startswith("{")]
    emit(front_end_tile_sweep={"in_size": 2048, "rows": rows, "fused_rdb_launches": launched})
    check(len(rows) == len(SWEEP_COMBOS.split(";")), f"tile_sweep printed {len(rows)} rows")
    for row in rows:
        check(row["mp_per_s"] > 0 and math.isfinite(row["seam"]["interior_8bit"]["max"]),
              f"tile_sweep row {row}")
    check(launched > 0, "tile_sweep never launched fused_rdb")
    return launched


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


def bound(flops: float, moved: float) -> dict:
    """The least time the card could take: operations over the bf16 peak
    against bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, moved / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def tail_record(dtype: torch.dtype, shape: tuple, launches: int) -> dict:
    """The tail kernel with the shuffle at ``shape``, y's (N, 4 C, H, W): its
    time and its plain version's in turns, both again inside a CUDA graph of
    10 launches, and its bound, the bytes it moves (y read, the output
    written) over HBM's rate; no one library call computes it."""
    y, bias = tail_inputs(shape, True, dtype, torch.Generator(device="cuda").manual_seed(7))
    y = y.contiguous(memory_format=torch.channels_last)
    kernel, plain = (lambda: bias_lrelu(y, bias, True)), (lambda: bias_lrelu_plain(y, bias, True))
    check(bool(torch.equal(kernel(), plain())),
          f"the tail kernel {DTYPE_NAME[dtype]} differs from bias_lrelu_plain at {shape}")
    ms, plain_ms = in_turns(kernel, plain, 10)
    device_ms, plain_device_ms = graph_ms(kernel, 10), graph_ms(plain, 10)
    moved = 2 * y.numel() * y.element_size() + bias.numel() * bias.element_size()
    return {"name": f"tail_epilogue[{DTYPE_NAME[dtype]}]", "route": "cuda",
            "source": "real_esrgan_tpu_torch/csrc/tail_epilogue.cu",
            "replaces": "real_esrgan_tpu/models/rrdbnet.py:150", "launches": launches,
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": moved / PEAK_BYTES * 1e3, "bound_by": "bytes", "library_ms": None,
            "device_ms": device_ms, "plain_device_ms": plain_device_ms, "shape": list(shape),
            "shuffle": True, "device_tb_per_s": moved / device_ms / 1e9}


def swinir_reference(params, cfg: dict, image: np.ndarray, pipe: SRPipeline,
                     dtype: torch.dtype) -> np.ndarray:
    """The plain SwinIR reference (``benchmark/reference/swinir.py``) on the
    pipeline's geometry: the image padded to the bucket and cropped back, or
    cut into the pipeline's tiles, each run alone, their cores stitched."""
    from benchmark.reference import swinir as reference

    h, w, _ = image.shape
    if max(h, w) <= pipe.tile_threshold:
        hb, wb = -(-h // pipe.bucket) * pipe.bucket, -(-w // pipe.bucket) * pipe.bucket
        padded = np.pad(image, ((0, hb - h), (0, wb - w), (0, 0)), mode="reflect")
        x = torch.from_numpy(np.ascontiguousarray(padded, np.float32))[None].cuda()
        return reference.forward_in_blocks(params, x, cfg, 1, dtype=dtype)[0, :4 * h, :4 * w]\
            .cpu().numpy()
    tile, overlap = pipe.tile, pipe.tile_overlap
    ny, nx, core = tile_grid(h, w, tile, overlap)
    canvas = torch.from_numpy(pad_for_tiles(image, tile, overlap)).cuda()
    out = np.zeros((ny * core * 4, nx * core * 4, 3), np.float32)
    for i in range(ny):
        for j in range(nx):
            x = canvas[i * core:i * core + tile, j * core:j * core + tile][None]
            sr = reference.forward_in_blocks(params, x, cfg, 1, dtype=dtype)[0].cpu().numpy()
            out[i * core * 4:(i + 1) * core * 4, j * core * 4:(j + 1) * core * 4] = \
                sr[overlap * 4:(overlap + core) * 4, overlap * 4:(overlap + core) * 4]
    return out[:4 * h, :4 * w]


def drive_swinir(tree: np.ndarray, wide: np.ndarray) -> dict:
    """SwinIR-L through ``SRPipeline(arch="swinir_l")`` on the benchmark's
    seeded weights, in bf16 and float32: the test image whole and the wide
    image in 528/8/8 tiles, each against the plain reference, with the
    window-attention, LayerNorm and tail kernels' launches counted.
    Returns the window-attention and LayerNorm launches by dtype."""
    from benchmark.harness import GapRatio
    from benchmark.weights_swinir import swinir_params

    t0 = time.perf_counter()
    with open(SWINIR_CONFIG) as f:
        cfg = json.load(f)
    with open(SWINIR_LIMITS) as f:
        limit = json.load(f)["limits"]["out_err_ratio"]
    params = swinir_params(cfg, SWINIR_SEED, "cuda")
    images = {"tree": tree, "wide_tiled": wide}
    refs, launches = {}, {"window_attn": dict.fromkeys(TOLERANCE, 0),
                          "layer_norm": dict.fromkeys(TOLERANCE, 0)}
    for dtype in (torch.bfloat16, torch.float32):
        pipe = SRPipeline(arch="swinir_l", bfloat16=dtype == torch.bfloat16, device="cuda")
        pipe.model.load_state_dict(params)
        for name, image in images.items():
            if name not in refs:
                refs[name] = {d: swinir_reference(params, cfg, image, pipe, d)
                              for d in (torch.float32, torch.bfloat16)}
            h, w, _ = image.shape
            ny, nx, _ = tile_grid(h, w, pipe.tile, pipe.tile_overlap)
            forwards = 1 if max(h, w) <= pipe.tile_threshold else -(-ny * nx // pipe.tile_batch)
            window_attn.launches = bias_lrelu.launches = layer_norm.launches = 0
            out = pipe.upscale(image)
            launched, tail = window_attn.launches, bias_lrelu.launches
            norms = layer_norm.launches
            launches["window_attn"][dtype] += launched
            launches["layer_norm"][dtype] += norms
            ref, ref16 = refs[name][torch.float32], refs[name][torch.bfloat16]
            gap = GapRatio()
            gap.add(*(torch.from_numpy(a)[None] for a in (out, ref, ref16)))
            record = {"dtype": DTYPE_NAME[dtype], "name": name, "in": [h, w],
                      "out": list(out.shape), "window_attn_launches": launched,
                      "layer_norm_launches": norms, "bias_lrelu_launches": tail,
                      "max_abs_vs_reference": float(np.abs(out - ref).max()),
                      "reference_bf16_max_abs": float(np.abs(ref16 - ref).max()),
                      "out_err_ratio": gap.value(), "limit": limit}
            emit(swinir_serve=record)
            check(out.shape == (4 * h, 4 * w, 3), f"swinir {name} output shape {out.shape}")
            check(launched == WINDOW_ATTN_PER_FORWARD * forwards and
                  norms == LAYER_NORM_PER_FORWARD * forwards and
                  tail == TAIL_PER_FORWARD * forwards,
                  f"swinir {name}: {launched} window_attn, {norms} layer_norm and {tail} tail "
                  f"launches for {forwards} forwards")
            if dtype == torch.float32:
                check(record["max_abs_vs_reference"] <= SWINIR_F32_BOUND,
                      f"swinir f32 {name} differs from the reference by "
                      f"{record['max_abs_vs_reference']}")
            else:
                check(record["out_err_ratio"] <= limit,
                      f"swinir bf16 {name}: out_err_ratio {record['out_err_ratio']} > {limit}")
        del pipe
        torch.cuda.empty_cache()
    emit(swinir_seconds=round(time.perf_counter() - t0, 1))
    return launches


def window_attn_record(dtype: torch.dtype, launches: int) -> dict:
    """The window-attention kernel at the SwinIR cell's shape, in a shifted
    block: its time and ``window_attn_plain``'s in turns, both again inside
    a CUDA graph of 10 launches, and its bound, the larger of q, k and v read
    once and the output written once over HBM's rate and its two products
    over the bf16 tensor-core rate (float32: the CUDA cores'); no call of the
    port's computes the same (``scaled_dot_product_attention`` is no kernel
    of the port)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    b, h, w, c3 = WINDOW_ATTN_SHAPE
    qkv = (torch.randn(WINDOW_ATTN_SHAPE, generator=gen, device="cuda") * 0.6).to(dtype)
    table = torch.randn(225, 8, generator=gen, device="cuda")
    kernel = (lambda: window_attn(qkv, table, 8, 4))
    plain = (lambda: window_attn_plain(qkv, table, 8, 4))
    out, ref = kernel().float(), plain().float()
    err = float((out - ref).abs().max())
    limit = 2e-5 if dtype == torch.float32 else 2 ** -8 * (1 + float(ref.abs().max()))
    check(err <= limit, f"window_attn {DTYPE_NAME[dtype]} differs from window_attn_plain by {err}")
    del out, ref
    ms, plain_ms = in_turns(kernel, plain, 10)
    device_ms, plain_device_ms = graph_ms(kernel, 10), graph_ms(plain, 3)
    tokens = b * h * w
    flops = 2 * 2 * 64 * (c3 // 3) * tokens
    moved = tokens * 4 * (c3 // 3) * qkv.element_size()
    # float32 runs its products on the CUDA cores
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_CUDA_CORE_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, moved / PEAK_BYTES * 1e3
    return {"name": f"window_attn[{DTYPE_NAME[dtype]}]", "route": "cuda",
            "source": "real_esrgan_tpu_torch/csrc/window_attn.cu", "replaces": None,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes
            else "bytes", "library_ms": None, "device_ms": device_ms,
            "plain_device_ms": plain_device_ms, "shape": list(WINDOW_ATTN_SHAPE), "shift": 4,
            "device_tb_per_s": moved / device_ms / 1e9,
            "bound_share": max(t_ops, t_bytes) / device_ms}


def layer_norm_record(dtype: torch.dtype, launches: int) -> dict:
    """The LayerNorm kernel at the SwinIR cell's shape: its time and
    ``layer_norm_plain``'s in turns, both again inside a CUDA graph of 10
    launches, ``F.layer_norm`` called alone as ``library_ms`` (a yardstick:
    the port calls it on the card only under autograd), and its bound, the
    input read once and the output written once over HBM's rate.  float32
    is held within 1e-5 of the plain version, bf16 within one bf16 ulp of
    each output beyond that (``max_ulp`` is over values of 1/16 or more)."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    c = LAYER_NORM_SHAPE[-1]
    x = (torch.randn(LAYER_NORM_SHAPE, generator=gen, device="cuda") * 1.5).to(dtype)
    weight = (1.0 + 0.2 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    bias = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    kernel = (lambda: layer_norm(x, weight, bias, 1e-5))
    plain = (lambda: layer_norm_plain(x, weight, bias, 1e-5))
    library = (lambda: torch.nn.functional.layer_norm(x, (c,), weight, bias, 1e-5))
    out, ref = kernel().float(), plain().float()
    err = (out - ref).abs()
    max_err, ulps, beyond, ulp = float(err.max()), None, 0.0, None
    if dtype == torch.bfloat16:  # one ulp of a bf16 value in [2^(e-1), 2^e) is 2^(e-8)
        ulp = torch.ldexp(torch.ones_like(err), torch.frexp(ref).exponent - 8)
        ulps = float((err / ulp)[ref.abs() >= 2 ** -4].max())
        beyond = float((err - ulp).max())
    check(max_err <= 1e-5 if ulps is None else beyond <= 1e-5,
          f"layer_norm {DTYPE_NAME[dtype]} differs from layer_norm_plain by {max_err} "
          f"({beyond} beyond one ulp)")
    del out, ref, err, ulp
    torch.cuda.empty_cache()
    ms, plain_ms = in_turns(kernel, plain, 20)
    device_ms, plain_device_ms = graph_ms(kernel, 10), graph_ms(plain, 10)
    moved = 2 * x.numel() * x.element_size() + 2 * c * x.element_size()
    return {"name": f"layer_norm[{DTYPE_NAME[dtype]}]", "route": "cuda",
            "source": "real_esrgan_tpu_torch/csrc/layer_norm.cu", "replaces": None,
            "launches": launches, "max_abs_err": max_err, "max_ulp": ulps,
            "beyond_one_ulp": beyond, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": moved / PEAK_BYTES * 1e3, "bound_by": "bytes",
            "library_ms": time_ms(library, 20), "library_device_ms": graph_ms(library, 10),
            "device_ms": device_ms, "plain_device_ms": plain_device_ms,
            "shape": list(LAYER_NORM_SHAPE), "device_tb_per_s": moved / device_ms / 1e9,
            "bound_share": moved / PEAK_BYTES * 1e3 / device_ms}


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
    tail_shapes = {dtype: set() for dtype in TOLERANCE}
    trunk_inputs = {}
    for dtype in (torch.bfloat16, torch.float32):
        pipe = SRPipeline(WEIGHTS, bfloat16=dtype == torch.bfloat16, device="cuda")
        hook = record_rdb_shapes(main_shapes)
        fused_rdb.launches = bias_lrelu.launches = 0
        with record_tail_shapes(tail_shapes):
            outputs[dtype] = serve(pipe, dtype, tree, wide)
        launches[dtype] = {"serve": fused_rdb.launches}
        TAIL_LAUNCHES[DTYPE_NAME[dtype]]["serve"] = bias_lrelu.launches
        hook.remove()
        check(fused_rdb.launches > 0, f"main path ({DTYPE_NAME[dtype]}) never launched fused_rdb")
        emit(rdb_shapes={"path": "serve", "dtype": DTYPE_NAME[dtype],
                         "shapes": [list(s) for s in sorted(main_shapes[dtype])]})
        emit(tail_shapes={"path": "serve", "dtype": DTYPE_NAME[dtype],
                          "shapes": [[list(s), shuffle] for s, shuffle in
                                     sorted(tail_shapes[dtype])]})
        trunk_inputs[dtype] = capture_trunk_inputs(pipe, tree)
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

    f32_err = float(np.abs(outputs[torch.float32]["crop67x93"] - golden).max())
    bf16_psnr = psnr(outputs[torch.bfloat16]["crop67x93"], golden)
    tree_psnr = psnr(outputs[torch.bfloat16]["tree"], outputs[torch.float32]["tree"])
    emit(golden={"f32_max_abs_err": f32_err, "f32_bound": 1e-4, "bf16_psnr_db": bf16_psnr,
                 "bf16_psnr_floor_db": 40.0, "tree_bf16_vs_f32_psnr_db": tree_psnr})
    check(f32_err <= 1e-4, f"f32 crop differs from the JAX golden output by {f32_err}")
    check(bf16_psnr >= 40.0, f"bf16 crop PSNR {bf16_psnr:.2f} dB against the JAX golden output")
    wide_tiled = {dtype: out["wide_tiled"] for dtype, out in outputs.items()}
    del outputs

    tool_launches = drive_conv_exp()
    for dtype, n in drive_eval(tree, main_shapes).items():
        launches[dtype]["eval"] = n
    check_kernels(state_dict, main_shapes)
    check_tail_kernel(tail_shapes)
    for dtype in (torch.bfloat16, torch.float32):
        check_trunk_activations(state_dict, trunk_inputs.pop(dtype), dtype)
    swinir_launches = drive_swinir(tree, wide)
    for dtype, paths in drive_orbax(tree).items():
        launches[dtype].update(paths)
    tree_sr = read_png(TREE_SR)
    launches[torch.bfloat16].update(drive_validation(state_dict, tree_sr))
    for dtype, n in tiled_devices(wide, wide_tiled).items():
        launches[dtype]["tiled_devices"] = n
    launches[torch.bfloat16].update(
        http=front_end_http(tree, wide), entry=front_end_graft_entry(),
        validate_parity=front_end_parity_scripts(tree_sr), tile_sweep=front_end_tile_sweep())

    emit(fused_rdb_launches={DTYPE_NAME[d]: paths for d, paths in launches.items()})
    emit(bias_lrelu_launches=TAIL_LAUNCHES)
    kernels = [kernel_record(state_dict, d, sum(launches[d].values()))
               for d in (torch.bfloat16, torch.float32)]
    # upconv2 of the batch cell (16 x 256^2 in) in bf16, of the tree image in f32
    kernels += [tail_record(d, shape, sum(TAIL_LAUNCHES[DTYPE_NAME[d]].values()))
                for d, shape in ((torch.bfloat16, (16, 256, 512, 512)),
                                 (torch.float32, (1, 256, 512, 1024)))]
    kernels += [window_attn_record(d, swinir_launches["window_attn"][d])
                for d in (torch.bfloat16, torch.float32)]
    kernels += [layer_norm_record(d, swinir_launches["layer_norm"][d])
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
