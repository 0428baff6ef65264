#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``real_esrgan_tpu_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, no arguments

1. prints the card's name and power limit, as nvidia-smi gives them;
2. builds the CUDA kernel of the port from ``real_esrgan_tpu_torch/csrc``
   with nvcc, printing build seconds, registers, spills and shared memory;
3. drives the x4 serving path: ``SRPipeline`` with
   ``assets/inenv10_esrnet_ema.npz`` answers requests in bfloat16 and in
   float32 (the whole test image, a bucketed crop, a tiled wide image, and
   the ragged crop the committed JAX golden output covers), with every
   kernel's launch count set to 0 just before and read just after, and the
   shape of every input the RDB kernel gets recorded;
4. checks the outputs: finite, in [0, 1], the f32 crop within 1e-4 of the
   JAX golden output, the bf16 crop's PSNR against it, and the tiled image's
   interior seam error against a whole-image forward; profiles one warm
   forward of the test image (device busy time, idle share, time by kernel);
5. holds the kernel against its plain PyTorch version on the card, with the
   trained weights of several RDBs, at every shape the main path gave it;
6. times each kernel against its plain version and its bound, and prints one
   JSON line ``{"kernels": [...]}``; the last line is
   ``{"ok": true, "device": {...}}``.

Every check raises on failure, so the script exits non-zero and prints no
result; without CUDA it exits non-zero at once.  f32 phases run with TF32
off.  Needs one GPU and no network.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from real_esrgan_tpu_torch.models.rrdbnet import ResidualDenseBlock
from real_esrgan_tpu_torch.ops import _build
from real_esrgan_tpu_torch.ops.fused_rdb import fused_rdb, pack_rdb_weights, rdb_plain
from real_esrgan_tpu_torch.serve import SRPipeline
from real_esrgan_tpu_torch.train.checkpoint import load_generator_params
from real_esrgan_tpu_torch.utils.imgio import read_png

ROOT = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(ROOT, "assets", "inenv10_esrnet_ema.npz")
TREE = os.path.join(ROOT, "tests", "data", "tree_lr.png")
GOLDEN = os.path.join(ROOT, "tests", "data", "jax_sr_tree_crop67x93_f32.npy")
CROP = (slice(64, 131), slice(128, 221))  # the golden file's input crop

RDBS_PER_FORWARD = 69  # 23 RRDBs x 3 RDBs
# 2 * 9 * (64*32 + 96*32 + 128*32 + 160*32 + 192*64) FLOP per pixel
RDB_FLOP_PER_PIXEL = 479_232
RDB_WEIGHTS = RDB_FLOP_PER_PIXEL // 2
# H100 SXM, NVIDIA data sheet: dense bf16 tensor-core rate, f32 CUDA-core
# rate, HBM3 rate.  The kernel runs on CUDA cores, so its bf16 bound is
# against a peak it cannot reach yet.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
CHECK_RDBS = ("trunk.0.rdb1", "trunk.11.rdb2", "trunk.22.rdb3")
TOLERANCE = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-2, 2e-2)}  # atol, rtol
DTYPE_NAME = {torch.float32: "f32", torch.bfloat16: "bf16"}
# output tile side T of one block, as Traits<T>::kTile sets it in csrc/fused_rdb.cu
RDB_TILE = {torch.float32: 8, torch.bfloat16: 16}
# interior seam error of the bf16 tiled output against a whole-image forward,
# 8-bit levels: bf16 rounding gives a max near 5 and a mean near 0.12; a tile
# computed wrong gives far more
SEAM_LIMIT = {"max": 16.0, "mean": 0.5}


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


def rdb_smem_bytes(dtype: torch.dtype) -> int:
    """Shared memory of one fused_rdb block: the x tile with its 5-pixel halo
    (64 channels) and o1..o4 at (T+8)^2..(T+2)^2 (32 channels each)."""
    t = RDB_TILE[dtype]
    elems = sum((t + 2 * (5 - k)) ** 2 * (64 if k == 0 else 32) for k in range(5))
    return elems * torch.tensor([], dtype=dtype).element_size()


def build_kernels() -> None:
    """Builds the kernel source anew, so the build time and the ptxas lines
    printed are this run's."""
    name = "fused_rdb"
    _build.library_path(name).unlink(missing_ok=True)
    _build.build(name)
    log = _build.BUILD_LOG[name]
    emit(build={name: {"nvcc_seconds": round(log["seconds"], 3),
                       "ptxas": [line.strip() for line in log["log"].splitlines()
                                 if re.search(r"registers|spill|entry function", line)]}})
    emit(fused_rdb_blocks={DTYPE_NAME[d]: {"tile": RDB_TILE[d], "smem_bytes": rdb_smem_bytes(d)}
                           for d in TOLERANCE})


def record_rdb_shapes(pipe: SRPipeline, shapes: set) -> list:
    """Adds the NHWC shape of every input an RDB of ``pipe`` gets to
    ``shapes``; returns the hooks, to remove when done."""
    def hook(_module, args):
        b, c, h, w = args[0].shape
        shapes.add((b, h, w, c))
    return [m.register_forward_pre_hook(hook) for m in pipe.model.modules()
            if isinstance(m, ResidualDenseBlock)]


def check_kernels(state_dict, main_shapes: dict) -> None:
    """K1 against rdb_plain on the card, trained weights, N(0, 0.5^2) inputs,
    at every shape the main path gave it in each dtype and a ragged batch."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype, (atol, rtol) in TOLERANCE.items():
        for name in CHECK_RDBS:
            packed = rdb_pack(state_dict, name, dtype)
            for shape in sorted(main_shapes[dtype] | {(2, 67, 93, 64)}):
                x = (torch.randn(shape, generator=gen, device="cuda") * 0.5).to(dtype)
                out = fused_rdb(x, packed).float()
                ref = rdb_plain(x, packed).float()
                torch.cuda.synchronize()
                diff = (out - ref).abs()
                ok = bool(torch.isfinite(out).all()) and bool((diff <= atol + rtol * ref.abs()).all())
                emit(k1_check={"dtype": DTYPE_NAME[dtype], "rdb": name, "shape": list(shape),
                               "max_abs_diff": diff.max().item(), "atol": atol, "rtol": rtol,
                               "ok": ok})
                check(ok, f"fused_rdb {DTYPE_NAME[dtype]} {name} {shape} disagrees with rdb_plain")


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


def profile_forward(pipe: SRPipeline, image: np.ndarray) -> dict:
    """Where one warm forward's time goes on the card: torch.profiler's
    device activities, their union (busy time) against the host wall clock
    around the call, and device time by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.from_numpy(image)[None].cuda()
    pipe.apply(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.apply(x)
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    rdb_ms = sum(ms for name, (ms, _) in by_name.items() if "rdb_kernel" in name)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e3 / wall_ms, "fused_rdb_ms": rdb_ms,
            "fused_rdb_share_of_busy": rdb_ms / (busy_us / 1e3),
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


def kernel_record(state_dict, dtype: torch.dtype, launches: int) -> dict:
    """fused_rdb at the tree image's trunk shape (1, 256, 512, 64): its time,
    its plain version's, both in turns (plain, kernel, kernel, plain), and its
    bound, the larger of FLOPs over the peak rate and bytes over HBM's rate."""
    shape = (1, 256, 512, 64)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = (torch.randn(shape, generator=gen, device="cuda") * 0.5).to(dtype)
    packed = rdb_pack(state_dict, "trunk.11.rdb2", dtype)
    out, ref = fused_rdb(x, packed).float(), rdb_plain(x, packed).float()
    atol, rtol = TOLERANCE[dtype]
    check(bool(((out - ref).abs() <= atol + rtol * ref.abs()).all()),
          f"fused_rdb {DTYPE_NAME[dtype]} disagrees with rdb_plain at {shape}")
    err = (out - ref).abs().max().item()
    plain_a = time_ms(lambda: rdb_plain(x, packed), 10)
    kernel_a = time_ms(lambda: fused_rdb(x, packed), 10)
    kernel_b = time_ms(lambda: fused_rdb(x, packed), 10)
    plain_b = time_ms(lambda: rdb_plain(x, packed), 10)
    pixels = shape[0] * shape[1] * shape[2]
    flops = RDB_FLOP_PER_PIXEL * pixels
    moved = (2 * pixels * 64 + RDB_WEIGHTS) * x.element_size() + 5 * 64 * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, moved / PEAK_BYTES * 1e3
    ms = (kernel_a + kernel_b) / 2
    return {"name": f"fused_rdb[{DTYPE_NAME[dtype]}]", "route": "cuda",
            "source": "real_esrgan_tpu_torch/csrc/fused_rdb.cu",
            "replaces": "real_esrgan_tpu/ops/pallas_rdb.py:188",
            "launches": launches, "max_abs_err": err, "ms": ms, "kernel_ms": ms,
            "plain_ms": (plain_a + plain_b) / 2, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "shape": list(shape), "tflops": flops / ms / 1e9}


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
    launches, outputs, main_shapes = {}, {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        pipe = SRPipeline(WEIGHTS, bfloat16=dtype == torch.bfloat16, device="cuda")
        main_shapes[dtype] = set()
        hooks = record_rdb_shapes(pipe, main_shapes[dtype])
        fused_rdb.launches = 0
        outputs[dtype] = serve(pipe, dtype, tree, wide)
        launches[dtype] = fused_rdb.launches
        for h in hooks:
            h.remove()
        check(launches[dtype] > 0, f"main path ({DTYPE_NAME[dtype]}) never launched fused_rdb")
        emit(rdb_shapes={"dtype": DTYPE_NAME[dtype],
                         "shapes": [list(s) for s in sorted(main_shapes[dtype])]})
        emit(profile={"dtype": DTYPE_NAME[dtype], "request": "tree forward",
                      **profile_forward(pipe, tree)})
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

    check_kernels(state_dict, main_shapes)

    f32_err = float(np.abs(outputs[torch.float32]["crop67x93"] - golden).max())
    bf16_psnr = psnr(outputs[torch.bfloat16]["crop67x93"], golden)
    tree_psnr = psnr(outputs[torch.bfloat16]["tree"], outputs[torch.float32]["tree"])
    emit(golden={"f32_max_abs_err": f32_err, "f32_bound": 1e-4, "bf16_psnr_db": bf16_psnr,
                 "bf16_psnr_floor_db": 40.0, "tree_bf16_vs_f32_psnr_db": tree_psnr})
    check(f32_err <= 1e-4, f"f32 crop differs from the JAX golden output by {f32_err}")
    check(bf16_psnr >= 40.0, f"bf16 crop PSNR {bf16_psnr:.2f} dB against the JAX golden output")

    kernels = [kernel_record(state_dict, d, launches[d]) for d in (torch.bfloat16, torch.float32)]
    emit(seconds=round(time.perf_counter() - t_start, 1))
    emit(kernels=kernels)
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
