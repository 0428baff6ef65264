"""Perf lab: micro-benchmarks of the RDB hot loop on the GPU: the port of
``tools/perf_lab.py``.

Each timed step is chained as the JAX tool chains it in a jitted
``fori_loop``: iteration i+1 takes iteration i's output (the RDB is
shape-preserving; a convolution or product feeds a slice of its output
back), so no step can be skipped.  The chain is timed between CUDA events
with ``tools/conv_exp.py``'s helpers: inside a CUDA graph of ``--iters``
steps (``time_in_graph``) where the ops allow one, and in a host loop
(``time_launches``) for ``gen`` (so that every K1 launch is counted) and
``deg`` (its draws read values to the host).  Every experiment returns its
readings and prints them, as text and as one JSON line.

Experiments (``python -m real_esrgan_tpu_torch.tools.perf_lab <name> [--batch 8 --size 256]``):
  peak        big bf16 matmul -> measured tensor-core ceiling (TF/s)
  rdb         packed RDB (one conv a source; the trainers' rdb_plain)  [ms/RDB, TF/s]
  rdb_naive   unpacked 5-conv concat RDB                                [ms/RDB, TF/s]
  rdb_im2col  9-shift im2col + one K=9*Cin matmul a source             [ms/RDB, TF/s]
  rdb_dxpack  packed RDB, each conv a 3x1 conv on dx-packed channels   [ms/RDB, TF/s]
  convscan    3x3 convs at the RDB's channel shapes                    [TF/s]
  convscan31  3x1 convs on dx-packed inputs (pack included)            [TF/s]
  matscan     the im2col'd RDB convs as plain matrix products          [TF/s]
  gen         the port's bf16 x4 Generator (K1 on the card)            [MP/s]
  deg         the degradation stage by stage at hr 400                 [ms]
  all         everything above

The four RDB formulations are plain PyTorch, the math counterparts of the
XLA formulations the JAX tool times; ``gen`` runs the port's generator,
whose RDBs are the hand-written kernel K1 on a GPU.  Runs on CUDA;
``--cpu`` runs on the CPU (a check of the tool, not a measurement).
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from real_esrgan_tpu_torch import resolve_device
from real_esrgan_tpu_torch.tools.conv_exp import time_in_graph, time_launches

C, G = 64, 32
# FLOPs per pixel per RDB: 2 * 9 * (64*32 + 96*32 + 128*32 + 160*32 + 192*64)
RDB_FLOPS_PER_PX = 2 * 9 * (C * G + (C + G) * G + (C + 2 * G) * G
                            + (C + 3 * G) * G + (C + 4 * G) * C)
PEAK_SIZES = (4096, 8192)


def chain_time(step: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, iters: int,
               device: torch.device, graph: bool = True) -> float:
    """Seconds per iteration of ``step`` chained on the device: each call takes
    the previous call's output, in a CUDA graph of ``iters`` steps (``graph``)
    or a host loop between CUDA events."""
    carry = [x]

    def one():
        carry[0] = step(carry[0])

    with torch.no_grad():
        return (time_in_graph if graph else time_launches)(one, iters, device)


def chain_op_time(op: Callable[[torch.Tensor], torch.Tensor], x0: torch.Tensor, iters: int,
                  device: torch.device, graph: bool = False) -> float:
    """Seconds per call of an op whose output changes shape, serialised by a
    scalar carry in ``x0``'s dtype (the mean of the last output scales the
    next input), in a host loop between CUDA events, or in a CUDA graph of
    ``iters`` calls (``graph``)."""
    carry = [torch.zeros((), dtype=x0.dtype, device=x0.device)]
    eps = torch.full((), 1e-6, dtype=x0.dtype, device=x0.device)

    def one():
        out = op(x0 * (1.0 + carry[0] * eps))
        carry[0] = out.float().mean().to(x0.dtype)

    with torch.no_grad():
        return (time_in_graph if graph else time_launches)(one, iters, device)


def rand_weights(device, seed: int = 0):
    """The five RDB convs' kernels (HWIO, float32, N(0, 1) * 0.05) and zero
    biases."""
    gen = torch.Generator().manual_seed(seed)
    shapes = [(3, 3, C, G), (3, 3, C + G, G), (3, 3, C + 2 * G, G), (3, 3, C + 3 * G, G),
              (3, 3, C + 4 * G, C)]
    kernels = [(torch.randn(s, generator=gen) * 0.05).to(device) for s in shapes]
    biases = [torch.zeros(s[-1], device=device) for s in shapes]
    return kernels, biases


def _conv(x: torch.Tensor, k: torch.Tensor, padding=(1, 1)) -> torch.Tensor:
    """NHWC ``x`` with HWIO ``k`` in x's dtype: 'same' 3x3 (or 3x1 with
    ``padding=(1, 0)``); channels_last on the way in and out, so no copy."""
    y = F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1).to(x.dtype), padding=padding)
    return y.permute(0, 2, 3, 1)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, x * torch.full((), 0.2, dtype=x.dtype, device=x.device))


def _scaled_residual(o5: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return o5 * torch.full((), 0.2, dtype=x.dtype, device=x.device) + x


def rdb_naive(kernels, biases, x):
    k1, k2, k3, k4, k5 = kernels
    b1, b2, b3, b4, b5 = [b.to(x.dtype) for b in biases]
    o1 = _lrelu(_conv(x, k1) + b1)
    o2 = _lrelu(_conv(torch.cat([x, o1], -1), k2) + b2)
    o3 = _lrelu(_conv(torch.cat([x, o1, o2], -1), k3) + b3)
    o4 = _lrelu(_conv(torch.cat([x, o1, o2, o3], -1), k4) + b4)
    o5 = _conv(torch.cat([x, o1, o2, o3, o4], -1), k5) + b5
    return _scaled_residual(o5, x)


def pack_source_major(kernels):
    """As the generator's packed path: one conv per SOURCE (x, o1 .. o4),
    its output channels every consumer's share of that source."""
    k1, k2, k3, k4, k5 = kernels
    w_x = torch.cat([k1, k2[:, :, :C], k3[:, :, :C], k4[:, :, :C], k5[:, :, :C]], -1)
    w_o1 = torch.cat([k2[:, :, C:], k3[:, :, C:C + G], k4[:, :, C:C + G], k5[:, :, C:C + G]], -1)
    w_o2 = torch.cat([k3[:, :, C + G:], k4[:, :, C + G:C + 2 * G], k5[:, :, C + G:C + 2 * G]], -1)
    w_o3 = torch.cat([k4[:, :, C + 2 * G:], k5[:, :, C + 2 * G:C + 3 * G]], -1)
    w_o4 = k5[:, :, C + 3 * G:]
    return w_x, w_o1, w_o2, w_o3, w_o4


def _packed_rdb(source_conv, kernels, biases, x):
    """The source-packed RDB with ``source_conv(t, w)`` as each source's conv."""
    w_x, w_o1, w_o2, w_o3, w_o4 = pack_source_major(kernels)
    b1, b2, b3, b4, b5 = [b.to(x.dtype) for b in biases]
    base = source_conv(x, w_x)
    o1 = _lrelu(base[..., :G] + b1)
    t2 = source_conv(o1, w_o1)
    o2 = _lrelu(base[..., G:2 * G] + t2[..., :G] + b2)
    t3 = source_conv(o2, w_o2)
    o3 = _lrelu(base[..., 2 * G:3 * G] + t2[..., G:2 * G] + t3[..., :G] + b3)
    t4 = source_conv(o3, w_o3)
    o4 = _lrelu(base[..., 3 * G:4 * G] + t2[..., 2 * G:3 * G] + t3[..., G:2 * G]
                + t4[..., :G] + b4)
    t5 = source_conv(o4, w_o4)
    o5 = base[..., 4 * G:] + t2[..., 3 * G:] + t3[..., 2 * G:] + t4[..., G:] + t5 + b5
    return _scaled_residual(o5, x)


def rdb_packed(kernels, biases, x):
    return _packed_rdb(_conv, kernels, biases, x)


def im2col(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, Cin) -> (B, H, W, 9*Cin) zero-padded 3x3 patches, tap-major."""
    _, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.cat([xp[:, dy:dy + h, dx:dx + w, :] for dy in range(3) for dx in range(3)], -1)


def _im2col_conv(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One matrix product with K = 9*Cin; w (3, 3, Cin, Cout) -> (9*Cin, Cout)."""
    return im2col(t) @ w.reshape(-1, w.shape[-1]).to(t.dtype)


def rdb_im2col(kernels, biases, x):
    """Each conv = one matrix product with K = 9*Cin."""
    return _packed_rdb(_im2col_conv, kernels, biases, x)


def shift3(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, 3C): channel-concat of the taps w-1, w, w+1 (zero pad)."""
    w = x.shape[2]
    xp = F.pad(x, (0, 0, 1, 1))
    return torch.cat([xp[:, :, 0:w], xp[:, :, 1:w + 1], xp[:, :, 2:w + 2]], -1)


def conv31(x3: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """3x1 conv over dx-packed input == exact 3x3 conv, Cin tripled.
    k: (3, 3, Cin, Cout), the original kernel."""
    return _conv(x3, k.reshape(3, 1, -1, k.shape[-1]), padding=(1, 0))


def rdb_dxpack(kernels, biases, x):
    """Source-packed RDB where every conv is a 3x1 conv on dx-packed channels."""
    return _packed_rdb(lambda t, w: conv31(shift3(t), w), kernels, biases, x)


RDB_FORMS = {"rdb": rdb_packed, "rdb_naive": rdb_naive, "rdb_im2col": rdb_im2col,
             "rdb_dxpack": rdb_dxpack}


def report(text: str, **record) -> dict:
    """Prints a reading as ``text`` and as one JSON line; returns ``record``."""
    print(text, flush=True)
    print(json.dumps(record), flush=True)
    return record


def run_peak(args, device) -> List[dict]:
    out = []
    for n in PEAK_SIZES:
        gen = torch.Generator().manual_seed(0)
        a = torch.randn((n, n), generator=gen).to(device, torch.bfloat16)
        scale = torch.full((), 1.0 / math.sqrt(n), dtype=torch.bfloat16, device=device)

        def step(v):
            # a ~ N(0, 1) makes v @ a grow ~sqrt(n); the rescale keeps the chain bounded
            return (v @ a) * scale

        dt = chain_time(step, a, args.iters, device)
        tf = 2 * n ** 3 / dt / 1e12
        out.append(report(f"peak: {n}^3 bf16 matmul  {dt * 1e3:.3f} ms  -> {tf:.1f} TF/s",
                          exp="peak", n=n, ms=dt * 1e3, tflops=tf))
    return out


def run_rdb(name: str, args, device) -> dict:
    kernels, biases = rand_weights(device)
    fn = RDB_FORMS[name]
    x = torch.rand((args.batch, args.size, args.size, C),
                   generator=torch.Generator().manual_seed(1)).to(device, torch.bfloat16)
    dt = chain_time(lambda v: fn(kernels, biases, v), x, args.iters, device)
    tf = RDB_FLOPS_PER_PX * args.batch * args.size ** 2 / dt / 1e12
    label = "rdb_packed" if name == "rdb" else name
    return report(f"{label}: batch={args.batch} size={args.size}  {dt * 1e3:.3f} ms/RDB  "
                  f"-> {tf:.1f} TF/s", exp=name, ms=dt * 1e3, tflops=tf)


def run_gen(args, device) -> dict:
    from real_esrgan_tpu_torch.models import Generator
    from real_esrgan_tpu_torch.ops.fused_rdb import fused_rdb

    model = Generator(upscale_factor=4, num_rrdb=args.rrdb, dtype=torch.bfloat16,
                      subpixel=not args.no_subpixel, device=device,
                      generator=torch.Generator().manual_seed(0)).eval()

    def step(x):
        out = model(x)
        return out[:, :args.size, :args.size, :] * 0.999 + 0.0005

    gen = torch.Generator().manual_seed(0)
    x = torch.rand((args.batch, args.size, args.size, 3), generator=gen).to(device)
    before = fused_rdb.launches
    dt = chain_time(step, x, args.iters, device, graph=False)
    launched = fused_rdb.launches - before
    if device.type == "cuda" and launched != 3 * args.rrdb * (args.iters + 1):
        raise RuntimeError(f"gen: the generator launched the RDB kernel {launched} times, not "
                           f"{3 * args.rrdb * (args.iters + 1)}")
    mp = args.batch * (args.size * 4) ** 2 / 1e6
    return report(f"gen: batch={args.batch} size={args.size}  {dt * 1e3:.1f} ms  "
                  f"-> {mp / dt:.2f} MP/s", exp="gen", ms=dt * 1e3, mp_per_s=mp / dt,
                  subpixel=not args.no_subpixel, fused_rdb_launches=launched)


def _bf16_operand(shape, seed: int, scale: float, device, normal: bool = True):
    gen = torch.Generator().manual_seed(seed)
    t = torch.randn(shape, generator=gen) if normal else torch.rand(shape, generator=gen)
    return (t * scale).to(device, torch.bfloat16)


def run_convscan31(args, device) -> List[dict]:
    """3x1 convs on dx-packed inputs at the RDB's shapes (the pack included)."""
    out = []
    for cin, cout in ((192, 192), (96, 160), (96, 128), (96, 96), (96, 64)):
        k = _bf16_operand((3, 3, cin // 3, cout), 0, 0.05, device)
        x = _bf16_operand((args.batch, args.size, args.size, cin // 3), 1, 1.0, device, False)
        third = torch.full((), 0.3, dtype=torch.bfloat16, device=device)

        def step(v, k=k, cin=cin, third=third):
            return conv31(shift3(v), k)[..., :cin // 3] * third

        dt = chain_time(step, x, args.iters, device)
        flops = 2 * 3 * cin * cout * args.batch * args.size ** 2
        out.append(report(f"conv3x1 {cin:4d}->{cout:4d} (+pack): {dt * 1e3:7.3f} ms"
                          f"  {flops / dt / 1e12:6.1f} TF/s", exp="convscan31",
                          cin=cin, cout=cout, ms=dt * 1e3, tflops=flops / dt / 1e12))
    return out


def run_convscan(args, device) -> List[dict]:
    """Efficiency curve of the library's 3x3 convs at the RDB's channel shapes."""
    out = []
    for cin, cout in ((64, 64), (64, 192), (96, 192), (128, 128), (64, 256), (128, 256),
                      (256, 256)):
        k = _bf16_operand((3, 3, cin, cout), 0, 0.05, device)
        x = _bf16_operand((args.batch, args.size, args.size, cin), 1, 1.0, device, False)
        third = torch.full((), 0.3, dtype=torch.bfloat16, device=device)

        def step(v, k=k, cin=cin, third=third):
            return _conv(v, k)[..., :cin] * third  # chain feed

        dt = chain_time(step, x, args.iters, device)
        flops = 2 * 9 * cin * cout * args.batch * args.size ** 2
        out.append(report(f"conv3x3 {cin:4d}->{cout:4d}: {dt * 1e3:7.3f} ms  "
                          f"{flops / dt / 1e12:6.1f} TF/s", exp="convscan",
                          cin=cin, cout=cout, ms=dt * 1e3, tflops=flops / dt / 1e12))
    return out


def run_matscan(args, device) -> List[dict]:
    """The FLOP shapes of the im2col'd RDB convs, as plain matrix products."""
    out = []
    m = args.batch * args.size ** 2
    for k_dim, n_dim in ((576, 192), (288, 160), (288, 128), (288, 96), (288, 64), (576, 64),
                         (128, 128), (1152, 384)):
        a = _bf16_operand((m, k_dim), 0, 1.0, device)
        b = _bf16_operand((k_dim, n_dim), 1, 0.05, device)
        third = torch.full((), 0.3, dtype=torch.bfloat16, device=device)

        def step(v, b=b, k_dim=k_dim, n_dim=n_dim, third=third):
            reps = -(-k_dim // n_dim)
            return (v @ b).repeat(1, reps)[:, :k_dim] * third

        dt = chain_time(step, a, args.iters, device)
        flops = 2 * m * k_dim * n_dim
        out.append(report(f"matmul ({m}x{k_dim})@({k_dim}x{n_dim}): {dt * 1e3:7.3f} ms"
                          f"  {flops / dt / 1e12:6.1f} TF/s", exp="matscan",
                          m=m, k=k_dim, n=n_dim, ms=dt * 1e3, tflops=flops / dt / 1e12))
    return out


def deg_cases(batch: int, device) -> Dict[str, tuple]:
    """The degradation's stages as (op, input) at hr 400, batch ``batch``:
    each op draws what its stage draws (kernels, normals, seeds) on the
    device from a fixed seed, as the JAX tool's ops draw from a fixed key."""
    from real_esrgan_tpu_torch.configuration import (
        DegradationConfig, KernelSynthesisConfig, PipelineGeometry,
    )
    from real_esrgan_tpu_torch.ops.blur_kernels import random_first_order_kernel
    from real_esrgan_tpu_torch.ops.degradation import _batched_resize, degrade
    from real_esrgan_tpu_torch.ops.diffjpeg import diff_jpeg
    from real_esrgan_tpu_torch.ops.filter2d import filter2d
    from real_esrgan_tpu_torch.ops.noise import (
        draw_normals, draw_poisson_seeds, gaussian_noise, poisson_noise,
    )
    from real_esrgan_tpu_torch.ops.usm import gaussian_kernel_1d, usm_sharpen

    b = batch
    geo = PipelineGeometry(hr_size=400, crop_size=256, scale=4)  # the trainers' geometry
    kcfg, dcfg = KernelSynthesisConfig(), DegradationConfig()
    c1, c2 = geo.canvas1, geo.canvas2
    print(f"geometry: hr={geo.hr_size} canvas1={c1} canvas2={c2} batch={b}")

    def gen():
        return torch.Generator(device=device).manual_seed(0)

    def uniform(*shape):
        return torch.rand(shape, generator=gen(), device=device)

    hr, big, small = uniform(b, geo.hr_size, geo.hr_size, 3), uniform(b, c1, c1, 3), \
        uniform(b, c2, c2, 3)
    kernels = random_first_order_kernel(gen(), kcfg, b, device)
    usm_k = gaussian_kernel_1d(dcfg.usm_radius, 0.0)
    sig = torch.full((b,), 15.0, device=device)
    gray = torch.zeros((b,), device=device)
    q = torch.full((b,), 60.0, device=device)
    up_extent = int(geo.hr_size * 1.4)

    def poisson(v, approx):
        g = gen()
        normals = draw_normals(g, v) if approx else (None, None)
        seeds = None if approx else draw_poisson_seeds(g, b, device)
        return poisson_noise(v, sig * 0.1, gray, approx, *normals, seeds=seeds)

    return {
        "full degrade": (lambda v: degrade(gen(), v, geo, kcfg, dcfg,
                                           host_generator=torch.Generator().manual_seed(0))[0], hr),
        "usm r51": (lambda v: usm_sharpen(v, usm_k, 0.5, 10.0), hr),
        "kernel synth x b": (lambda v: filter2d(v[:, :21, :21, :1] * 0 + 1,
                                                random_first_order_kernel(gen(), kcfg, b, device)),
                             hr),
        f"filter2d 21x21 @{geo.hr_size}": (lambda v: filter2d(v, kernels), hr),
        f"resize1 area {geo.hr_size}->{up_extent}@{c1}": (
            lambda v: _batched_resize(v, geo.hr_size, up_extent, c1, 0), hr),
        f"resize1 cubic {geo.hr_size}->{up_extent}@{c1}": (
            lambda v: _batched_resize(v, geo.hr_size, up_extent, c1, 2), hr),
        f"resize2 cubic {c1}->{geo.lr_size}@c2": (
            lambda v: _batched_resize(v, c1, geo.lr_size, c2, 2), big),
        f"gauss noise @{c1}": (lambda v: gaussian_noise(v, sig, gray, *draw_normals(gen(), v)),
                               big),
        f"poisson exact @{c1}": (lambda v: poisson(v, False), big),
        f"poisson approx @{c1}": (lambda v: poisson(v, True), big),
        f"diffjpeg @{c1}": (lambda v: diff_jpeg(torch.clamp(v, 0, 1), q), big),
        "diffjpeg @c2": (lambda v: diff_jpeg(torch.clamp(v, 0, 1), q), small),
        f"filter2d 21x21 @{c1}": (lambda v: filter2d(v, kernels), big),
    }


def run_deg(args, device) -> List[dict]:
    """Per-stage cost of the degradation on the device (batch, hr 400); a
    case that fails is printed as FAILED and the scan goes on."""
    out = []
    for name, (op, x0) in deg_cases(args.batch, device).items():
        try:
            dt = chain_op_time(op, x0, args.iters, device)
            out.append(report(f"{name:30s}: {dt * 1e3:8.3f} ms", exp="deg", case=name,
                              ms=dt * 1e3))
        except Exception as exc:  # keep the scan going
            out.append(report(f"{name:30s}: FAILED {type(exc).__name__}: {exc}", exp="deg",
                              case=name, failed=f"{type(exc).__name__}: {exc}"))
    return out


EXPERIMENTS = {
    "deg": run_deg,
    "convscan": run_convscan,
    "matscan": run_matscan,
    "peak": run_peak,
    "rdb": lambda a, d: run_rdb("rdb", a, d),
    "rdb_naive": lambda a, d: run_rdb("rdb_naive", a, d),
    "rdb_im2col": lambda a, d: run_rdb("rdb_im2col", a, d),
    "rdb_dxpack": lambda a, d: run_rdb("rdb_dxpack", a, d),
    "convscan31": run_convscan31,
    "gen": run_gen,
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("exp", choices=list(EXPERIMENTS) + ["all"])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--rrdb", type=int, default=23)
    p.add_argument("--no-subpixel", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (a check of the tool, not a measurement)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Runs the experiment (or all) and returns each one's readings by name."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.cpu)
    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")
    names = list(EXPERIMENTS) if args.exp == "all" else [args.exp]
    return {name: EXPERIMENTS[name](args, device) for name in names}


if __name__ == "__main__":
    main()
