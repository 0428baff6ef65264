"""Generator-tail experiments: ``conv4`` variants, an NCHW tail, and int8 at
the packed-RDB shapes: the port of ``tools/tail_exp.py``.

    python -m real_esrgan_tpu_torch.tools.tail_exp --mode conv4
    python -m real_esrgan_tpu_torch.tools.tail_exp --mode nchw
    python -m real_esrgan_tpu_torch.tools.tail_exp --mode int8
    python -m real_esrgan_tpu_torch.tools.tail_exp --mode epilogue

Shapes are the JAX tool's: batch ``B`` = 8; the tail at the x4 resolution of
a 256 LR image (1024^2 x 64, and the (2, 2)-window pre-shuffle form at
512^2 x 256); the packed RDB's five convs at 256^2.  ``conv4`` is a 3x3 conv
with 3 output channels: a GEMM with N = 3 uses a sliver of a tensor-core
tile, and the candidates are exact reformulations that trade that padding
against more input channels or a repack.

``epilogue`` times the port's own tail kernel, ``ops/tail_epilogue.py``'s
``bias_lrelu`` (bias, LeakyReLU and the x2 pixel shuffle in one pass), beside
its plain PyTorch version at the batch cell's shapes: ``EPILOGUE_B`` = 16
LR images of ``EPILOGUE_SIZE`` = 256^2, so upconv1's (16, 256, 256^2),
upconv2's (16, 256, 512^2) and conv3's (16, 64, 1024^2), each in bfloat16
and float32, with the kernel's least time by bytes (y read once, the
output written once, at ``HBM_BYTES_PER_S``) and whether the two agree bit
for bit.  These time a host loop between CUDA events: each call is a
millisecond or more.

Timing follows ``tools/perf_lab.py``: each op is chained by a scalar carry
(the mean of one output scales the next input; for int8 the sum modulo 113
is added), inside a CUDA graph of ``--iters`` calls between CUDA events.
These convolutions are stock library calls (cuDNN; cuBLAS for the int8
products), as XLA lowered the JAX tool's.  PyTorch has no int8 3x3
convolution, so ``conv_i8`` is an im2col followed by ``torch._int_mm``
(int8 x int8 -> int32); K = 9 * Cin and N = Cout are multiples of 8 at every
shape here, as the product requires.  Runs on CUDA; ``--cpu`` runs on the
CPU (a check of the tool, not a measurement).
"""

from __future__ import annotations

import argparse
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F

from real_esrgan_tpu_torch import resolve_device
from real_esrgan_tpu_torch.ops.tail_epilogue import bias_lrelu, bias_lrelu_plain
from real_esrgan_tpu_torch.tools.conv_exp import time_in_graph, time_launches
from real_esrgan_tpu_torch.tools.perf_lab import (
    C, G, RDB_FLOPS_PER_PX, _conv, chain_op_time, im2col, pack_source_major, rand_weights,
    rdb_packed, report,
)

B = 8
TAIL_SIZE = 1024  # the x4 resolution of the bench's 256 LR image
RDB_SIZE = 256
INT8_SHAPES = ((64, 192), (32, 160), (32, 128), (32, 96), (32, 64))
EPILOGUE_B = 16      # the batch cell's LR batch
EPILOGUE_SIZE = 256  # and its LR side
HBM_BYTES_PER_S = 3.35e12  # an H100 SXM's device memory


def _rand(shape, device, seed: int = 0, scale: float = 1.0, dtype=torch.bfloat16):
    """U(0, 1) * scale from a seeded generator on ``device``, in ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return (torch.rand(shape, generator=gen, device=device) * scale).to(dtype)


def _rand_i8(shape, device, seed: int) -> torch.Tensor:
    """int8 values U(0, 1) * 100 - 50, truncated, as the JAX tool casts them."""
    return (_rand(shape, device, seed, dtype=torch.float32) * 100 - 50).to(torch.int8)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def depth_to_space(y: torch.Tensor) -> torch.Tensor:
    """NHWC "n h w (a b o) -> n (h a) (w b) o" with a = b = 2."""
    n, h, w, c = y.shape
    return y.reshape(n, h, w, 2, 2, c // 4).permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * w,
                                                                                c // 4)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """NHWC "n (h a) (w b) c -> n h w (a b c)" with a = b = 2."""
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(
        n, h // 2, w // 2, 4 * c)


def conv_window22(y: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The JAX tool's (2, 2)-window conv of NHWC ``y`` with HWIO ``k``:
    stride 2, one row and one column of zeros before, none after."""
    y = F.pad(y, (0, 0, 1, 0, 1, 0))
    return F.conv2d(y.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1).to(y.dtype),
                    stride=2).permute(0, 2, 3, 1)


def run_conv4(args, device) -> List[dict]:
    s = TAIL_SIZE
    x4 = _rand((B, s, s, 64), device, 0)
    x2 = _rand((B, s // 2, s // 2, 256), device, 1)
    k43 = _rand((3, 3, 64, 3), device, 2, 0.05, torch.float32)
    k22 = _rand((2, 2, 256, 12), device, 3, 0.05, torch.float32)
    k33_64 = _rand((3, 3, 64, 64), device, 4, 0.05, torch.float32)
    useful = 2 * 9 * 64 * 3 * B * s * s

    cases = {
        # the tail's op: 3x3 64->3 at x4 resolution, f32 cast + clamp
        "conv4_base": lambda x: torch.clamp(_conv(x, k43).float(), 0, 1),
        # the same without the f32 cast (isolates cast + clamp)
        "conv4_bf16_out": lambda x: _conv(x, k43),
        # (2, 2)-window pre-shuffle form: 256->12 at x2 resolution + depth-to-space
        "conv4_win22_preshuffle": lambda y: torch.clamp(
            depth_to_space(conv_window22(y, k22).float()), 0, 1),
        # the repack a post-shuffle producer would need first
        "unshuffle_repack": space_to_depth,
        # conv3, for the residual table
        "conv3_base": lambda x: _lrelu(_conv(x, k33_64)),
    }
    out = []
    for name, fn in cases.items():
        inp = x2 if "preshuffle" in name else x4
        dt = chain_op_time(fn, inp, args.iters, device, graph=True)
        out.append(report(f"{name:26s} {dt * 1e3:8.3f} ms   "
                          f"useful {useful / dt / 1e12:6.2f} TF/s", mode="conv4",
                          case=name, ms=dt * 1e3, useful_tflops=useful / dt / 1e12))
    return out


def _conv_nchw(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """'same' 3x3 conv of NCHW-contiguous ``x`` with OIHW ``k``."""
    return F.conv2d(x, k, padding=1)


def run_nchw(args, device) -> List[dict]:
    """The tail with channels outermost (NCHW memory) beside the NHWC
    (channels_last) tail."""
    s = TAIL_SIZE
    xh = _rand((B, s, s, 64), device, 0)                    # NHWC
    xc = _rand((B, 64, s, s), device, 1)                    # NCHW
    k33 = _rand((64, 64, 3, 3), device, 2, 0.05)            # OIHW
    k43 = _rand((3, 64, 3, 3), device, 3, 0.05)

    cases = {
        "conv3_nchw_pure": lambda x: _lrelu(_conv_nchw(x, k33)),
        "conv4_nchw_pure": lambda x: torch.clamp(_conv_nchw(x, k43).float(), 0, 1),
        # the whole tail: NHWC in -> NCHW -> conv3 + lrelu -> conv4 -> clamp -> NHWC out
        "tail_nchw_chain": lambda x: torch.clamp(
            _conv_nchw(_lrelu(_conv_nchw(x.permute(0, 3, 1, 2).contiguous(), k33)), k43)
            .float().permute(0, 2, 3, 1), 0, 1),
        # the NHWC tail for comparison, the same chain
        "tail_nhwc_chain": lambda x: torch.clamp(_conv(
            _lrelu(_conv(x, k33.permute(2, 3, 1, 0))), k43.permute(2, 3, 1, 0)).float(), 0, 1),
    }
    out = []
    for name, fn in cases.items():
        inp = xh if "chain" in name else xc
        dt = chain_op_time(fn, inp, args.iters, device, graph=True)
        out.append(report(f"{name:22s} {dt * 1e3:8.3f} ms", mode="nchw", case=name,
                          ms=dt * 1e3))
    return out


def quant(x: torch.Tensor):
    """Per-tensor symmetric int8 quantization of activations (the serving
    cost: scale + clip + round + cast on every conv input): (q, 1 / scale)."""
    xf = x.float()
    amax = xf.abs().max() + 1e-8
    # tensor / tensor divides correctly rounded; ``127.0 / amax`` would
    # multiply by a reciprocal and can land one float32 step away
    s = torch.full_like(amax, 127.0) / amax
    q = torch.clamp(torch.round(xf * s), -127, 127)
    return q.to(torch.int8), torch.ones_like(s) / s


def conv_i8(xq: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """'same' 3x3 conv of int8 NHWC ``xq`` with int8 HWIO ``kq``, summed in
    int32: im2col (K = 9 * Cin) then ``torch._int_mm``."""
    b, h, w, _ = xq.shape
    cols = im2col(xq).reshape(b * h * w, -1)
    return torch._int_mm(cols, kq.reshape(-1, kq.shape[-1])).reshape(b, h, w, kq.shape[-1])


def conv_i8_reference(xq: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """``conv_i8``'s int32 sums in int64 on the CPU: the exact reference."""
    b, h, w, _ = xq.shape
    cols = im2col(xq.cpu().long()).reshape(b * h * w, -1)
    out = cols @ kq.cpu().long().reshape(-1, kq.shape[-1])
    return out.reshape(b, h, w, kq.shape[-1]).to(torch.int32)


def chain_op_time_i8(op: Callable[[torch.Tensor], torch.Tensor], x0: torch.Tensor, iters: int,
                     device: torch.device) -> float:
    """``chain_op_time`` for int8 inputs: the carry, the int32 sum of the
    last output modulo 113, is added to the next input before the clip."""
    carry = [torch.zeros((), dtype=torch.int32, device=x0.device)]

    def one():
        out = op(torch.clamp(x0.int() + carry[0], -127, 127).to(torch.int8))
        carry[0] = (out.sum() % 113).int()

    with torch.no_grad():
        return time_in_graph(one, iters, device)


def make_rdb_int8(kernels) -> Callable[[torch.Tensor], torch.Tensor]:
    """The packed RDB on int8 products with a requantization of every
    source (``quant``), biases zero as in ``rand_weights``: bf16 in, bf16 out.
    The kernels are int8 (round(k * 1270), clipped), packed one conv a source
    (``pack_source_major``), their scale 1 / 1270."""
    kq = [torch.clamp(torch.round(k * 1270), -127, 127).to(torch.int8) for k in kernels]
    w_x, w_o1, w_o2, w_o3, w_o4 = pack_source_major(kq)
    kscale = torch.tensor(1 / 1270, dtype=torch.float32, device=kernels[0].device)
    g = G

    def rdb_int8(x):
        xq, sx = quant(x)
        base = conv_i8(xq, w_x).float() * (sx * kscale)
        o1 = _lrelu(base[..., :g])
        o1q, s1 = quant(o1)
        t2 = conv_i8(o1q, w_o1).float() * (s1 * kscale)
        o2 = _lrelu(base[..., g:2 * g] + t2[..., :g])
        o2q, s2 = quant(o2)
        t3 = conv_i8(o2q, w_o2).float() * (s2 * kscale)
        o3 = _lrelu(base[..., 2 * g:3 * g] + t2[..., g:2 * g] + t3[..., :g])
        o3q, s3 = quant(o3)
        t4 = conv_i8(o3q, w_o3).float() * (s3 * kscale)
        o4 = _lrelu(base[..., 3 * g:4 * g] + t2[..., 2 * g:3 * g] + t3[..., g:2 * g]
                    + t4[..., :g])
        o4q, s4 = quant(o4)
        t5 = conv_i8(o4q, w_o4).float() * (s4 * kscale)
        o5 = base[..., 4 * g:] + t2[..., 3 * g:] + t3[..., 2 * g:] + t4[..., g:] + t5
        return (o5 * 0.2 + x.float()).to(torch.bfloat16)

    return rdb_int8


def run_int8(args, device) -> List[dict]:
    s = RDB_SIZE
    out = []
    print(f"-- per-conv rates at bs{B}, {s}^2 (the packed-RDB shapes) --")
    for i, (cin, cout) in enumerate(INT8_SHAPES):
        x = _rand((B, s, s, cin), device, 10 * i)
        k = _rand((3, 3, cin, cout), device, 10 * i + 1, 0.05)
        flops = 2 * 9 * cin * cout * B * s * s
        dt = chain_op_time(lambda v, k=k: _conv(v, k), x, args.iters, device, graph=True)
        xq = _rand_i8((B, s, s, cin), device, 10 * i + 2)
        kq = _rand_i8((3, 3, cin, cout), device, 10 * i + 3)
        dt8 = chain_op_time_i8(lambda v, kq=kq: conv_i8(v, kq), xq, args.iters, device)
        out.append(report(f"{cin:3d}->{cout:3d}: bf16 {dt * 1e3:7.3f} ms "
                          f"{flops / dt / 1e12:6.1f} TF/s   int8 {dt8 * 1e3:7.3f} ms "
                          f"{flops / dt8 / 1e12:6.1f} TOP/s", mode="int8",
                          cin=cin, cout=cout, bf16_ms=dt * 1e3, bf16_tflops=flops / dt / 1e12,
                          int8_ms=dt8 * 1e3, int8_tops=flops / dt8 / 1e12))

    print("-- full packed RDB, bf16 vs int8-with-requant --")
    kernels, biases = rand_weights(device)
    x = _rand((B, s, s, C), device, 99)
    rdb_flops = RDB_FLOPS_PER_PX * B * s * s
    bf16_kernels = [k.to(torch.bfloat16) for k in kernels]
    dt = chain_op_time(lambda v: rdb_packed(bf16_kernels, biases, v), x, args.iters, device,
                       graph=True)
    out.append(report(f"rdb_packed bf16:        {dt * 1e3:7.3f} ms "
                      f"{rdb_flops / dt / 1e12:6.1f} TF/s", mode="int8",
                      case="rdb_packed_bf16", ms=dt * 1e3, tflops=rdb_flops / dt / 1e12))
    rdb_int8 = make_rdb_int8(kernels)
    dt8 = chain_op_time(rdb_int8, x, args.iters, device, graph=True)
    out.append(report(f"rdb_packed int8+requant:{dt8 * 1e3:7.3f} ms "
                      f"{rdb_flops / dt8 / 1e12:6.1f} TOP/s", mode="int8",
                      case="rdb_packed_int8_requant", ms=dt8 * 1e3, tops=rdb_flops / dt8 / 1e12))
    return out


def run_epilogue(args, device) -> List[dict]:
    """``bias_lrelu`` against ``bias_lrelu_plain`` at the tail's three
    launches of a batch-cell forward."""
    s, c = EPILOGUE_SIZE, 64
    cases = (("upconv1", s, True), ("upconv2", 2 * s, True), ("conv3", 4 * s, False))
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        for i, (name, side, shuffle) in enumerate(cases):
            groups = 4 if shuffle else 1
            y = (_rand((EPILOGUE_B, side, side, groups * c), device, 20 + i, 2.0, dtype)
                 - 1.0).permute(0, 3, 1, 2)
            bias = _rand((c,), device, 30 + i, 0.2, torch.float32) - 0.1
            with torch.no_grad():
                ref = bias_lrelu_plain(y, bias, shuffle)
                equal = torch.equal(bias_lrelu(y.clone(memory_format=torch.channels_last),
                                               bias, shuffle), ref)
                del ref
                ms = time_launches(lambda: bias_lrelu(y, bias, shuffle), args.iters, device) * 1e3
                plain_ms = time_launches(lambda: bias_lrelu_plain(y, bias, shuffle), args.iters,
                                         device) * 1e3
            nbytes = 2 * y.numel() * y.element_size()
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            label = f"{name} {str(dtype)[6:]} {tuple(y.shape)}"
            out.append(report(f"{label:40s} kernel {ms:8.4f} ms  bound {bound_ms:8.4f} ms  "
                              f"plain {plain_ms:8.4f} ms  equal {equal}", mode="epilogue",
                              case=name, dtype=str(dtype)[6:], shape=list(y.shape),
                              shuffle=shuffle, ms=ms, bound_ms=bound_ms, plain_ms=plain_ms,
                              bytes=nbytes, tb_per_s=nbytes / ms / 1e9, equal=equal))
            del y
    return out


MODES = {"conv4": run_conv4, "int8": run_int8, "nchw": run_nchw, "epilogue": run_epilogue}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", choices=tuple(MODES), required=True)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (a check of the tool, not a measurement)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    a = build_parser().parse_args(argv)
    device = resolve_device(a.cpu)
    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")
    return MODES[a.mode](a, device)


if __name__ == "__main__":
    main()
