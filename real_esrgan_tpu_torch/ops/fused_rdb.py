"""Fused ResidualDenseBlock: the port of real_esrgan_tpu/ops/pallas_rdb.py.

``fused_rdb`` computes one whole RDB forward (five dense 3x3 convs, LeakyReLU
on the first four, 0.2-scaled residual) in one launch of a hand-written CUDA
kernel of ``csrc/fused_rdb.cu``: bfloat16 on the tensor cores, float32 on
CUDA cores.  It is the hot loop of the generator: 69 launches per forward,
about 93% of its FLOPs.  ``rdb_plan`` states each kernel's tile and shared
memory; the wrapper holds the built kernel to it.

Arithmetic is the packed formulation of the flax block
(real_esrgan_tpu/models/rrdbnet.py, ResidualDenseBlock): a concat conv
``conv([x, o1..ok])`` is the sum of per-source convs.  Each (source, consumer)
conv accumulates in f32 and is rounded to the working dtype; the per-source
terms are added in the working dtype in the order x, o1, ..., then the bias.
Unlike the Pallas kernel, every intermediate is zero outside the image, as
the flax block's 'same' convs make it.

``rdb_plain`` is the same function in plain PyTorch.  ``fused_rdb`` takes it
only for a tensor on the CPU; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from real_esrgan_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_CHANNELS = 64
KERNEL_GROWTH = 32
HALO = 5  # five chained 3x3 convs


def rdb_plan(dtype: torch.dtype) -> dict:
    """The block plan of ``csrc/fused_rdb.cu``'s kernel for ``dtype``.

    ``tile`` is the output tile side T of one block; ``buffers`` the bytes
    of each shared-memory buffer: the x tile with its halo (side T + 10, 64
    channels), o1..o4 (sides T + 8 .. T + 2, 32 channels) and, for bfloat16,
    the ring of two weight slots of 3 taps x 32 input channels x 64 columns;
    ``smem_bytes`` their sum.  For bfloat16, ``stages`` gives each stage's implicit GEMM: region side and
    pixels, fragments of 16 pixels, output columns, and how the warps share
    it: a warp computes 32 columns, so the warps form ``warp_groups`` groups
    (one a 32-column slice), and warp w of a group of g takes fragments
    w, w + g, ..., at most ``units_per_warp``.
    """
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_rdb takes float32 or bfloat16, not {dtype}")
    c, g = KERNEL_CHANNELS, KERNEL_GROWTH
    size = torch.finfo(dtype).bits // 8
    tile = 16 if dtype == torch.bfloat16 else 8
    sides = [tile + 2 * (HALO - k) for k in range(6)]  # x, o1..o4, the output tile
    buffers = {("x" if k == 0 else f"o{k}"): sides[k] ** 2 * (c if k == 0 else g) * size
               for k in range(5)}
    plan = {"tile": tile, "threads": 512, "buffers": buffers}
    if dtype == torch.bfloat16:
        warps = 8
        buffers["weight_ring"] = 2 * 3 * g * c * size
        stages = []
        for k in range(1, 6):
            frags, columns = -(-sides[k] ** 2 // 16), g if k < 5 else c
            groups = columns // g
            stages.append({"side": sides[k], "pixels": sides[k] ** 2, "fragments": frags,
                           "columns": columns, "warp_groups": groups,
                           "units_per_warp": -(-frags // (warps // groups))})
        plan.update(threads=32 * warps, warps=warps, stages=stages)
    plan["smem_bytes"] = sum(buffers.values())
    return plan


def pack_rdb_weights(kernels: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                     channels: int, growth: int,
                     dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, ...]:
    """(conv1..conv5 OIHW weights, biases) -> per-source packed weights + bias.

    Source s (x, o1, o2, o3, o4) gets one tap-major (9, Cin_s, N_s) tensor in
    ``dtype``: its input-channel slice of every consumer conv s+1..5,
    concatenated along N in consumer order (N = 192, 160, 128, 96, 64 at
    c=64, g=32).  The bias is (5, max(c, g)) float32, row k for conv k+1.
    """
    c, g = channels, growth

    def taps(w, lo, hi):  # OIHW[:, lo:hi] -> (9, hi - lo, O)
        return w[:, lo:hi].permute(2, 3, 1, 0).reshape(9, hi - lo, w.shape[0])

    weights = []
    for s in range(5):
        lo, hi = (0, c) if s == 0 else (c + (s - 1) * g, c + s * g)
        weights.append(torch.cat([taps(kernels[k], lo, hi) for k in range(s, 5)],
                                 dim=2).to(dtype).contiguous())
    bias = torch.zeros(5, max(c, g), dtype=torch.float32, device=biases[0].device)
    for i, b in enumerate(biases):
        bias[i, :b.shape[0]] = b.float()
    return tuple(weights) + (bias,)


def scalar_like(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` rounded to ``like``'s dtype, as JAX rounds a weak-typed constant.
    Filled on ``like``'s device, so a CUDA graph can capture it."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def lrelu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.2) with the slope in x's dtype, as flax computes it."""
    return torch.where(x >= 0, x, x * scalar_like(0.2, x))


def rdb_plain(x: torch.Tensor, packed: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch RDB on NHWC ``x`` with ``pack_rdb_weights`` output."""
    *weights, bias = packed
    c = x.shape[-1]
    g = weights[1].shape[1]
    dtype = x.dtype
    xc = x.permute(0, 3, 1, 2)  # NCHW view; channels_last when x is contiguous

    def conv(t, w):  # (9, Cin, N) tap-major -> OIHW
        cin, n = w.shape[1], w.shape[2]
        return F.conv2d(t, w.reshape(3, 3, cin, n).permute(3, 2, 0, 1).to(dtype),
                        padding=1)

    sources = [xc]
    terms = []
    for k in range(5):  # consumer o_{k+1}; source k's conv feeds consumers k..4
        terms.append(conv(sources[k], weights[k]))
        width = g if k < 4 else c
        acc = None
        for s in range(k + 1):
            col = (k - s) * g
            part = terms[s][:, col:col + width]
            acc = part if acc is None else acc + part
        acc = acc + bias[k, :width].to(dtype)[:, None, None]
        if k < 4:
            sources.append(lrelu(acc))
    out = acc * scalar_like(0.2, acc) + xc
    return out.permute(0, 2, 3, 1)


def _check(x: torch.Tensor, packed: Sequence[torch.Tensor]) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_rdb takes float32 or bfloat16, not {x.dtype}")
    if x.dim() != 4 or x.shape[-1] != KERNEL_CHANNELS:
        raise ValueError(f"fused_rdb takes (B, H, W, {KERNEL_CHANNELS}), got {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("fused_rdb needs a contiguous NHWC tensor on a 16-byte boundary")
    if len(packed) != 6:
        raise ValueError("packed must be pack_rdb_weights' 5 weights and bias")
    *weights, bias = packed
    for s, w in enumerate(weights):
        cin = KERNEL_CHANNELS if s == 0 else KERNEL_GROWTH
        n = (4 - s) * KERNEL_GROWTH + KERNEL_CHANNELS
        if tuple(w.shape) != (9, cin, n) or w.dtype != x.dtype or \
                w.device != x.device or not w.is_contiguous():
            raise ValueError(f"packed weight {s} must be contiguous (9, {cin}, {n}) "
                             f"{x.dtype} on {x.device}, got {tuple(w.shape)} {w.dtype} "
                             f"on {w.device}")
    if tuple(bias.shape) != (5, KERNEL_CHANNELS) or bias.dtype != torch.float32 or \
            bias.device != x.device or not bias.is_contiguous():
        raise ValueError("packed bias must be contiguous (5, 64) float32 on x's device")
    # the kernel reads x in 16-byte vectors and weights in 4- or 8-byte pairs
    for name, t in [("weight", w) for w in weights] + [("bias", bias)]:
        if t.data_ptr() % 16:
            raise ValueError(f"packed {name} must start on a 16-byte boundary")


def _library() -> ctypes.CDLL:
    lib = _build.load("fused_rdb")
    if lib.fused_rdb_forward.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_rdb_forward.argtypes = [i] + [vp] * 8 + [i, i, i, vp]
        lib.fused_rdb_forward.restype = i
        for fn in (lib.fused_rdb_tile, lib.fused_rdb_smem_bytes):
            fn.argtypes, fn.restype = [i], i
        for dtype, code in _DTYPE_CODES.items():
            plan = rdb_plan(dtype)
            built = {"tile": lib.fused_rdb_tile(code), "smem_bytes": lib.fused_rdb_smem_bytes(code)}
            if built != {key: plan[key] for key in built}:
                raise RuntimeError(f"csrc/fused_rdb.cu's {dtype} kernel has {built}, rdb_plan "
                                   f"says tile {plan['tile']}, smem_bytes {plan['smem_bytes']}")
    return lib


def built_rdb_plan(dtype: torch.dtype) -> dict:
    """The tile and shared memory the built kernel for ``dtype`` reports
    (building it first if needed); loading raises unless they are
    ``rdb_plan``'s."""
    lib, code = _library(), _DTYPE_CODES[dtype]
    return {"tile": lib.fused_rdb_tile(code), "smem_bytes": lib.fused_rdb_smem_bytes(code)}


def fused_rdb(x: torch.Tensor, packed: Sequence[torch.Tensor]) -> torch.Tensor:
    """One RDB forward on NHWC ``x`` (B, H, W, 64), float32 or bfloat16.

    ``packed`` is ``pack_rdb_weights(..., dtype=x.dtype)``.  A CPU tensor
    goes through ``rdb_plain``; a CUDA tensor through its dtype's CUDA kernel
    (bfloat16: tensor cores; float32: CUDA cores), which adds one to
    ``fused_rdb.launches``, or raises: there is no fallback.
    """
    if x.device.type == "cpu":
        return rdb_plain(x, packed)
    if x.device.type != "cuda":
        raise ValueError(f"fused_rdb runs on cpu or cuda, not {x.device}")
    _check(x, packed)
    lib = _library()
    b, h, w, _ = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_rdb_forward(_DTYPE_CODES[x.dtype], x.data_ptr(),
                                    *[t.data_ptr() for t in packed], out.data_ptr(),
                                    b, h, w, stream)
    if err != 0:
        raise RuntimeError(f"fused_rdb kernel launch failed with CUDA error {err}")
    fused_rdb.launches += 1
    return out


fused_rdb.launches = 0
