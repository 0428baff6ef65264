"""Fused ResidualDenseBlock: the port of real_esrgan_tpu/ops/pallas_rdb.py.

``fused_rdb`` computes one whole RDB forward (five dense 3x3 convs, LeakyReLU
on the first four, 0.2-scaled residual) in one launch of a hand-written CUDA
kernel of ``csrc/fused_rdb.cu``, on the tensor cores in both dtypes:
bfloat16 as it is, float32 as three bfloat16 products.  The tensor cores
take float32 only as TF32, which breaks the f32 bound of 1e-4, so each f32
operand ``a`` is split into ``hi = bf16(a)`` and ``lo = bf16(a - hi)``
(``split_bf16``) and each product is ``hi*hi + hi*lo + lo*hi`` summed in
f32.  The weights are split once a pack (``split_rdb_weights``), the
activations inside the kernel.  It is the hot loop of the generator: 69
launches per forward, about 93% of its FLOPs.  ``rdb_plan`` states each
kernel's tile and shared memory; the wrapper holds the built kernel to it.

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

    Both dtypes run one schedule on the tensor cores, with ``products`` bf16
    products a fragment pair: 1 for bfloat16, 3 for float32 (hi*hi, hi*lo,
    lo*hi).  ``tile`` is the output tile side T of one block; ``planes`` the
    bf16 planes of each shared-memory buffer (float32: a hi and a lo plane in
    the same layout); ``buffers`` the bytes of each buffer: the x tile with
    its halo (side T + 10, 64 channels), o1..o4 (sides T + 8 .. T + 2, 32
    channels) and the ring of two weight slots of 3 taps x 32 input channels x
    64 columns, in as many planes; ``smem_bytes`` their sum.  ``stages`` gives
    each stage's implicit GEMM: region side and pixels, fragments of 16
    pixels, output columns, and how the warps share it: a warp computes 32
    columns, so the warps form ``warp_groups`` groups (one a 32-column
    slice), and warp w of a group of g takes fragments w, w + g, ..., at most
    ``units_per_warp``.
    """
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_rdb takes float32 or bfloat16, not {dtype}")
    c, g, warps = KERNEL_CHANNELS, KERNEL_GROWTH, 8
    split = dtype == torch.float32
    planes, tile = (2, 8) if split else (1, 16)
    plane_bytes = 2  # every plane holds bf16
    sides = [tile + 2 * (HALO - k) for k in range(6)]  # x, o1..o4, the output tile
    buffers = {("x" if k == 0 else f"o{k}"): sides[k] ** 2 * (c if k == 0 else g) * planes * plane_bytes
               for k in range(5)}
    buffers["weight_ring"] = 2 * 3 * g * c * planes * plane_bytes
    stages = []
    for k in range(1, 6):
        frags, columns = -(-sides[k] ** 2 // 16), g if k < 5 else c
        groups = columns // g
        stages.append({"side": sides[k], "pixels": sides[k] ** 2, "fragments": frags,
                       "columns": columns, "warp_groups": groups,
                       "units_per_warp": -(-frags // (warps // groups))})
    return {"tile": tile, "products": 3 if split else 1, "planes": planes,
            "threads": 32 * warps, "warps": warps, "buffers": buffers, "stages": stages,
            "smem_bytes": sum(buffers.values())}


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


def split_bf16(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``t`` as two bfloat16 parts: ``hi = bf16(t)``, ``lo = bf16(t - hi)``.

    ``t - hi`` is exact in f32, so ``hi + lo`` keeps 16 of t's 24 significant
    bits; the kernel splits its activations the same way.  Elementwise IEEE
    operations only, so the parts are the same bits on the CPU and the card."""
    hi = t.to(torch.bfloat16)
    return hi, (t - hi.float()).to(torch.bfloat16)


def split_rdb_weights(packed: Sequence[torch.Tensor]
                      ) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """The five float32 weights of ``pack_rdb_weights`` as ``(hi, lo)``: five
    bfloat16 hi parts and five lo parts (``split_bf16``), which the float32
    kernel reads.  Split once a pack: ``ResidualDenseBlock`` keeps the split
    beside its pack and drops both together."""
    parts = [split_bf16(w) for w in packed[:5]]
    return tuple(hi for hi, _ in parts), tuple(lo for _, lo in parts)


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


def _check(x: torch.Tensor, packed: Sequence[torch.Tensor], split=None) -> None:
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
    parts = []
    if split is not None:
        if x.dtype != torch.float32:
            raise ValueError("only the float32 kernel takes split weights")
        if len(split) != 2 or any(len(part) != 5 for part in split):
            raise ValueError("split must be split_rdb_weights' (hi, lo), five weights each")
        for name, part in zip(("hi", "lo"), split):
            for s, (t, w) in enumerate(zip(part, weights)):
                if t.shape != w.shape or t.dtype != torch.bfloat16 or \
                        t.device != x.device or not t.is_contiguous():
                    raise ValueError(f"split {name} weight {s} must be contiguous "
                                     f"{tuple(w.shape)} bfloat16 on {x.device}, got "
                                     f"{tuple(t.shape)} {t.dtype} on {t.device}")
                parts.append((f"split {name}", t))
    # the kernel reads x and the weights in 16-byte chunks
    for name, t in [("packed weight", w) for w in weights] + [("packed bias", bias)] + parts:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _library() -> ctypes.CDLL:
    lib = _build.load("fused_rdb")
    if lib.fused_rdb_forward.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_rdb_forward.argtypes = [i] + [vp] * 13 + [i, i, i, vp]
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


def fused_rdb(x: torch.Tensor, packed: Sequence[torch.Tensor], split=None) -> torch.Tensor:
    """One RDB forward on NHWC ``x`` (B, H, W, 64), float32 or bfloat16.

    ``packed`` is ``pack_rdb_weights(..., dtype=x.dtype)``.  A CPU tensor
    goes through ``rdb_plain``; a CUDA tensor through its dtype's CUDA kernel
    on the tensor cores (float32 as three bfloat16 products), which adds one
    to ``fused_rdb.launches``, or raises: there is no fallback.  The float32
    kernel reads the weights as ``split = split_rdb_weights(packed)``; pass
    it to split them once, or the call splits them itself (some twenty
    elementwise launches).  bfloat16 takes no split.

    The kernel has no backward.  On a CUDA tensor with autograd on and
    ``x`` or a packed tensor requiring grad, it raises rather than return an
    output cut from the graph.
    """
    if x.device.type == "cpu":
        return rdb_plain(x, packed)
    if x.device.type != "cuda":
        raise ValueError(f"fused_rdb runs on cpu or cuda, not {x.device}")
    tensors = [*packed, *(t for part in split or () for t in part)]
    if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in tensors)):
        raise RuntimeError("fused_rdb: the CUDA kernel has no backward, so its output would "
                           "carry no gradient; train with Generator(packed=False) or the "
                           "plain math (rdb_plain), or run the forward under torch.no_grad()")
    if x.dtype == torch.float32 and split is None:
        split = split_rdb_weights(packed)
    _check(x, packed, split)
    lib = _library()
    b, h, w, _ = x.shape
    *weights, bias = packed
    hi, lo = split if split is not None else (weights, [None] * 5)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_rdb_forward(_DTYPE_CODES[x.dtype], x.data_ptr(),
                                    *[t.data_ptr() for t in hi],
                                    *[None if t is None else t.data_ptr() for t in lo],
                                    bias.data_ptr(), out.data_ptr(), b, h, w, stream)
    if err != 0:
        raise RuntimeError(f"fused_rdb kernel launch failed with CUDA error {err}")
    fused_rdb.launches += 1
    return out


fused_rdb.launches = 0
