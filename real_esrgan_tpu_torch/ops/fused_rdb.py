"""Fused ResidualDenseBlock: the port of real_esrgan_tpu/ops/pallas_rdb.py.

``fused_rdb`` computes one whole RDB forward (five dense 3x3 convs, LeakyReLU
on the first four, 0.2-scaled residual) in one launch of a hand-written CUDA
kernel of ``csrc/fused_rdb.cu``, on the tensor cores in both dtypes, by two
schedules.  bfloat16 runs on Hopper's own path: the x tile arrives by TMA,
a producer warpgroup streams the weights by bulk copies through a ring of
mbarrier-guarded slots, and two consumer warpgroups issue ``wgmma`` with A
from registers.  It reads the weights as 124 boxes of 32 columns x 64 k,
laid out and swizzled as shared memory wants them (``box_rdb_weights``).
float32 runs the earlier ``ldmatrix`` + ``mma.sync`` schedule as three
bfloat16 products: the tensor cores take float32 only as TF32, which breaks
the f32 bound of 1e-4, so each f32 operand ``a`` is split into ``hi =
bf16(a)`` and ``lo = bf16(a - hi)`` (``split_bf16``) and each product is
``hi*hi + hi*lo + lo*hi`` summed in f32 (``split_rdb_weights``).  Both forms of the weights
are made once a pack: ``ResidualDenseBlock`` keeps them beside its pack.
The kernel is the hot loop of the generator: 69 launches per forward, about
93% of its FLOPs.  ``rdb_plan`` states each kernel's geometry; the wrapper
holds the built kernel to it.

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

A process started with ``FUSED_RDB_LAUNCH_LOG=<file>`` in its environment
appends one JSON line to that file as it exits, ``{"pid", "argv",
"launches"}``, so that a parent counts the kernel's launches in the
processes it starts (a CLI in a shell script, say).
"""

from __future__ import annotations

import atexit
import ctypes
import json
import os
import sys
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from real_esrgan_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_CHANNELS = 64
KERNEL_GROWTH = 32
HALO = 5  # five chained 3x3 convs


# the bfloat16 kernel's weight stream and shared memory (csrc/fused_rdb.cu, namespace wg)
BOX_ROWS = 32         # output columns of a weight box
BOX_K = 64            # k of a weight box: one 128-byte row a column
BOX_BYTES = BOX_ROWS * BOX_K * 2
RING_SLOTS = 7
SMEM_ALIGN = 1024     # the 128-byte swizzle repeats every 1024 bytes
MBARRIER_BYTES = 8
UNIT_PIXELS = 64      # one wgmma m64 tile of region pixels
CONSUMER_WARPGROUPS = 2


def _source_boxes(s: int) -> int:
    """Boxes of one (consumer, source) pair and one 32-column half: 9 Cin k
    in whole boxes of 64 (x: 9; o1..o4: 5, the last half zeros)."""
    cin = KERNEL_CHANNELS if s == 0 else KERNEL_GROWTH
    return -(-9 * cin // BOX_K)


def rdb_plan(dtype: torch.dtype) -> dict:
    """The block plan of ``csrc/fused_rdb.cu``'s kernel for ``dtype``.

    ``tile`` is the output tile side T of one block.  Every block keeps the
    x tile with its halo (side T + 10, 64 channels) and o1..o4 (sides T + 8
    .. T + 2, 32 channels) in shared memory, and ``stages`` gives each
    stage's implicit GEMM over its region (side T + 8 .. T): pixels, output
    columns and how the block shares them.  ``ring_slots`` of ``slot_bytes``
    stream ``slots_per_tile`` weight slices or boxes a tile; ``buffers``
    sums to ``smem_bytes``.

    bfloat16 (``rdb_bf16_wgmma_kernel``): T = 16, two consumer warpgroups
    and a producer warpgroup, which gives its ``registers`` up to them.  A
    stage's region is cut into units of 64 pixels (one wgmma m64 tile);
    warpgroup g takes units g, g + 2, ...; where the count is odd,
    warpgroup 1's last unit is a dummy that stores nothing.  The weights
    arrive as boxes of 32 columns x 64 k (4096 bytes, ``box_rdb_weights``),
    source-major: ``boxes`` of each source, an o's last box half zeros, of
    which only ``k_steps`` steps of 16 are issued; stage 5's 64 columns are
    two ``halves``, a box and a wgmma each.  The ring's slots and x sit on
    1024-byte boundaries (``align``: the room to find one); each slot has a
    full and an empty mbarrier, x one.

    float32 (``rdb_f32_split_kernel``): T = 8 and ``products`` 3 (hi*hi,
    hi*lo, lo*hi).  Each buffer holds a hi and a lo bf16 ``planes`` in the
    same layout; the ring is two slots of a slice of 3 taps x 32 input
    channels x 64 columns, in both planes, 60 a tile.  Eight warps of 32
    columns each form ``warp_groups`` groups (one a 32-column slice), and
    warp w of a group of g takes fragments of 16 pixels w, w + g, ..., at
    most ``units_per_warp``.
    """
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_rdb takes float32 or bfloat16, not {dtype}")
    c, g = KERNEL_CHANNELS, KERNEL_GROWTH
    if dtype == torch.bfloat16:
        tile = 16
        sides = [tile + 2 * (HALO - k) for k in range(6)]
        buffers = {"align": SMEM_ALIGN, "weight_ring": RING_SLOTS * BOX_BYTES}
        for k in range(5):
            buffers["x" if k == 0 else f"o{k}"] = sides[k] ** 2 * (c if k == 0 else g) * 2
        buffers["mbarriers"] = (2 * RING_SLOTS + 1) * MBARRIER_BYTES
        stages = []
        for k in range(1, 6):
            units = -(-sides[k] ** 2 // UNIT_PIXELS)
            per_group = -(-units // CONSUMER_WARPGROUPS)
            stages.append({
                "side": sides[k], "pixels": sides[k] ** 2, "units": units,
                "columns": g if k < 5 else c, "halves": 1 if k < 5 else 2,
                "units_per_warpgroup": per_group,
                "dummy_units": CONSUMER_WARPGROUPS * per_group - units,
                "boxes": [_source_boxes(s) for s in range(k)],
                "k_steps": [9 * (c if s == 0 else g) // 16 for s in range(k)]})
        return {"tile": tile, "products": 1, "planes": 1,
                "threads": 128 * (CONSUMER_WARPGROUPS + 1),
                "consumer_warpgroups": CONSUMER_WARPGROUPS, "producer_warpgroups": 1,
                "registers": {"consumer": 240, "producer": 24},
                "ring_slots": RING_SLOTS, "slot_bytes": BOX_BYTES,
                "slots_per_tile": sum(st["halves"] * sum(st["boxes"]) for st in stages),
                "buffers": buffers, "stages": stages, "smem_bytes": sum(buffers.values())}
    warps, planes, tile, ring_slots = 8, 2, 8, 2
    sides = [tile + 2 * (HALO - k) for k in range(6)]  # x, o1..o4, the output tile
    buffers = {("x" if k == 0 else f"o{k}"): sides[k] ** 2 * (c if k == 0 else g) * planes * 2
               for k in range(5)}
    slot_bytes = 3 * g * c * planes * 2
    buffers["weight_ring"] = ring_slots * slot_bytes
    stages = []
    for k in range(1, 6):
        frags, columns = -(-sides[k] ** 2 // 16), g if k < 5 else c
        groups = columns // g
        stages.append({"side": sides[k], "pixels": sides[k] ** 2, "fragments": frags,
                       "columns": columns, "warp_groups": groups,
                       "units_per_warp": -(-frags // (warps // groups))})
    return {"tile": tile, "products": 3, "planes": planes, "threads": 32 * warps,
            "warps": warps, "ring_slots": ring_slots, "slot_bytes": slot_bytes,
            "slots_per_tile": 3 * (2 + 3 + 4 + 5 + 6), "buffers": buffers, "stages": stages,
            "smem_bytes": sum(buffers.values())}


# the keys of rdb_plan that the built library reports, in fused_rdb_built_plan's order
BUILT_PLAN_KEYS = ("tile", "threads", "smem_bytes", "ring_slots", "slot_bytes", "slots_per_tile")


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


def box_rdb_weights(packed: Sequence[torch.Tensor]) -> torch.Tensor:
    """The five bfloat16 weights of ``pack_rdb_weights`` as the bfloat16
    kernel streams them: 124 boxes of 32 columns x 64 k, one flat bfloat16
    tensor on the pack's device.

    Consumer k (o1..o5) takes from source s (x, o1..o4) the K-major matrix
    (N, 9 Cin_s), N its 32 or 64 columns, k = (g, tap, c) for input channel
    32 g + c: the order in which the earlier mma.sync schedule and the
    card's library convolution sum, so that the f32 sums round to bf16 as
    theirs do.  It is cut into
    whole boxes of 64 k (an o's 288 k padded with zeros to 320) and into
    halves of 32 columns.  The stream is consumer-major, then source, box
    and half.  A box is 32 rows of 128 bytes, each row's 16-byte chunk c at
    chunk c ^ (row % 8): the 128-byte swizzle, as a wgmma descriptor reads
    it from a 1024-aligned slot.  Made once a pack: ``ResidualDenseBlock``
    keeps it beside its pack and drops both together."""
    weights = packed[:5]
    boxes = []
    for k in range(1, 6):
        n = KERNEL_GROWTH if k < 5 else KERNEL_CHANNELS
        for s in range(k):
            w = weights[s]
            cin = w.shape[1]
            cols = (k - 1 - s) * KERNEL_GROWTH
            # k = (group of 32 input channels, tap, channel of the group)
            b = w[:, :, cols:cols + n].reshape(9, cin // BOX_ROWS, BOX_ROWS, n)
            b = b.permute(1, 0, 2, 3).reshape(9 * cin, n).t()
            nb = _source_boxes(s)
            b = F.pad(b, (0, nb * BOX_K - 9 * cin))
            b = b.reshape(n // BOX_ROWS, BOX_ROWS, nb, BOX_K).permute(2, 0, 1, 3)
            boxes.append(b.reshape(-1, BOX_ROWS * BOX_K))
    boxes = torch.cat(boxes)
    row = torch.arange(BOX_ROWS, device=boxes.device)[:, None, None]
    chunk = torch.arange(BOX_K // 8, device=boxes.device)[None, :, None]
    within = torch.arange(8, device=boxes.device)[None, None, :]
    source = (row * BOX_K + (chunk ^ (row % 8)) * 8 + within).reshape(-1)
    return boxes[:, source].reshape(-1).contiguous()


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


def _check(x: torch.Tensor, packed: Sequence[torch.Tensor], split=None, boxes=None) -> None:
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
    if boxes is not None:
        if x.dtype != torch.bfloat16:
            raise ValueError("only the bfloat16 kernel takes weight boxes")
        size = rdb_plan(torch.bfloat16)["slots_per_tile"] * BOX_BYTES // 2
        if tuple(boxes.shape) != (size,) or boxes.dtype != torch.bfloat16 or \
                boxes.device != x.device or not boxes.is_contiguous():
            raise ValueError(f"boxes must be box_rdb_weights' contiguous ({size},) bfloat16 on "
                             f"{x.device}, got {tuple(boxes.shape)} {boxes.dtype} on "
                             f"{boxes.device}")
        parts.append(("boxes", boxes))
    # the kernels read x and the weights in 16-byte chunks
    for name, t in [("packed weight", w) for w in weights] + [("packed bias", bias)] + parts:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _built_plan(lib: ctypes.CDLL, dtype: torch.dtype) -> dict:
    values = (ctypes.c_int * len(BUILT_PLAN_KEYS))()
    err = lib.fused_rdb_built_plan(_DTYPE_CODES[dtype], values)
    if err != 0:
        raise RuntimeError(f"fused_rdb_built_plan failed with CUDA error {err}")
    return dict(zip(BUILT_PLAN_KEYS, values))


def _library() -> ctypes.CDLL:
    lib = _build.load("fused_rdb")
    if lib.fused_rdb_forward.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_rdb_forward.argtypes = [i] + [vp] * 13 + [i, i, i, vp]
        lib.fused_rdb_forward.restype = i
        lib.fused_rdb_built_plan.argtypes = [i, ctypes.POINTER(i)]
        lib.fused_rdb_built_plan.restype = i
        for dtype in _DTYPE_CODES:
            plan, built = rdb_plan(dtype), _built_plan(lib, dtype)
            if built != {key: plan[key] for key in BUILT_PLAN_KEYS}:
                raise RuntimeError(f"csrc/fused_rdb.cu's {dtype} kernel has {built}, rdb_plan "
                                   f"says {({key: plan[key] for key in BUILT_PLAN_KEYS})}")
    return lib


def built_rdb_plan(dtype: torch.dtype) -> dict:
    """The geometry the built kernel for ``dtype`` reports (``BUILT_PLAN_KEYS``:
    tile, threads, shared memory, ring slots, slot bytes, slots a tile),
    building it first if needed; loading raises unless it is ``rdb_plan``'s."""
    return _built_plan(_library(), dtype)


def fused_rdb(x: torch.Tensor, packed: Sequence[torch.Tensor], split=None,
              boxes: torch.Tensor = None) -> torch.Tensor:
    """One RDB forward on NHWC ``x`` (B, H, W, 64), float32 or bfloat16.

    ``packed`` is ``pack_rdb_weights(..., dtype=x.dtype)``.  A CPU tensor
    goes through ``rdb_plain``; a CUDA tensor through its dtype's CUDA kernel
    on the tensor cores, which adds one to ``fused_rdb.launches``, or raises:
    there is no fallback.  The float32 kernel reads the weights as ``split =
    split_rdb_weights(packed)``, the bfloat16 kernel as ``boxes =
    box_rdb_weights(packed)``; pass them to make them once, or the call
    makes them itself (some twenty, or some eighty, small launches).

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
    if x.dtype == torch.float32 and split is None and boxes is None:
        split = split_rdb_weights(packed)
    if x.dtype == torch.bfloat16 and boxes is None and split is None:
        boxes = box_rdb_weights(packed)
    _check(x, packed, split, boxes)
    lib = _library()
    b, h, w, _ = x.shape
    *weights, bias = packed
    if x.dtype == torch.float32:
        hi, lo = [t.data_ptr() for t in split[0]], [t.data_ptr() for t in split[1]]
    else:
        hi, lo = [boxes.data_ptr()] + [None] * 4, [None] * 5
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_rdb_forward(_DTYPE_CODES[x.dtype], x.data_ptr(), *hi, *lo,
                                    bias.data_ptr(), out.data_ptr(), b, h, w, stream)
    if err != 0:
        raise RuntimeError(f"fused_rdb kernel launch failed with CUDA error {err}")
    fused_rdb.launches += 1
    return out


fused_rdb.launches = 0


def _log_launches(path: str) -> None:
    with open(path, "a") as f:
        f.write(json.dumps({"pid": os.getpid(), "argv": sys.argv,
                            "launches": fused_rdb.launches}) + "\n")


if os.environ.get("FUSED_RDB_LAUNCH_LOG"):
    atexit.register(_log_launches, os.environ["FUSED_RDB_LAUNCH_LOG"])
