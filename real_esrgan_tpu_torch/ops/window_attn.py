"""Shifted-window multi-head self-attention of SwinIR's Swin blocks
(``models/swinir.py``): from the qkv projection's output to the heads'
concatenated output, in image order.

``window_attn(qkv, table, heads, shift)`` takes ``qkv``, a contiguous
(B, H, W, 3 C) tensor in float32 or bfloat16, channels ordered [q | k |
v][head][30] (C = heads x 30), H and W multiples of 8; ``table``, the
float32 ((2 x 8 - 1)^2, heads) relative-position bias table; and ``shift``,
0 or the cyclic shift of a shifted block.  Within each 8 x 8 window of the
image rolled by (-shift, -shift) it returns, for every head,
``softmax(q k^T / sqrt(30) + B + M) v`` at the same pixels of a fresh
(B, H, W, C) tensor: ``B`` the table entry of each query and key's relative
position (``relative_position_index``), ``M`` -100 between tokens of
different shift regions (``shift_mask``), 0 without a shift.

``window_attn_plain`` is the same function in plain PyTorch, SwinIR's
composition: roll, window partition, the scores, bias, mask and softmax in
float32, the probabilities rounded to ``qkv``'s dtype for the product with v,
window reverse, roll back.  ``window_attn`` takes it only for a tensor on the
CPU; on a CUDA tensor it launches the hand-written kernel
``csrc/window_attn.cu`` or raises.  The kernel rounds where the plain version
does; the two differ by the order of their sums.

Each launch adds one to ``window_attn.launches``: one a Swin block, 54 a
SwinIR-L forward on the card under ``no_grad``, none under autograd.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from real_esrgan_tpu_torch.ops import _build

WINDOW = 8
HEAD_DIM = 30
MAX_HEADS = 8  # csrc/window_attn.cu's kMaxHeads: one warp a head
MASK_VALUE = -100.0
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def scale(head_dim: int = HEAD_DIM) -> float:
    """SwinIR's ``qk_scale=None``: head_dim ** -0.5."""
    return head_dim ** -0.5


@functools.lru_cache(maxsize=None)
def _relative_position_index(device: str) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(torch.arange(WINDOW), torch.arange(WINDOW),
                                        indexing="ij")).flatten(1)  # (2, N)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (WINDOW - 1)
    return (rel[:, :, 0] * (2 * WINDOW - 1) + rel[:, :, 1]).to(device)


def relative_position_index(device="cpu") -> torch.Tensor:
    """(N, N) index into the bias table of query n's and key m's relative
    position in a window of N = 8^2 tokens, row-major: (dy + 7) 15 + (dx +
    7), d = n's - m's.  Made once a device."""
    return _relative_position_index(str(device))


@functools.lru_cache(maxsize=None)
def _shift_mask(height: int, width: int, shift: int, device: str) -> torch.Tensor:
    labels = torch.zeros(height, width)
    slices = (slice(0, -WINDOW), slice(-WINDOW, -shift), slice(-shift, None))
    for i, hs in enumerate(slices):
        for j, ws in enumerate(slices):
            labels[hs, ws] = 3 * i + j
    windows = partition(labels[None, :, :, None]).squeeze(-1)  # (windows, N)
    diff = windows[:, None, :] - windows[:, :, None]
    return torch.where(diff != 0, MASK_VALUE, 0.0).to(device)


def shift_mask(height: int, width: int, shift: int, device="cpu") -> torch.Tensor:
    """(windows, N, N) float32: 0 between tokens of one shift region of the
    rolled image, ``MASK_VALUE`` between tokens of two.  The regions are
    the slices (0:-8), (-8:-shift), (-shift:) of each axis.  Made once a
    size and device."""
    return _shift_mask(height, width, shift, str(device))


def partition(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B x windows, N, C), windows row-major."""
    b, h, w, c = x.shape
    x = x.view(b, h // WINDOW, WINDOW, w // WINDOW, WINDOW, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, WINDOW * WINDOW, c)


def reverse(windows: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``partition``'s inverse: (B x windows, N, C) -> (B, H, W, C)."""
    c = windows.shape[-1]
    x = windows.view(-1, height // WINDOW, width // WINDOW, WINDOW, WINDOW, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, height, width, c)


def window_attn_plain(qkv: torch.Tensor, table: torch.Tensor, heads: int,
                      shift: int) -> torch.Tensor:
    """Plain PyTorch version of ``window_attn`` (any head dim)."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads
    n = WINDOW * WINDOW
    x = torch.roll(qkv, (-shift, -shift), (1, 2)) if shift else qkv
    x = partition(x).view(-1, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = x[0], x[1], x[2]                          # (B windows, heads, N, hd)
    s = (q.float() @ k.float().transpose(-2, -1)) * scale(hd)
    bias = table.float()[relative_position_index(table.device).reshape(-1)]
    s = s + bias.view(n, n, heads).permute(2, 0, 1)
    if shift:
        mask = shift_mask(h, w, shift, qkv.device)
        s = (s.view(b, -1, heads, n, n) + mask[None, :, None]).view(-1, heads, n, n)
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    o = reverse((p @ v).transpose(1, 2).reshape(-1, n, c), h, w)
    return torch.roll(o, (shift, shift), (1, 2)) if shift else o


def _check(qkv: torch.Tensor, table: torch.Tensor, heads: int, shift: int) -> None:
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"window_attn takes float32 or bfloat16, not {qkv.dtype}")
    if table.dtype != torch.float32:
        raise TypeError(f"window_attn takes a float32 bias table, not {table.dtype}")
    if not 1 <= heads <= MAX_HEADS:
        raise ValueError(f"window_attn takes 1 to {MAX_HEADS} heads, not {heads}")
    n_rel = (2 * WINDOW - 1) ** 2
    if qkv.dim() != 4 or qkv.shape[3] != 3 * heads * HEAD_DIM:
        raise ValueError(f"window_attn takes qkv (B, H, W, 3 x {heads} x {HEAD_DIM}), "
                         f"got {tuple(qkv.shape)}")
    if qkv.shape[1] % WINDOW or qkv.shape[2] % WINDOW:
        raise ValueError(f"window_attn takes sides that are multiples of {WINDOW}, "
                         f"got {tuple(qkv.shape[1:3])}")
    if tuple(table.shape) != (n_rel, heads):
        raise ValueError(f"window_attn takes a table of ({n_rel}, {heads}), "
                         f"got {tuple(table.shape)}")
    if not 0 <= shift < WINDOW:
        raise ValueError(f"window_attn takes a shift in [0, {WINDOW}), not {shift}")
    if table.device != qkv.device:
        raise ValueError(f"window_attn: qkv on {qkv.device}, table on {table.device}")
    if not qkv.is_contiguous() or not table.is_contiguous():
        raise ValueError("window_attn needs qkv and the table contiguous")


def _library() -> ctypes.CDLL:
    lib = _build.load("window_attn")
    if lib.window_attn_forward.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.window_attn_forward.argtypes = [i, vp, vp, vp] + [i] * 5 + [ctypes.c_float, i, vp]
        lib.window_attn_forward.restype = i
    return lib


def vector_bytes(qkv: torch.Tensor, out: torch.Tensor) -> int:
    """The widest copy (16, 8 or 4 bytes) that divides an output row and both
    tensors' alignment."""
    row = out.shape[-1] * out.element_size()
    return next(v for v in (16, 8, 4) if row % v == 0 and qkv.data_ptr() % v == 0
                and out.data_ptr() % v == 0)


def window_attn(qkv: torch.Tensor, table: torch.Tensor, heads: int, shift: int) -> torch.Tensor:
    """Shifted-window attention (see the module's docstring).  A CPU tensor
    goes through ``window_attn_plain``; a CUDA tensor through the kernel,
    which counts its launch, or raises.  The kernel has no backward: on a
    CUDA tensor with autograd on and ``qkv`` or ``table`` requiring grad, it
    raises rather than return an output cut from the graph."""
    _check(qkv, table, heads, shift)
    if qkv.device.type == "cpu":
        return window_attn_plain(qkv, table, heads, shift)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attn runs on cpu or cuda, not {qkv.device}")
    if torch.is_grad_enabled() and (qkv.requires_grad or table.requires_grad):
        raise RuntimeError("window_attn: the CUDA kernel has no backward, so its output would "
                           "carry no gradient; use window_attn_plain under autograd")
    b, h, w, c3 = qkv.shape
    out = torch.empty((b, h, w, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.window_attn_forward(_DTYPE_CODES[qkv.dtype], qkv.data_ptr(), table.data_ptr(),
                                      out.data_ptr(), b, h, w, heads, shift, scale(),
                                      vector_bytes(qkv, out), stream)
    if err != 0:
        raise RuntimeError(f"window_attn kernel launch failed with CUDA error {err}")
    window_attn.launches += 1
    return out


window_attn.launches = 0
