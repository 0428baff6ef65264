"""LayerNorm over the last dim, SwinIR's normalisation of its token stream
(``models/swinir.py::LayerNorm``).

``layer_norm(x, weight, bias, eps)`` takes ``x`` of (..., C) in float32 or
bfloat16, contiguous, and ``weight`` and ``bias`` of C in ``x``'s dtype,
and returns ``(x - mean) / sqrt(var + eps) * weight + bias`` a row, the
statistics in float32 and the output rounded once to ``x``'s dtype, in a
fresh tensor of ``x``'s shape.

``layer_norm_plain`` is the same function in plain PyTorch
(``F.layer_norm``).  ``layer_norm`` takes it only for a tensor on the CPU;
on a CUDA tensor it launches the hand-written kernel ``csrc/layer_norm.cu``
(a warp a row, rows of up to ``MAX_CHANNELS``) or raises.  The two differ by
the order of their sums.

Each launch adds one to ``layer_norm.launches``: 110 a SwinIR-L forward on
the card under ``no_grad`` (two a Swin block, ``patch_embed.norm`` and
``norm``), none under autograd.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from real_esrgan_tpu_torch.ops import _build

MAX_CHANNELS = 256  # csrc/layer_norm.cu's kMaxChannels: 8 channels a lane of a warp
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """Plain PyTorch version of ``layer_norm``."""
    return F.layer_norm(x, x.shape[-1:], weight, bias, eps)


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"layer_norm takes float32 or bfloat16, not {x.dtype}")
    if weight.dtype != x.dtype or bias.dtype != x.dtype:
        raise TypeError(f"layer_norm takes weight and bias in x's dtype {x.dtype}, "
                        f"not {weight.dtype} and {bias.dtype}")
    if x.dim() < 1 or not 1 <= x.shape[-1] <= MAX_CHANNELS:
        raise ValueError(f"layer_norm takes rows of 1 to {MAX_CHANNELS} channels, "
                         f"got {tuple(x.shape)}")
    channels = x.shape[-1]
    if tuple(weight.shape) != (channels,) or tuple(bias.shape) != (channels,):
        raise ValueError(f"layer_norm takes a weight and a bias of ({channels},), got "
                         f"{tuple(weight.shape)} and {tuple(bias.shape)}")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError(f"layer_norm: x on {x.device}, weight on {weight.device}, "
                         f"bias on {bias.device}")
    if not (x.is_contiguous() and weight.is_contiguous() and bias.is_contiguous()):
        raise ValueError("layer_norm needs x, weight and bias contiguous")


def _library() -> ctypes.CDLL:
    lib = _build.load("layer_norm")
    if lib.layer_norm_forward.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.layer_norm_forward.argtypes = [i, vp, vp, vp, vp, ctypes.c_longlong, i,
                                           ctypes.c_float, i, vp]
        lib.layer_norm_forward.restype = i
    return lib


def vector_bytes(*tensors: torch.Tensor) -> int:
    """The widest copy (16, 8, 4 bytes, or 2 for bfloat16) that divides a row
    of the first tensor and every tensor's alignment."""
    esize = tensors[0].element_size()
    row = tensors[0].shape[-1] * esize
    return next(v for v in (16, 8, 4, 2) if v >= esize and row % v == 0
                and all(t.data_ptr() % v == 0 for t in tensors))


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm of ``x``'s rows (see the module's docstring).  A CPU tensor
    goes through ``layer_norm_plain``; a CUDA tensor through the kernel,
    which counts its launch, or raises.  The kernel has no backward: on a
    CUDA tensor with autograd on and any input requiring grad, it raises
    rather than return an output cut from the graph."""
    _check(x, weight, bias)
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm runs on cpu or cuda, not {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        raise RuntimeError("layer_norm: the CUDA kernel has no backward, so its output would "
                           "carry no gradient; use layer_norm_plain under autograd")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.layer_norm_forward(_DTYPE_CODES[x.dtype], x.data_ptr(), weight.data_ptr(),
                                     bias.data_ptr(), out.data_ptr(), x.numel() // x.shape[-1],
                                     x.shape[-1], eps, vector_bytes(x, weight, bias, out), stream)
    if err != 0:
        raise RuntimeError(f"layer_norm kernel launch failed with CUDA error {err}")
    layer_norm.launches += 1
    return out


layer_norm.launches = 0
