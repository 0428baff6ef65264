"""The generator tail's epilogue: bias, LeakyReLU(0.2) and, after a folded
x2 upconv, the pixel shuffle, in one pass over a convolution's output.

``bias_lrelu(y, bias, shuffle)`` takes the output ``y`` of a convolution
run without its bias: an NCHW tensor in channels_last memory.  With
``shuffle`` it is a folded upconv's (N, 4 C, H, W), channel (2 a + b) C + o
the sub-position (a, b) of output channel o, and the result is a fresh
channels_last (N, C, 2H, 2W): ``models/rrdbnet.py::_subpixel_upconv``'s
order.  Without, it is ``conv3``'s (N, C, H, W), and the result is ``y``
itself, overwritten on a CUDA device.  ``bias`` is the convolution's float32
bias of C, rounded to ``y``'s dtype as ``Conv3x3`` rounds it.

``bias_lrelu_plain`` is the same function in plain PyTorch, the model's
composition as it was before the kernel: the bias add, ``lrelu`` and, for a
shuffle, a reshape and permute copied back to channels_last.  ``bias_lrelu``
takes it only for a tensor on the CPU; on a CUDA tensor it launches the
hand-written kernel ``csrc/tail_epilogue.cu`` or raises.  Both round as
PyTorch does, each bfloat16 op once from float, so their bits are equal.

Each launch adds one to ``bias_lrelu.launches``: three a forward of the
generator on the card under ``no_grad``, none under autograd.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from real_esrgan_tpu_torch.ops import _build
from real_esrgan_tpu_torch.ops.fused_rdb import lrelu

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_ROW_ELEMENTS = 1 << 30  # csrc/tail_epilogue.cu's kMaxRowElements: an input row's W x G x C
VECTOR_BYTES = 16


def bias_lrelu_plain(y: torch.Tensor, bias: torch.Tensor, shuffle: bool) -> torch.Tensor:
    """Plain PyTorch version of ``bias_lrelu``."""
    if not shuffle:
        return lrelu(y + bias.to(y.dtype)[:, None, None])
    y = lrelu(y + bias.repeat(4).to(y.dtype)[:, None, None])
    n, _, h, w = y.shape
    cout = bias.shape[0]
    y = y.reshape(n, 2, 2, cout, h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(n, cout, 2 * h, 2 * w).contiguous(memory_format=torch.channels_last)


def _check(y: torch.Tensor, bias: torch.Tensor, shuffle: bool) -> None:
    if y.dtype not in _DTYPE_CODES:
        raise TypeError(f"bias_lrelu takes float32 or bfloat16, not {y.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError(f"bias_lrelu takes a float32 bias, not {bias.dtype}")
    groups = 4 if shuffle else 1
    if y.dim() != 4 or bias.dim() != 1 or y.shape[1] != groups * bias.shape[0]:
        raise ValueError(f"bias_lrelu with shuffle={shuffle} takes y (N, {groups} C, H, W) and "
                         f"a bias of C, got {tuple(y.shape)} and {tuple(bias.shape)}")
    if bias.device != y.device:
        raise ValueError(f"bias_lrelu: y on {y.device}, bias on {bias.device}")
    if not y.is_contiguous(memory_format=torch.channels_last) or not bias.is_contiguous():
        raise ValueError("bias_lrelu needs y contiguous in channels_last and a contiguous bias")
    if y.shape[1] * y.shape[3] >= MAX_ROW_ELEMENTS:
        raise ValueError(f"bias_lrelu takes rows of W x channels under {MAX_ROW_ELEMENTS}, "
                         f"got {y.shape[3]} x {y.shape[1]}")


def _library() -> ctypes.CDLL:
    lib = _build.load("tail_epilogue")
    if lib.tail_epilogue_forward.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.tail_epilogue_forward.argtypes = [i, vp, vp, vp, ctypes.c_longlong] + [i] * 5 + [vp]
        lib.tail_epilogue_forward.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def vectorised(y: torch.Tensor, out: torch.Tensor, channels: int) -> bool:
    """Whether the kernel moves 16-byte vectors: a whole number of them in
    each run of ``channels``, and both tensors on a 16-byte boundary; else
    one element at a time."""
    return (channels * y.element_size() % VECTOR_BYTES == 0
            and y.data_ptr() % VECTOR_BYTES == 0 and out.data_ptr() % VECTOR_BYTES == 0)


def bias_lrelu(y: torch.Tensor, bias: torch.Tensor, shuffle: bool) -> torch.Tensor:
    """LeakyReLU(0.2) of ``y`` + ``bias``, pixel-shuffled x2 where
    ``shuffle`` (see the module's docstring).  A CPU tensor goes through
    ``bias_lrelu_plain``; a CUDA tensor through the kernel, which counts
    its launch, or raises.  The kernel has no backward: on a CUDA tensor
    with autograd on and ``y`` or ``bias`` requiring grad, it raises rather
    than return an output cut from the graph."""
    _check(y, bias, shuffle)
    if y.device.type == "cpu":
        return bias_lrelu_plain(y, bias, shuffle)
    if y.device.type != "cuda":
        raise ValueError(f"bias_lrelu runs on cpu or cuda, not {y.device}")
    if torch.is_grad_enabled() and (y.requires_grad or bias.requires_grad):
        raise RuntimeError("bias_lrelu: the CUDA kernel has no backward, so its output would "
                           "carry no gradient; use bias_lrelu_plain under autograd")
    n, gc, h, w = y.shape
    groups = 4 if shuffle else 1
    c = gc // groups
    out = y if not shuffle else torch.empty(
        (n, c, 2 * h, 2 * w), dtype=y.dtype, device=y.device,
        memory_format=torch.channels_last)
    if y.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.tail_epilogue_forward(_DTYPE_CODES[y.dtype], y.data_ptr(), bias.data_ptr(),
                                        out.data_ptr(), n * h, w, c, groups,
                                        int(vectorised(y, out, c)), _sms(y.device.index), stream)
    if err != 0:
        raise RuntimeError(f"tail_epilogue kernel launch failed with CUDA error {err}")
    bias_lrelu.launches += 1
    return out


bias_lrelu.launches = 0
