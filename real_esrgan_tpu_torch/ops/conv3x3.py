"""One 'same' 3x3 convolution, NHWC bfloat16: the port of
tools/pallas_conv_exp.py::pallas_conv.

``conv3x3`` launches the hand-written CUDA kernel ``csrc/conv3x3.cu``, an
implicit GEMM on the tensor cores with f32 accumulation and one rounding to
bfloat16.  It is the building block of a per-source variant of the fused RDB
and the subject of the experiment tool ``tools/conv_exp.py``.

``conv3x3_plain`` is the same function in plain PyTorch.  ``conv3x3`` takes
it only for a tensor on the CPU; on a CUDA tensor it launches the kernel or
raises.

Modes split the kernel's time between its steps:

* ``full``: the convolution.
* ``dots``: the weights are loaded and the products and the store run, but
  the input window is not staged in shared memory.  The values are
  undefined (as they are in the TPU kernel, which multiplies an unwritten
  scratch buffer); the plain version returns zeros, and only the shape is
  comparable.
* ``patch``: only the staging.  Returns the first ``Cout`` columns of the
  dy = 0 patch row ``[x(y-1, x-1), x(y-1, x), x(y-1, x+1)]`` (zero outside
  the image), which needs ``Cout <= 3 Cin``.  The CUDA kernel builds no
  patch matrix, so this times what it has in its place: staging the input
  window in shared memory and copying out of it.
* ``dma``: all loads (weights and input windows) and a store of zeros.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from real_esrgan_tpu_torch.ops import _build
from real_esrgan_tpu_torch.ops.resize import true_f32

MODES = ("full", "dots", "patch", "dma")
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on sm_90
KERNEL_ROWS = 8       # output rows of one sub-tile in csrc/conv3x3.cu
FRAGMENTS = (3, 1)    # column fragments a warp the kernel is built for, widest first


def conv3x3_smem_bytes(cin: int, nf: int) -> int:
    """Shared memory of one block, as csrc/conv3x3.cu lays it out: the
    (9 Cin, 32 nf + 8) weight slice and two 10 x 18 x (Cin + 8) input
    windows."""
    return 2 * (9 * cin * (32 * nf + 8) + 2 * 10 * 18 * (cin + 8))


def _column_fragments(cin: int, cout: int) -> int:
    """Column fragments of one warp: the widest Cout slice the kernel is
    built for (32 nf channels a block) that divides Cout and fits shared
    memory."""
    for nf in FRAGMENTS:
        if cout % (32 * nf) == 0 and conv3x3_smem_bytes(cin, nf) <= SMEM_LIMIT:
            return nf
    raise ValueError(f"conv3x3: no weight slice of Cin={cin}, Cout={cout} fits a block's "
                     f"{SMEM_LIMIT} bytes of shared memory")


def _check(x: torch.Tensor, w: torch.Tensor, tile: int, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"conv3x3 mode must be one of {MODES}, not {mode!r}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"conv3x3 takes a bfloat16 input, not {x.dtype}")
    if w.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv3x3 takes bfloat16 or float32 weights, not {w.dtype}")
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[-1]):
        raise ValueError(f"conv3x3 takes x (B, H, W, Cin) and w (3, 3, Cin, Cout), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError(f"conv3x3: x on {x.device}, w on {w.device}")
    _, h, width, cin = x.shape
    cout = w.shape[-1]
    if tile <= 0 or tile % KERNEL_ROWS or h % tile:
        raise ValueError(f"conv3x3 needs tile % {KERNEL_ROWS} == 0 and H % tile == 0, "
                         f"got H={h}, tile={tile}")
    if width % 16:
        raise ValueError(f"conv3x3 needs W % 16 == 0, got W={width}")
    if cin % 16 or cout % 32:
        raise ValueError(f"conv3x3 needs Cin % 16 == 0 and Cout % 32 == 0, got {cin} -> {cout}")
    if mode == "patch" and cout > 3 * cin:
        raise ValueError(f"conv3x3 mode 'patch' needs Cout <= 3 Cin, got {cin} -> {cout}")
    if not x.is_contiguous() or not w.is_contiguous():
        raise ValueError("conv3x3 needs contiguous NHWC x and HWIO w")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("conv3x3 needs x and w on a 16-byte boundary")
    _column_fragments(cin, cout)


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, mode: str = "full") -> torch.Tensor:
    """Plain PyTorch version of ``conv3x3``: bfloat16-rounded operands, a
    true-float32 convolution, one rounding to bfloat16."""
    b, h, width, cin = x.shape
    cout = w.shape[-1]
    if mode in ("dots", "dma"):
        return torch.zeros(b, h, width, cout, dtype=torch.bfloat16, device=x.device)
    if mode == "patch":
        xp = F.pad(x, (0, 0, 1, 1, 1, 1))  # one zero pixel around H and W
        bands = [xp[:, 0:h, dx:dx + width, :] for dx in range(3)]
        return torch.cat(bands, dim=-1)[..., :cout].contiguous()
    weight = w.to(torch.bfloat16).float().permute(3, 2, 0, 1)  # HWIO -> OIHW
    with true_f32():
        out = F.conv2d(x.float().permute(0, 3, 1, 2), weight, padding=1)
    return out.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()


def _library() -> ctypes.CDLL:
    lib = _build.load("conv3x3")
    if lib.conv3x3_forward.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.conv3x3_forward.argtypes = [vp, vp, vp] + [i] * 8 + [vp]
        lib.conv3x3_forward.restype = i
    return lib


def conv3x3(x: torch.Tensor, w: torch.Tensor, tile: int = 32, mode: str = "full") -> torch.Tensor:
    """'same' 3x3 convolution of NHWC bfloat16 ``x`` (B, H, W, Cin) with
    ``w`` (3, 3, Cin, Cout) -> (B, H, W, Cout) bfloat16.

    ``tile`` is the number of image rows one block walks down, 8 rows at a
    time, with its slice of the weights held in shared memory: a larger tile
    loads the weights fewer times and leaves fewer blocks.  It must divide H
    and be a multiple of 8; W must be a multiple of 16, Cin of 16, Cout of
    32.  A CPU tensor goes through ``conv3x3_plain``; a CUDA tensor through
    the kernel, which adds one to ``conv3x3.launches``.
    """
    _check(x, w, tile, mode)
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, mode)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3 runs on cpu or cuda, not {x.device}")
    lib = _library()
    b, h, width, cin = x.shape
    cout = w.shape[-1]
    weight = w.to(torch.bfloat16)
    out = torch.empty(b, h, width, cout, dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv3x3_forward(x.data_ptr(), weight.data_ptr(), out.data_ptr(), b, h, width,
                                  cin, cout, tile, MODES.index(mode),
                                  _column_fragments(cin, cout), stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed with CUDA error {err}")
    conv3x3.launches += 1
    return out


conv3x3.launches = 0
