"""Resize operators: the port of real_esrgan_tpu/ops/resize.py.

1. ``matlab_resize``: MATLAB ``imresize`` (antialiased bicubic, symmetric
   edges).  The whole resample, weights and edge reflection included, is
   folded into two dense (out x in) matrices built in numpy; the resize is
   then two float32 matrix products.  They run in true float32 whatever
   ``torch.backends.cuda.matmul.allow_tf32`` says (``true_f32``), because
   NIQE and the LR/HR pairs of the evaluation depend on the digits TF32 drops.
2. ``resize_fixed``: static-shape nearest / bilinear / bicubic with the
   semantics of ``jax.image.resize``, as two dense products.
3. ``resize_dynamic``: the degradation's resample from a valid extent of a
   static canvas onto another canvas, in the three modes the reference draws
   from (area / bilinear / bicubic, torch semantics), as gathers along each
   axis whose taps clamp to the valid extent.  Extents are Python numbers
   (one per batch), so nothing waits for the device.
"""

from __future__ import annotations

import contextlib
import math
from typing import Tuple

import numpy as np
import torch


def reciprocal(c: float) -> float:
    """1 / c in float32.  XLA's CPU backend computes ``x / c`` for a constant
    ``c`` as ``x * (1 / c)``, which can differ from the quotient in the last
    bit; the port multiplies the same way where the JAX package divides by a
    constant, so it rounds where JAX rounds."""
    return float(np.float32(1.0) / np.float32(c))


INV_255 = reciprocal(255.0)


def correct_sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root in ``x``'s dtype, as XLA computes
    it (torch's vectorised float32 CPU ``sqrt`` is off by one bit on some
    inputs): the float64 root, rounded once."""
    return torch.sqrt(x.double()).to(x.dtype)


@contextlib.contextmanager
def true_f32():
    """float32 matrix products and convolutions inside run without TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _cubic_np(x: np.ndarray) -> np.ndarray:
    """MATLAB cubic kernel (Keys, a = -0.5)."""
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return ((1.5 * ax3 - 2.5 * ax2 + 1.0) * (ax <= 1)
            + (-0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0) * ((ax > 1) & (ax <= 2)))


def make_matlab_resize_matrix(in_length: int, out_length: int, scale: float,
                              antialias: bool = True) -> np.ndarray:
    """Dense (out_length, in_length) float32 resample matrix with MATLAB
    semantics: out-of-range taps are folded back into in-range columns by
    symmetric reflection."""
    kernel_width = 4.0
    if scale < 1 and antialias:
        kernel_width = 4.0 / scale

    x = np.arange(1, out_length + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(math.ceil(kernel_width)) + 2

    indices = left[:, None] + np.arange(p)[None, :]           # 1-based tap ids
    dist = u[:, None] - indices
    if scale < 1 and antialias:
        weights = scale * _cubic_np(dist * scale)
    else:
        weights = _cubic_np(dist)
    weights = weights / weights.sum(axis=1, keepdims=True)

    # Symmetric reflection fold: ... 2 1 | 1 2 ... n-1 n | n n-1 ...
    idx = indices.astype(np.int64)
    idx = np.where(idx < 1, 1 - idx, idx)
    idx = np.where(idx > in_length, 2 * in_length + 1 - idx, idx)
    idx = np.clip(idx, 1, in_length) - 1                      # 0-based

    mat = np.zeros((out_length, in_length), dtype=np.float64)
    rows = np.repeat(np.arange(out_length), p)
    np.add.at(mat, (rows, idx.ravel()), weights.ravel())
    return mat.astype(np.float32)


def matlab_resize(image: torch.Tensor, scale_factor: float,
                  antialias: bool = True) -> torch.Tensor:
    """MATLAB ``imresize`` of an HW, HWC or NHWC float tensor (any range), on
    the tensor's device, in float32."""
    squeeze2d = image.dim() == 2
    if squeeze2d:
        image = image[..., None]
    batched = image.dim() == 4
    if not batched:
        image = image[None]

    _, in_h, in_w, _ = image.shape
    out_h = int(math.ceil(in_h * scale_factor))
    out_w = int(math.ceil(in_w * scale_factor))
    mh = torch.from_numpy(make_matlab_resize_matrix(in_h, out_h, scale_factor, antialias))
    mw = torch.from_numpy(make_matlab_resize_matrix(in_w, out_w, scale_factor, antialias))

    with true_f32():
        out = torch.einsum("oh,bhwc->bowc", mh.to(image.device), image.float())
        out = torch.einsum("pw,bowc->bopc", mw.to(image.device), out)
    if not batched:
        out = out[0]
    if squeeze2d:
        out = out[..., 0]
    return out


# ---------------------------------------------------------------------------
# Static-shape resize (jax.image.resize semantics)
# ---------------------------------------------------------------------------

def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _fixed_weights(in_size: int, out_size: int, method: str, antialias: bool) -> np.ndarray:
    """(out, in) float32 weights of ``jax.image.resize`` along one axis."""
    if method == "nearest":
        offsets = np.floor((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
                           * np.float32(in_size) / np.float32(out_size)).astype(np.int64)
        mat = np.zeros((out_size, in_size), np.float32)
        mat[np.arange(out_size), offsets] = 1.0
        return mat
    kernel = {"linear": _triangle, "bilinear": _triangle,
              "cubic": _keys_cubic, "bicubic": _keys_cubic}[method]
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    weights = kernel(np.abs(sample[:, None] - np.arange(in_size)[None, :]) / kernel_scale)
    total = weights.sum(axis=1, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[:, None], weights, 0.0).astype(np.float32)


def resize_fixed(image: torch.Tensor, out_hw: Tuple[int, int], method: str,
                 antialias: bool = False) -> torch.Tensor:
    """Static-shape NHWC resize (nearest/bilinear/bicubic), as
    ``jax.image.resize``: half-pixel centres, Keys cubic (a = -0.5), taps
    outside the image dropped and the rest renormalised."""
    _, h, w, _ = image.shape
    out = image.float()
    with true_f32():
        if out_hw[0] != h:
            mh = torch.from_numpy(_fixed_weights(h, out_hw[0], method, antialias))
            out = torch.einsum("oh,bhwc->bowc", mh.to(image.device), out)
        if out_hw[1] != w:
            mw = torch.from_numpy(_fixed_weights(w, out_hw[1], method, antialias))
            out = torch.einsum("pw,bowc->bopc", mw.to(image.device), out)
    return out


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 upsample, NHWC."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


# ---------------------------------------------------------------------------
# Dynamic-extent resample on static canvases
# ---------------------------------------------------------------------------

METHOD_AREA, METHOD_BILINEAR, METHOD_BICUBIC = 0, 1, 2
_SCAN_BLOCK = 16


def _ratio(n_in, n_out, reciprocal_out: bool = False) -> float:
    """n_in / n_out in float32, as the JAX package divides its float32
    extents; with ``reciprocal_out``, n_in * (1 / n_out), as XLA computes the
    quotient when n_out is a constant of the program (``reciprocal``)."""
    if reciprocal_out:
        return float(np.float32(n_in) * np.float32(reciprocal(n_out)))
    return float(np.float32(n_in) / np.float32(n_out))


def _take(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    return x.index_select(axis, idx)


def _along(w: torch.Tensor, x: torch.Tensor, axis: int) -> torch.Tensor:
    """A per-position vector shaped to broadcast along ``axis`` of ``x``."""
    return w.reshape((-1,) + (1,) * (x.dim() - axis - 1))


def _axis_linear(x: torch.Tensor, n_in, n_out, out_size: int, axis: int,
                 reciprocal_out: bool = False) -> torch.Tensor:
    """torch bilinear (align_corners=False) along one axis."""
    i = torch.arange(out_size, dtype=torch.float32, device=x.device)
    u = (i + 0.5) * _ratio(n_in, n_out, reciprocal_out) - 0.5
    u = torch.clamp(u, min=0.0)                   # torch clamps negative src
    i0 = torch.floor(u)
    w = _along(u - i0, x, axis)
    i0 = i0.long()
    lo = torch.clamp(i0, 0, int(n_in) - 1)
    hi = torch.clamp(i0 + 1, 0, int(n_in) - 1)
    return _take(x, lo, axis) * (1.0 - w) + _take(x, hi, axis) * w


def _cubic_torch(d: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    ad = torch.abs(d)
    ad2, ad3 = ad * ad, ad * ad * ad
    w1 = (a + 2.0) * ad3 - (a + 3.0) * ad2 + 1.0
    w2 = a * ad3 - 5.0 * a * ad2 + 8.0 * a * ad - 4.0 * a
    return torch.where(ad <= 1.0, w1, torch.where(ad < 2.0, w2, torch.zeros_like(ad)))


def _axis_cubic(x: torch.Tensor, n_in, n_out, out_size: int, axis: int,
                reciprocal_out: bool = False) -> torch.Tensor:
    """torch bicubic (align_corners=False, a=-0.75) along one axis."""
    i = torch.arange(out_size, dtype=torch.float32, device=x.device)
    u = (i + 0.5) * _ratio(n_in, n_out, reciprocal_out) - 0.5
    i0 = torch.floor(u).long()
    out = None
    for t in range(-1, 3):
        tap = i0 + t
        w = _along(_cubic_torch(u - tap.float()), x, axis)
        v = _take(x, torch.clamp(tap, 0, int(n_in) - 1), axis) * w
        out = v if out is None else out + v
    return out


def _scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sum along axis 0 in the order XLA's CPU
    backend sums ``jnp.cumsum``: blocks of 16 summed left to right, the block
    totals scanned the same way recursively and added to every later block.
    The same elementwise adds on every device give the same sums, where
    ``torch.cumsum`` sums in float64 on the CPU and in its own order on CUDA."""
    n = x.shape[0]
    if n <= _SCAN_BLOCK:
        rows = [x[0]]
        for k in range(1, n):
            rows.append(rows[-1] + x[k])
        return torch.stack(rows)
    blocks = -(-n // _SCAN_BLOCK)
    padded = torch.cat([x, x.new_zeros((blocks * _SCAN_BLOCK - n,) + x.shape[1:])])
    inner = _scan(padded.reshape((blocks, _SCAN_BLOCK) + x.shape[1:]).transpose(0, 1))
    inner = inner.transpose(0, 1)                                 # (blocks, 16, ...)
    before = _scan(inner[:, -1])[:-1]                             # totals of earlier blocks
    inner = torch.cat([inner[:1], inner[1:] + before[:, None]])
    return inner.reshape((blocks * _SCAN_BLOCK,) + x.shape[1:])[:n]


def cumsum_f32(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``jnp.cumsum(x, axis)`` in float32, summed as XLA's CPU backend does."""
    return _scan(x.float().movedim(axis, 0)).movedim(0, axis)


def _axis_area(x: torch.Tensor, n_in, n_out, out_size: int, axis: int,
               reciprocal_out: bool = False) -> torch.Tensor:
    """torch 'area' (adaptive average pool) along one axis via a prefix sum:
    integer windows [floor(i*in/out), ceil((i+1)*in/out)), evaluated with two
    gathers."""
    csum = cumsum_f32(x, axis)
    zero_shape = list(x.shape)
    zero_shape[axis] = 1
    csum = torch.cat([csum.new_zeros(zero_shape), csum], dim=axis)
    i = torch.arange(out_size, dtype=torch.float32, device=x.device)
    ratio = _ratio(n_in, n_out, reciprocal_out)
    n_in_i = int(n_in)
    # rows beyond the valid output extent replicate the last valid input row
    # (start clamped to n_in-1, not n_in) so downstream full-canvas consumers
    # (e.g. the second blur) never blend in zeros
    start = torch.clamp(torch.floor(i * ratio).long(), 0, n_in_i - 1)
    end = torch.minimum(torch.maximum(torch.ceil((i + 1.0) * ratio).long(), start + 1),
                        torch.full_like(start, n_in_i))
    count = _along(torch.clamp(end - start, min=1).float(), x, axis)
    out = (_take(csum, end, axis) - _take(csum, start, axis)) / count
    return out.to(x.dtype)


_AXIS_FNS = (_axis_area, _axis_linear, _axis_cubic)


def resize_dynamic_static_method(image: torch.Tensor, in_extent, out_extent,
                                 out_canvas: Tuple[int, int], method: int,
                                 reciprocal_out: bool = False) -> torch.Tensor:
    """Resample the valid region ``[:h_in, :w_in]`` of an HWC or NHWC canvas
    to ``[:h_out, :w_out]`` of an ``out_canvas``-sized one.

    ``in_extent``/``out_extent`` are (h, w) numbers, ``method`` 0 area, 1
    bilinear, 2 bicubic.  Taps clamp into the valid region, which also gives
    the edge-replicate behaviour torch uses at image borders; rows and
    columns beyond ``out_extent`` hold edge-replicated values.  Later resizes
    clamp their taps to the propagated extent, but filter2d (reflect-pads at
    the canvas edge) and diff_jpeg (8x8 blocks straddling the extent) do not:
    pixels within about a kernel radius of the valid region's right and
    bottom edges see edge-replicated context (the degradation's boundary
    band).  ``reciprocal_out`` takes the scale as in_extent * (1 / out_extent),
    as XLA computes it where the JAX program's output extent is a constant
    (the degradation's final resize to the LR size)."""
    h2, w2 = out_canvas
    axis = image.dim() - 3
    fn = _AXIS_FNS[method]
    y = fn(image, in_extent[0], out_extent[0], h2, axis, reciprocal_out)
    return fn(y, in_extent[1], out_extent[1], w2, axis + 1, reciprocal_out)


def resize_dynamic(image: torch.Tensor, in_extent, out_extent,
                   out_canvas: Tuple[int, int], method_idx: int) -> torch.Tensor:
    """``resize_dynamic_static_method`` with the method as an index, the
    port of the JAX package's ``lax.switch`` over the three modes."""
    return resize_dynamic_static_method(image, in_extent, out_extent, out_canvas,
                                        int(method_idx))
