"""MATLAB ``imresize`` (antialiased bicubic, symmetric edges): the port of
``matlab_resize`` in real_esrgan_tpu/ops/resize.py.

The whole resample, weights and edge reflection included, is folded into two
dense (out x in) matrices built in numpy; the resize is then two float32
matrix products.  They run in true float32 whatever
``torch.backends.cuda.matmul.allow_tf32`` says (``true_f32``), because NIQE
and the LR/HR pairs of the evaluation depend on the digits TF32 drops.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch


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
