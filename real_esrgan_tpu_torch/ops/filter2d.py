"""Batched 2-D filtering with per-sample kernels (cv2.filter2D semantics):
the port of real_esrgan_tpu/ops/filter2d.py.

Reflect-101 padding, correlation (no kernel flip), the same kernel on every
channel of a sample, optionally a distinct kernel per sample.  Layout is NHWC
at the interface; the filter is one depthwise ``F.conv2d`` over a
(1, B*C, H, W) view, so the batch is one convolution.

``compute_dtype=torch.bfloat16`` rounds where the JAX package's bf16 filter
rounds as XLA compiles it: the image and the kernel to bf16, then, with
per-sample kernels, one rounding of the sum to bf16, returned in the
input's dtype.  With one kernel for the batch, XLA's CPU backend drops that
last rounding (the conversion to bf16 and back meet and cancel), so the sum
is returned unrounded.  The products of bf16 operands are
exact; their sum is taken in float64, so the one rounding does not depend on
the order in which a device sums (cuDNN's and the CPU's float32 orders flip
about one bf16 rounding in 1e5, and a flipped pixel can flip a JPEG
coefficient downstream).  The float32 filter convolves in true float32
(``true_f32``), whatever the TF32 flags say.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from real_esrgan_tpu_torch.ops.resize import true_f32


def _depthwise(x_nchw: torch.Tensor, weight: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Depthwise 'valid' correlation of reflect-padded NCHW planes with one
    (kh, kw) kernel a plane, in ``dtype`` (float32 in true float32)."""
    with true_f32():
        return F.conv2d(x_nchw.to(dtype), weight.to(dtype)[:, None], groups=x_nchw.shape[1])


def filter2d(image: torch.Tensor, kernel: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Filter a batch of NHWC images.

    Args:
        image: (B, H, W, C) float tensor.
        kernel: (k, k) shared kernel or (B, k, k) per-sample kernels, k odd.
        compute_dtype: optional lower-precision type (bf16 for the
            degradation blurs); the output keeps the input's dtype.

    Returns:
        (B, H, W, C), reflect-101 padded at the edges.
    """
    in_dtype = image.dtype
    if compute_dtype is not None:
        image = image.to(compute_dtype)
        kernel = kernel.to(compute_dtype)
    if kernel.dim() == 2:
        kernel = kernel[None]
    b, h, w, c = image.shape
    k = kernel.shape[-1]
    if k % 2 != 1:
        raise ValueError("Kernel size must be odd.")
    pad = k // 2

    planes = image.permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    planes = F.pad(planes, (pad, pad, pad, pad), mode="reflect")
    weight = kernel.expand(b, k, k) if kernel.shape[0] == 1 else kernel
    weight = weight.repeat_interleave(c, dim=0)                    # (B*C, k, k)
    if compute_dtype is None:
        out = _depthwise(planes, weight)
    elif kernel.shape[0] == 1:
        out = _depthwise(planes, weight, torch.float64).float()
    else:
        out = _depthwise(planes, weight, torch.float64).to(compute_dtype)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1).to(in_dtype)


def filter2d_separable(image: torch.Tensor, kernel_1d: torch.Tensor) -> torch.Tensor:
    """Separable filtering with a shared 1-D kernel (two depthwise passes),
    for Gaussian blurs whose 2-D kernel is an outer product."""
    b, h, w, c = image.shape
    k = kernel_1d.shape[0]
    pad = k // 2
    planes = image.permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    kernel_1d = kernel_1d.to(image.dtype)
    x = F.pad(planes, (0, 0, pad, pad), mode="reflect")
    x = _depthwise(x, kernel_1d[None, :, None].expand(b * c, k, 1))
    x = F.pad(x, (pad, pad, 0, 0), mode="reflect")
    x = _depthwise(x, kernel_1d[None, None, :].expand(b * c, 1, k))
    return x.reshape(b, c, h, w).permute(0, 2, 3, 1).to(image.dtype)
