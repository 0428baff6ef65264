"""Unsharp-mask sharpening with a soft threshold mask: the port of
real_esrgan_tpu/ops/usm.py.

A Gaussian is separable and the kernel and image sizes are fixed, so each
1-D pass, taps and reflect-101 padding included, is folded into a dense
(N, N) matrix built in numpy: the blur is two matrix products.  The JAX
package takes them in float32 at HIGHEST precision; the port takes them in
float64 and rounds the result to float32 once, so TF32 cannot reach them and
the card and the CPU give the same bits (the sharpening mask thresholds the
blurred residual).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def gaussian_kernel_1d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """cv2.getGaussianKernel clone (sigma<=0 -> cv2's size-derived sigma)."""
    if ksize % 2 == 0:
        ksize += 1
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _blur_matrix(n: int, kernel_bytes: bytes) -> np.ndarray:
    """Dense (n, n) matrix of a 1-D correlation with reflect-101 padding
    (cv2 BORDER_REFLECT_101) folded into the columns."""
    kernel = np.frombuffer(kernel_bytes, dtype=np.float32)
    k = kernel.shape[0]
    pad = k // 2
    rows = np.repeat(np.arange(n), k)
    cols = (np.arange(n)[:, None] + np.arange(k)[None, :] - pad).ravel()
    # reflect-101 with arbitrary bounce count: fold into the period 2(n-1)
    if n > 1:
        cols = np.abs(cols) % (2 * n - 2)
        cols = np.where(cols > n - 1, 2 * n - 2 - cols, cols)
    else:
        cols = np.zeros_like(cols)
    mat = np.zeros((n, n), dtype=np.float32)
    np.add.at(mat, (rows, cols), np.tile(kernel, n))
    return mat


@functools.lru_cache(maxsize=32)
def _blur_matrix_on(n: int, kernel_bytes: bytes, device: torch.device) -> torch.Tensor:
    """``_blur_matrix`` in float64 on ``device``, copied there once: a copy
    from the host waits for the device's queue."""
    return torch.from_numpy(_blur_matrix(n, kernel_bytes)).to(device, torch.float64)


def gaussian_blur_dense(image: torch.Tensor, kernel_1d) -> torch.Tensor:
    """Separable blur of NHWC images as two dense products, in float64,
    rounded once to the image's dtype."""
    _, h, w, _ = image.shape
    kb = np.asarray(kernel_1d, np.float32).tobytes()
    mh = _blur_matrix_on(h, kb, image.device)
    mw = _blur_matrix_on(w, kb, image.device)
    out = torch.einsum("oh,bhwc->bowc", mh, image.double())
    return torch.einsum("pw,bowc->bopc", mw, out).to(image.dtype)


def usm_sharpen(image: torch.Tensor, kernel_1d, weight: float = 0.5,
                threshold: float = 10.0) -> torch.Tensor:
    """Sharpen NHWC images in [0, 1].

    out = soft_mask * clip(x + weight * residual) + (1 - soft_mask) * x where
    residual = x - gaussian_blur(x) and soft_mask = blur(|residual|*255 > thr).
    """
    blur = gaussian_blur_dense(image, kernel_1d)
    residual = image - blur
    mask = (torch.abs(residual) * 255.0 > threshold).to(image.dtype)
    soft_mask = gaussian_blur_dense(mask, kernel_1d)
    sharp = torch.clamp(image + weight * residual, 0.0, 1.0)
    return soft_mask * sharp + (1.0 - soft_mask) * image
