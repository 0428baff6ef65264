"""Host-side numpy twins of the degradation ops, for offline data inspection:
the port of real_esrgan_tpu/ops/host.py, with numpy and scipy only.

The production path is the batched pipeline (ops/degradation.py); these
single-image functions exist for poking at data in a notebook or a prep
script, as the reference's numpy functions do.  Blur-kernel sampling
evaluates the pipeline's own synthesizer on the CPU, so the two cannot
drift apart.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from scipy import ndimage

from real_esrgan_tpu_torch.configuration import KernelSynthesisConfig
from real_esrgan_tpu_torch.ops.blur_kernels import (
    random_first_order_kernel, random_second_order_kernel,
)
from real_esrgan_tpu_torch.ops.usm import gaussian_kernel_1d

# ITU-R 601-2 luma, as cv2.COLOR_RGB2GRAY
_GRAY = np.array([0.299, 0.587, 0.114], np.float32)


def add_gaussian_noise_np(image: np.ndarray, sigma: float, gray_noise: bool = False,
                          rng: Optional[np.random.Generator] = None,
                          clip: bool = True, rounds: bool = False) -> np.ndarray:
    """The reference's ``_generate_gaussian_noise`` + add.

    image: (H, W, 3) float32 in [0, 1]; sigma in 255-range units.
    """
    rng = rng or np.random.default_rng()
    if gray_noise:
        noise = rng.standard_normal(image.shape[:2] + (1,)).astype(np.float32)
    else:
        noise = rng.standard_normal(image.shape).astype(np.float32)
    out = image + noise * (sigma / 255.0)
    return _finalize_np(out, clip, rounds)


def add_poisson_noise_np(image: np.ndarray, scale: float = 1.0, gray_noise: bool = False,
                         rng: Optional[np.random.Generator] = None,
                         clip: bool = True, rounds: bool = False) -> np.ndarray:
    """The reference's ``_generate_poisson_noise`` + add: quantize to 8
    bits, vals = 2**ceil(log2(#unique levels)), draw
    Poisson(img * vals) / vals - img, scale."""
    rng = rng or np.random.default_rng()
    base = (image @ _GRAY)[..., None] if gray_noise else image
    img_q = np.clip(np.round(base * 255.0), 0, 255) / 255.0
    vals = 2.0 ** np.ceil(np.log2(max(len(np.unique(img_q)), 1)))
    noise = (rng.poisson(img_q * vals) / vals - img_q) * scale
    return _finalize_np(image + noise.astype(np.float32), clip, rounds)


def filter2d_np(image: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """cv2.filter2D with the reference's reflect-101 border: a correlation,
    the same kernel on every channel (scipy's ``mirror`` is reflect-101)."""
    kernel = np.asarray(kernel, np.float64)
    if image.ndim == 3:
        kernel = kernel[:, :, None]
    return ndimage.correlate(image, kernel, mode="mirror").astype(image.dtype)


def usm_sharpen_np(image: np.ndarray, ksize: int = 51, weight: float = 0.5,
                   threshold: float = 10.0) -> np.ndarray:
    """The reference's ``usm_sharp`` numpy twin."""
    k1d = gaussian_kernel_1d(ksize, 0.0)

    def blur(x):
        x = ndimage.correlate1d(x, k1d, axis=0, mode="mirror")
        return ndimage.correlate1d(x, k1d, axis=1, mode="mirror")

    blurred = blur(image)
    residual = image - blurred
    mask = (np.abs(residual) * 255.0 > threshold).astype(np.float32)
    soft = blur(mask)
    sharp = np.clip(image + weight * residual, 0.0, 1.0)
    return soft * sharp + (1.0 - soft) * image


def sample_blur_kernel_np(seed: int, stage: int = 1, kcfg=None) -> np.ndarray:
    """One random degradation blur kernel as numpy (pad_to x pad_to, sums to
    1): the pipeline's synthesizer evaluated on the CPU."""
    kcfg = kcfg or KernelSynthesisConfig()
    fn = random_first_order_kernel if stage == 1 else random_second_order_kernel
    return fn(torch.Generator().manual_seed(seed), kcfg)[0].numpy()


def _finalize_np(out: np.ndarray, clip: bool, rounds: bool) -> np.ndarray:
    if clip and rounds:
        return np.clip(np.round(out * 255.0), 0, 255).astype(np.float32) / 255.0
    if clip:
        return np.clip(out, 0.0, 1.0)
    if rounds:
        return np.round(out * 255.0).astype(np.float32) / 255.0
    return out
