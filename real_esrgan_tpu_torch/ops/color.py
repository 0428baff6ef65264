"""Color-space conversions (BT.601), NHWC: the port of
real_esrgan_tpu/ops/color.py.

Float images in [0, 1], channels last.  The JAX package takes the colour
products in float32; the port takes them in float64 and rounds each result
once, so TF32 cannot reach them and the card and the CPU give the same bits
(the Poisson noise quantizes the luma to 8-bit levels).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from real_esrgan_tpu_torch.ops.resize import INV_255

# MATLAB rgb2ycbcr coefficients (x255 domain), BT.601.
_RGB2Y = np.array([65.481, 128.553, 24.966], np.float32)
_RGB2YCBCR = np.array([
    [65.481, -37.797, 112.0],
    [128.553, -74.203, -93.786],
    [24.966, 112.0, -18.214],
], np.float32)
_YCBCR_BIAS = np.array([16.0, 128.0, 128.0], np.float32)

_YCBCR2RGB = np.array([
    [0.00456621, 0.00456621, 0.00456621],
    [0.0, -0.00153632, 0.00791071],
    [0.00625893, -0.00318811, 0.0],
], np.float32)
_YCBCR2RGB_BIAS = np.array([-222.921, 135.576, -276.836], np.float32)

# ITU-R 601-2 luma (torchvision rgb_to_grayscale; Poisson gray noise)
_GRAY = np.array([0.299, 0.587, 0.114], np.float32)


_TABLES = {"rgb2y": _RGB2Y, "rgb2ycbcr": _RGB2YCBCR, "ycbcr_bias": _YCBCR_BIAS,
           "ycbcr2rgb": _YCBCR2RGB, "ycbcr2rgb_bias": _YCBCR2RGB_BIAS, "gray": _GRAY}


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> dict:
    """The tables in float64 on ``device``, copied there once: a copy from
    the host waits for the device's queue."""
    return {name: torch.from_numpy(table).to(device, torch.float64)
            for name, table in _TABLES.items()}


def _const(name: str, like: torch.Tensor) -> torch.Tensor:
    return _tables(like.device)[name].to(like.dtype)


def _product(image: torch.Tensor, matrix: str) -> torch.Tensor:
    """image @ table in float64, rounded once to the image's dtype."""
    return (image.double() @ _tables(image.device)[matrix]).to(image.dtype)


def rgb2ycbcr(image: torch.Tensor, only_y: bool = False) -> torch.Tensor:
    """MATLAB ``rgb2ycbcr`` on [0,1] float images, channels last."""
    if only_y:
        out = (_product(image, "rgb2y") + 16.0)[..., None]
    else:
        out = _product(image, "rgb2ycbcr") + _const("ycbcr_bias", image)
    return out * INV_255


def bgr2ycbcr(image: torch.Tensor, only_y: bool = False) -> torch.Tensor:
    """MATLAB ``bgr2ycbcr`` (BGR channel order input)."""
    return rgb2ycbcr(image.flip(-1), only_y)


def ycbcr2rgb(image: torch.Tensor) -> torch.Tensor:
    x = image * 255.0
    out = _product(x, "ycbcr2rgb") * 255.0 + _const("ycbcr2rgb_bias", image)
    return out * INV_255


def ycbcr2bgr(image: torch.Tensor) -> torch.Tensor:
    return ycbcr2rgb(image).flip(-1)


def rgb_to_grayscale(image: torch.Tensor) -> torch.Tensor:
    """ITU-R 601-2 luma transform, keeps a singleton channel axis."""
    return _product(image, "gray")[..., None]


def expand_y(image_uint8_bgr) -> np.ndarray:
    """BGR uint8 (H, W, C) -> float64 Y channel in [0, 255], shape (H, W, 1).

    Host-side, for the Y-channel metrics."""
    img = np.asarray(image_uint8_bgr).astype(np.float32) / 255.0
    y = img @ np.array([24.966, 128.553, 65.481]) + 16.0
    return (y / 255.0)[..., None].astype(np.float64) * 255.0
