"""Differentiable JPEG compression, NHWC, batched with per-sample quality:
the port of real_esrgan_tpu/ops/diffjpeg.py.

The 8x8 DCT and inverse DCT are (num_blocks, 64) x (64, 64) products; the
rest is reshapes and elementwise math.  The JAX package takes the products
(and the 3x3 colour transforms) in float32 at HIGHEST precision; the port
takes them in float64 and rounds each result to float32 once, so TF32 cannot
reach them and the card and the CPU round every coefficient alike before it
is quantized.

Semantics, as the reference DiffJPEG:
  * the quality -> factor mapping, with q = 100 rescued from factor 0;
  * the standard luma and chroma quantization tables;
  * 4:2:0 chroma: 2x2 average pooling, nearest (repeat) upsampling;
  * zero padding to a multiple of 16, cropped back;
  * hard rounding or the differentiable surrogate round(x) + (x - round(x))^3.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch
import torch.nn.functional as F

from real_esrgan_tpu_torch.ops.resize import INV_255, reciprocal

# Standard JPEG quantization tables (flattened row-major over (x, y)).
_Y_TABLE = np.array(
    [[16, 11, 10, 16, 24, 40, 51, 61],
     [12, 12, 14, 19, 26, 58, 60, 55],
     [14, 13, 16, 24, 40, 57, 69, 56],
     [14, 17, 22, 29, 51, 87, 80, 62],
     [18, 22, 37, 56, 68, 109, 103, 77],
     [24, 35, 55, 64, 81, 104, 113, 92],
     [49, 64, 78, 87, 103, 121, 120, 101],
     [72, 92, 95, 98, 112, 100, 103, 99]], dtype=np.float32)

_C_TABLE = np.full((8, 8), 99.0, dtype=np.float32)
_C_TABLE[:4, :4] = np.array(
    [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]],
    dtype=np.float32)


def _dct_matrix() -> np.ndarray:
    """(64, 64) forward DCT: blocks(x*8+y) @ D -> coeffs(u*8+v), scaled."""
    d = np.zeros((64, 64), dtype=np.float32)
    for x, y, u, v in itertools.product(range(8), repeat=4):
        d[x * 8 + y, u * 8 + v] = (
            np.cos((2 * x + 1) * u * np.pi / 16) * np.cos((2 * y + 1) * v * np.pi / 16))
    alpha = np.array([1.0 / np.sqrt(2)] + [1.0] * 7, dtype=np.float32)
    scale = (np.outer(alpha, alpha) * 0.25).reshape(64)
    return d * scale[None, :]


def _idct_matrix() -> np.ndarray:
    """(64, 64) inverse DCT: (coeffs * alpha) @ Di * 0.25 -> pixels."""
    di = np.zeros((64, 64), dtype=np.float32)
    for x, y, u, v in itertools.product(range(8), repeat=4):
        di[u * 8 + v, x * 8 + y] = (
            np.cos((2 * x + 1) * u * np.pi / 16) * np.cos((2 * y + 1) * v * np.pi / 16))
    return di * 0.25


_ALPHA = (
    np.outer(np.array([1.0 / np.sqrt(2)] + [1.0] * 7),
             np.array([1.0 / np.sqrt(2)] + [1.0] * 7)).reshape(64).astype(np.float32))

_RGB2YCBCR = np.array(
    [[0.299, 0.587, 0.114],
     [-0.168736, -0.331264, 0.5],
     [0.5, -0.418688, -0.081312]], dtype=np.float32).T
_YCBCR_SHIFT = np.array([0.0, 128.0, 128.0], dtype=np.float32)
_YCBCR2RGB = np.array(
    [[1.0, 0.0, 1.402],
     [1.0, -0.344136, -0.714136],
     [1.0, 1.772, 0.0]], dtype=np.float32).T


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> dict:
    """The tables (float32) and the transforms of the products (float64) on
    ``device``, copied there once: a copy from the host waits for the
    device's queue."""
    tables = {"alpha": _ALPHA, "y_table": _Y_TABLE.reshape(64), "c_table": _C_TABLE.reshape(64),
              "rgb_shift": np.array([0.0, -128.0, -128.0], dtype=np.float32)}
    products = {"dct": _dct_matrix(), "idct": _idct_matrix(), "rgb2ycbcr": _RGB2YCBCR,
                "ycbcr_shift": _YCBCR_SHIFT, "ycbcr2rgb": _YCBCR2RGB}
    out = {name: torch.from_numpy(np.ascontiguousarray(a)).to(device) for name, a in tables.items()}
    out.update({name: torch.from_numpy(np.ascontiguousarray(a)).to(device, torch.float64)
                for name, a in products.items()})
    return out


def _product(x: torch.Tensor, matrix: torch.Tensor, shift=None) -> torch.Tensor:
    """x @ matrix (+ shift) in float64, rounded once to float32."""
    out = x.double() @ matrix
    return (out if shift is None else out + shift).float()


def _pool2x2(plane: torch.Tensor) -> torch.Tensor:
    """Mean of each 2x2 block of (B, H, W, C) planes, summed in one fixed
    order, as XLA sums it."""
    b, h, w, c = plane.shape
    x = plane.reshape(b, h // 2, 2, w // 2, 2, c)
    total = x[:, :, 0, :, 0] + x[:, :, 0, :, 1] + x[:, :, 1, :, 0] + x[:, :, 1, :, 1]
    return total * 0.25


def quality_to_factor(quality: torch.Tensor) -> torch.Tensor:
    """JPEG quality in (0, 100] -> quantization scale factor.

    q == 100 maps to factor 0 in the raw formula (division by zero in the
    quantizer); only that degenerate factor <= 0 is clamped to a tiny
    positive factor, so q = 100 is effectively lossless instead of NaN.
    """
    q = torch.as_tensor(quality, dtype=torch.float32)
    factor = torch.where(q < 50.0, 5000.0 / q, 200.0 - q * 2.0) * reciprocal(100.0)
    return torch.where(factor <= 0.0, torch.full_like(factor, 0.005), factor)


def _hard_round(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x)


def _diff_round(x: torch.Tensor) -> torch.Tensor:
    r = torch.round(x)
    return r + (x - r) ** 3


def _to_blocks(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> (B, H/8 * W/8, 64) row-major 8x8 blocks."""
    b, h, w = x.shape
    x = x.reshape(b, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)
    return x.reshape(b, (h // 8) * (w // 8), 64)


def _from_blocks(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b = x.shape[0]
    x = x.reshape(b, h // 8, w // 8, 8, 8).permute(0, 1, 3, 2, 4)
    return x.reshape(b, h, w)


def diff_jpeg(image: torch.Tensor, quality, differentiable: bool = False) -> torch.Tensor:
    """JPEG-compress-decompress a batch of NHWC RGB images in [0, 1].

    Args:
        image: (B, H, W, 3) float in [0, 1].
        quality: a number or a (B,) tensor of qualities in (0, 100].
        differentiable: the cubic rounding surrogate (the trainers use hard
            rounding).
    """
    rnd = _diff_round if differentiable else _hard_round
    t = _tables(image.device)
    b, h, w, _ = image.shape
    quality = torch.as_tensor(quality, dtype=torch.float32, device=image.device)
    factor = quality_to_factor(quality.expand(b)).reshape(b, 1, 1)

    h_pad = (16 - h % 16) % 16
    w_pad = (16 - w % 16) % 16
    x = F.pad(image, (0, 0, 0, w_pad, 0, h_pad))
    hp, wp = h + h_pad, w + w_pad

    y_step = t["y_table"] * factor
    c_step = t["c_table"] * factor

    def dct(plane):
        return _product(_to_blocks(plane) - 128.0, t["dct"])

    def idct(coeffs, hh, ww):
        return _from_blocks(_product(coeffs * t["alpha"], t["idct"]) + 128.0, hh, ww)

    # --- compress ---
    ycbcr = _product(x * 255.0, t["rgb2ycbcr"], t["ycbcr_shift"])
    y = ycbcr[..., 0]
    cbcr = _pool2x2(ycbcr[..., 1:3])
    cb, cr = cbcr[..., 0], cbcr[..., 1]

    y_q = rnd(dct(y) / y_step)
    cb_q = rnd(dct(cb) / c_step)
    cr_q = rnd(dct(cr) / c_step)

    # --- decompress ---
    y_d = idct(y_q * y_step, hp, wp)
    cb_d = idct(cb_q * c_step, hp // 2, wp // 2)
    cr_d = idct(cr_q * c_step, hp // 2, wp // 2)

    # nearest (repeat) chroma upsample, as the reference
    cb_u = cb_d.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    cr_u = cr_d.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

    ycbcr_out = torch.stack([y_d, cb_u, cr_u], dim=-1)
    rgb = _product(ycbcr_out + t["rgb_shift"], t["ycbcr2rgb"])
    rgb = torch.clamp(rgb, 0.0, 255.0) * INV_255
    return rgb[:, :h, :w, :]
