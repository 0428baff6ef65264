"""NIQE (Natural Image Quality Evaluator): the port of
real_esrgan_tpu/metrics/niqe.py, with the same split.

* The per-pixel and per-block work (Y extraction, MSCN maps with a 7x7
  Gaussian and replicate padding, MATLAB-bicubic half-scale, block AGGD fits
  over a 9801-entry gamma table) runs in float32 on the input's device with
  stock PyTorch ops.  The Y projection and the resize run in true float32
  whatever the global TF32 flags say, and the Gaussian filter is written as
  shifts and adds: Y lies in [16, 235], and ``E[x^2] - mu^2`` loses every
  digit TF32 keeps.
* The small, precision-sensitive tail (nan-aware MVG fit over the block
  feature vectors, pinv of a 36x36 matrix, the distance) runs on the host in
  float64 numpy.

Pristine MVG statistics ship in ``assets/niqe_model.{mat,npz}`` (keys
``mu_prisparam`` / ``cov_prisparam``, and ``mu_pris_param`` /
``cov_pris_param`` in the ``.npz``).
"""

from __future__ import annotations

import functools
import math
import os
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from real_esrgan_tpu_torch import resolve_device
from real_esrgan_tpu_torch.ops.resize import make_matlab_resize_matrix, true_f32

DEFAULT_MODEL_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets", "niqe_model.mat")

_GAM = np.arange(0.2, 10.001, 0.001)  # 9801 candidate shape params


def _gaussian_taps(size: int = 7, sigma: float = 7.0 / 6.0) -> np.ndarray:
    """1-D taps g with outer(g, g) the normalised 2-D Gaussian window."""
    ax = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-ax ** 2 / (2 * sigma * sigma))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> Tuple[torch.Tensor, ...]:
    """float32 tables on ``device``, built once for each device: the
    candidates a, r(a) = gamma(2/a)^2 / (gamma(1/a) gamma(3/a)),
    sqrt(gamma(1/a) / gamma(3/a)), gamma(2/a) / gamma(1/a), and the
    Gaussian window's seven 1-D taps."""
    from scipy.special import gammaln

    g1, g2, g3 = gammaln(1.0 / _GAM), gammaln(2.0 / _GAM), gammaln(3.0 / _GAM)
    arrays = (_GAM, np.exp(2 * g2 - (g1 + g3)), np.exp(0.5 * (g1 - g3)), np.exp(g2 - g1))
    tables = [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]
    return (*tables, torch.from_numpy(_gaussian_taps()).to(device))


def _filter_replicate(img: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """7x7 Gaussian correlate with replicate padding on (B, H, W).

    The window is separable, so it is written as seven row shifts and seven
    column shifts, each a float32 multiply and add: no library convolution,
    hence no TF32, and the same bits on the CPU and on the card.
    """
    pad = taps.shape[0] // 2
    _, h, w = img.shape
    x = F.pad(img[:, None], (pad, pad, pad, pad), mode="replicate")[:, 0]
    rows = sum(x[:, i:i + h, :] * taps[i] for i in range(taps.shape[0]))
    return sum(rows[:, :, j:j + w] * taps[j] for j in range(taps.shape[0]))


def _aggd_fit(v: torch.Tensor, tables) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """AGGD parameter estimation over the last dimension of ``v`` (..., n).

    Returns (pos, left_beta, right_beta), ``pos`` being the index of the
    fitted shape parameter in the candidate table.  Nothing raises on a
    degenerate block: a NaN moment ratio goes through ``argmin`` (which then
    takes the first entry, as ``jnp.argmin`` does) and NaN betas propagate
    to the host-side fit, which drops the block.
    """
    _, r_gam, beta_factor, _, _ = tables
    mask_l, mask_r = v < 0, v > 0
    sq = v * v
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    left_std = torch.sqrt(torch.where(mask_l, sq, zero).sum(-1) / (mask_l.sum(-1).float() + 1e-8))
    right_std = torch.sqrt(torch.where(mask_r, sq, zero).sum(-1) / (mask_r.sum(-1).float() + 1e-8))
    gamma_hat = left_std / right_std
    rhat = v.abs().mean(-1) ** 2 / sq.mean(-1)
    rhat_norm = (rhat * (gamma_hat ** 3 + 1) * (gamma_hat + 1)) / ((gamma_hat ** 2 + 1) ** 2)
    pos = torch.argmin((r_gam - rhat_norm[..., None]).abs(), dim=-1)
    bf = beta_factor[pos]
    return pos, left_std * bf, right_std * bf


def _block_features(blocks: torch.Tensor, tables) -> torch.Tensor:
    """(B, nb, bh, bw) MSCN blocks -> (B, nb, 18) features: 2 from the AGGD
    of the block itself and 4 from each circularly shifted pairwise product
    (H, V, D1, D2)."""
    gam, _, _, mean_factor, _ = tables
    pos, lb, rb = _aggd_fit(blocks.flatten(-2), tables)
    feats = [gam[pos], (lb + rb) / 2.0]
    for shift in ((0, 1), (1, 0), (1, 1), (1, -1)):
        shifted = torch.roll(blocks, shifts=shift, dims=(-2, -1))
        pos, left, right = _aggd_fit((blocks * shifted).flatten(-2), tables)
        feats.extend([gam[pos], (right - left) * mean_factor[pos], left, right])
    return torch.stack(feats, dim=-1)


def _to_blocks(img: torch.Tensor, bh: int, bw: int) -> torch.Tensor:
    """(B, H, W) -> (B, nb, bh, bw) in column-major block order (block
    columns outer, block rows inner), as MATLAB's blockproc walks them."""
    b, h, w = img.shape
    nbh, nbw = h // bh, w // bw
    x = img[:, :nbh * bh, :nbw * bw].reshape(b, nbh, bh, nbw, bw)
    return x.permute(0, 3, 1, 2, 4).reshape(b, nbw * nbh, bh, bw)


@torch.no_grad()
def niqe_features(rgb: torch.Tensor, crop_border: int = 0,
                  block_size: int = 96) -> torch.Tensor:
    """The (B, num_blocks, 36) NIQE feature tensor, on ``rgb``'s device.

    Args:
        rgb: (B, H, W, 3) RGB float in [0, 1], NHWC.
    """
    tables = _tables(rgb.device)
    taps = tables[-1]
    rgb = rgb.float()
    if crop_border > 0:
        rgb = rgb[:, crop_border:-crop_border, crop_border:-crop_border, :]

    # MATLAB rgb2ycbcr Y in [16, 235], rounded
    with true_f32():
        y = rgb @ torch.tensor([65.481, 128.553, 24.966], device=rgb.device) + 16.0
    y = torch.round(y)

    _, h, w = y.shape
    nbh, nbw = h // block_size, w // block_size
    img = y[:, :nbh * block_size, :nbw * block_size]

    feats = []
    for scale in (1, 2):
        mu = _filter_replicate(img, taps)
        ex2 = _filter_replicate(img * img, taps)
        sigma = torch.sqrt((ex2 - mu * mu).abs() + 1e-8)
        mscn = (img - mu) / (sigma + 1.0)
        feats.append(_block_features(
            _to_blocks(mscn, block_size // scale, block_size // scale), tables))

        if scale == 1:
            # MATLAB-bicubic antialiased half-scale of img / 255
            hh, ww = img.shape[1], img.shape[2]
            mh = torch.from_numpy(make_matlab_resize_matrix(hh, int(math.ceil(hh / 2)), 0.5))
            mw = torch.from_numpy(make_matlab_resize_matrix(ww, int(math.ceil(ww / 2)), 0.5))
            with true_f32():
                img = torch.einsum("oh,bhw->bow", mh.to(img.device), img / 255.0)
                img = torch.einsum("pw,bow->bop", mw.to(img.device), img) * 255.0

    return torch.cat(feats, dim=-1)


class NIQE:
    """Batched NIQE scorer; lower is better.

        metric = NIQE(crop_border=4)      # crop == upscale factor
        scores = metric(sr_batch_nhwc)    # numpy (B,) float64

    A numpy batch is moved to ``device`` (CUDA by default; raises when there
    is none); a tensor is scored on the device it lies on.
    """

    def __init__(self, crop_border: int = 4, model_path: str = DEFAULT_MODEL_PATH,
                 block_size: int = 96, device=None):
        self.crop_border = crop_border
        self.block_size = block_size
        self.device = torch.device(device) if device is not None else resolve_device()
        if model_path.endswith(".npz"):
            data = np.load(model_path)
            self.mu_pris = np.ravel(data["mu_pris_param"]).astype(np.float64)
            self.cov_pris = data["cov_pris_param"].astype(np.float64)
        else:
            import scipy.io

            data = scipy.io.loadmat(model_path)
            self.mu_pris = np.ravel(data["mu_prisparam"]).astype(np.float64)
            self.cov_pris = data["cov_prisparam"].astype(np.float64)

    def score_features(self, feats: np.ndarray) -> np.ndarray:
        """Host-side float64 MVG fit and distance."""
        feats = np.asarray(feats, np.float64)
        scores = []
        for f in feats:
            mu = np.nanmean(f, axis=0)
            good = f[~np.isnan(f).any(axis=1)]
            if good.shape[0] < 2:
                scores.append(np.nan)
                continue
            cov = np.cov(good, rowvar=False)
            inv = np.linalg.pinv((self.cov_pris + cov) / 2.0)
            d = self.mu_pris - mu
            scores.append(float(np.sqrt(max(d @ inv @ d, 0.0))))
        return np.asarray(scores)

    def __call__(self, rgb_nhwc) -> np.ndarray:
        if not isinstance(rgb_nhwc, torch.Tensor):
            rgb_nhwc = torch.from_numpy(np.ascontiguousarray(rgb_nhwc, np.float32)).to(self.device)
        feats = niqe_features(rgb_nhwc, self.crop_border, self.block_size)
        return self.score_features(feats.cpu().numpy())


def niqe(image_rgb: np.ndarray, crop_border: int = 0, model_path: str = DEFAULT_MODEL_PATH,
         block_size: int = 96, device=None) -> float:
    """NIQE of one (H, W, 3) float RGB image in [0, 1]."""
    scorer = NIQE(crop_border=crop_border, model_path=model_path, block_size=block_size,
                  device=device)
    return float(scorer(np.asarray(image_rgb)[None])[0])
