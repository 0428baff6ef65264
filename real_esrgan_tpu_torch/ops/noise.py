"""Batched Gaussian / Poisson sensor-noise injection, NHWC: the port of
real_esrgan_tpu/ops/noise.py.

Per-sample noise strengths, gray-noise blending and the reference's Poisson
unique-level scaling.  The samplers take their standard normals as inputs,
so the same noise can be applied from the JAX package's draws; the exact
Poisson sampler takes one seed a sample instead (``draw_poisson_seeds``), so
a sample's counts do not depend on the batch it is drawn in.  The
``random_add_*`` functions draw them with a torch generator.  The distinct
8-bit levels of each sample are counted exactly by a scatter into (B, 256).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from real_esrgan_tpu_torch.ops.color import rgb_to_grayscale
from real_esrgan_tpu_torch.ops.resize import INV_255, reciprocal, correct_sqrt


def _unique_levels(image: torch.Tensor) -> torch.Tensor:
    """Number of distinct 8-bit levels per sample (B,) for (B, ...) in [0, 1]."""
    levels = torch.clamp(torch.round(image * 255.0), 0, 255).long()
    flat = levels.reshape(levels.shape[0], -1)
    present = torch.zeros((flat.shape[0], 256), dtype=torch.bool, device=image.device)
    present.scatter_(1, flat, True)
    return present.sum(dim=1)


def _vals_from_unique(unique: torch.Tensor) -> torch.Tensor:
    """2 ** ceil(log2(#unique)), as the reference."""
    u = torch.clamp(unique.float(), min=1.0)
    return torch.exp2(torch.ceil(torch.log2(u)))


def gaussian_noise(image: torch.Tensor, sigma: torch.Tensor, gray_mask: torch.Tensor,
                   normal: torch.Tensor, normal_gray: torch.Tensor) -> torch.Tensor:
    """Per-sample Gaussian noise (sigma in /255 units).

    Args:
        image: (B, H, W, C) in [0, 1] (only its shape is used).
        sigma: (B,) noise std in 255-range.
        gray_mask: (B,) 1.0 where the sample gets luminance-only noise.
        normal, normal_gray: standard normals, (B, H, W, C) and (B, H, W, 1).
    """
    b = image.shape[0]
    sigma = sigma.reshape(b, 1, 1, 1) * INV_255
    noise = normal * sigma
    noise_gray = normal_gray * sigma
    g = gray_mask.reshape(b, 1, 1, 1)
    return noise * (1.0 - g) + noise_gray * g


def draw_poisson_seeds(generator: Optional[torch.Generator], batch: int, device) -> torch.Tensor:
    """One int64 seed a sample for the exact Poisson sampler, (B,), on ``device``."""
    return torch.randint(0, torch.iinfo(torch.int64).max, (batch,), generator=generator,
                         device=device, dtype=torch.int64)


def exact_poisson_counts(rates: torch.Tensor, rates_gray: torch.Tensor,
                         seeds: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact Poisson counts of the colour ``rates`` (B, H, W, C) and the gray
    ``rates_gray`` (B, H, W, 1): sample i's colour counts, then its gray
    counts, drawn by ``torch.poisson`` from one generator on the rates'
    device seeded by ``seeds[i]``.  A sample's counts so depend on its seed
    alone, and a data-parallel rank that applies its slice of the global
    batch's draws gets the counts one process gets on the whole batch.  Two
    ``torch.poisson`` calls a sample, and one read of the seeds to the host."""
    counts, counts_gray = torch.empty_like(rates), torch.empty_like(rates_gray)
    for i, seed in enumerate(seeds.tolist()):
        generator = torch.Generator(device=rates.device).manual_seed(seed)
        counts[i] = torch.poisson(rates[i], generator=generator)
        counts_gray[i] = torch.poisson(rates_gray[i], generator=generator)
    return counts, counts_gray


def _poisson_residual(rates: torch.Tensor, approx: bool, z: Optional[torch.Tensor] = None,
                      counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Poisson(rates) - rates.

    approx=True maps ONE standard normal ``z`` per element to a Poisson-like
    count two ways, switching on the rate:

    * lam >= 2: Cornish-Fisher skew-corrected rounded normal
          X = round(lam + sqrt(lam) * z + (z^2 - 1) / 6),  clamped to >= 0,
      matching the first three moments;
    * lam < 2: exact inverse CDF through the coupled uniform u = Phi(z), over
      atoms 0..9 (the CF expansion breaks down for tiny rates).  The JAX
      package compares in float32; the port takes u and the CDF in float64,
      so the card and the CPU (whose float32 ``ndtr`` and ``exp`` differ in
      the last bit) pick the same atom.

    approx=False takes the exact ``counts`` (``exact_poisson_counts``).
    """
    if not approx:
        return counts - rates
    cf = torch.round(rates + z * correct_sqrt(rates) + (z * z - 1.0) * reciprocal(6.0))
    cf = torch.clamp(cf, min=0.0)

    u = torch.special.ndtr(z.double())
    safe = torch.clamp(rates, max=2.0).double()   # keep the series well-behaved
    term = torch.exp(-safe)
    cdf = term
    small = torch.zeros_like(rates)
    for i in range(1, 9):
        small = small + (u > cdf).to(rates.dtype)
        term = term * safe / i
        cdf = cdf + term
    small = small + (u > cdf).to(rates.dtype)  # atom 9 tail guard

    return torch.where(rates < 2.0, small, cf) - rates


def _quantize(image: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(image * 255.0), 0, 255) * INV_255


def poisson_noise(image: torch.Tensor, scale: torch.Tensor, gray_mask: torch.Tensor,
                  approx: bool = False, normal: Optional[torch.Tensor] = None,
                  normal_gray: Optional[torch.Tensor] = None,
                  seeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample Poisson (shot) noise scaled by ``scale``, as the
    reference's ``_generate_poisson_noise_torch``: quantize to 8 bits,
    count the levels, draw Poisson(image * vals) / vals - image.

    ``approx`` takes the standard normals ``normal`` (B, H, W, C) and
    ``normal_gray`` (B, H, W, 1); the exact sampler takes ``seeds``, one a
    sample (``draw_poisson_seeds``).  The gray path counts the levels of the
    luma of the unquantized image.
    """
    b = image.shape[0]
    img_q = _quantize(image)
    vals = _vals_from_unique(_unique_levels(img_q)).reshape(b, 1, 1, 1)
    gray_q = _quantize(rgb_to_grayscale(image))
    vals_g = _vals_from_unique(_unique_levels(gray_q)).reshape(b, 1, 1, 1)
    rates, rates_gray = img_q * vals, gray_q * vals_g
    counts, counts_gray = (None, None) if approx else exact_poisson_counts(rates, rates_gray, seeds)
    noise = _poisson_residual(rates, approx, normal, counts) / vals
    noise_gray = _poisson_residual(rates_gray, approx, normal_gray, counts_gray) / vals_g

    g = gray_mask.reshape(b, 1, 1, 1)
    noise = noise * (1.0 - g) + noise_gray * g
    return noise * scale.reshape(b, 1, 1, 1)


def _finalize(out: torch.Tensor, clip: bool, rounds: bool) -> torch.Tensor:
    if clip and rounds:
        return torch.clamp(torch.round(out * 255.0), 0, 255) * INV_255
    if clip:
        return torch.clamp(out, 0.0, 1.0)
    if rounds:
        return torch.round(out * 255.0) * INV_255
    return out


def _strengths(generator, b: int, value_range: Tuple[float, float], gray_prob: float,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    value = torch.rand(b, generator=generator, device=device) * (
        value_range[1] - value_range[0]) + value_range[0]
    gray = (torch.rand(b, generator=generator, device=device) < gray_prob).float()
    return value, gray


def draw_normals(generator, image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standard normals for the colour and the gray noise of ``image``."""
    b, h, w, c = image.shape
    return (torch.randn((b, h, w, c), generator=generator, device=image.device),
            torch.randn((b, h, w, 1), generator=generator, device=image.device))


def random_add_gaussian_noise(generator, image: torch.Tensor, sigma_range: Tuple[float, float],
                              gray_prob: float, clip: bool = True,
                              rounds: bool = False) -> torch.Tensor:
    """The reference's ``random_add_gaussian_noise_torch``."""
    sigma, gray = _strengths(generator, image.shape[0], sigma_range, gray_prob, image.device)
    out = image + gaussian_noise(image, sigma, gray, *draw_normals(generator, image))
    return _finalize(out, clip, rounds)


def random_add_poisson_noise(generator, image: torch.Tensor, scale_range: Tuple[float, float],
                             gray_prob: float, clip: bool = True,
                             rounds: bool = False) -> torch.Tensor:
    """The reference's ``random_add_poisson_noise_torch`` (exact sampler)."""
    scale, gray = _strengths(generator, image.shape[0], scale_range, gray_prob, image.device)
    seeds = draw_poisson_seeds(generator, image.shape[0], image.device)
    out = image + poisson_noise(image, scale, gray, seeds=seeds)
    return _finalize(out, clip, rounds)
