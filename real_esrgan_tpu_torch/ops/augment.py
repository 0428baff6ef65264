"""Geometric augmentation and paired cropping, NHWC: the port of
real_esrgan_tpu/ops/augment.py.

Each random op is split into a draw (``random_orientation``,
``draw_crop_corners``) and a deterministic apply (``apply_orientation``,
``crop_pairs``), so the apply step can take the JAX package's own draws.
The applies select per sample with gathers and ``torch.where`` on device
tensors: nothing waits for the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def center_crop(image: torch.Tensor, size: int) -> torch.Tensor:
    """Center-crop an HWC or NHWC image to (size, size)."""
    h, w = image.shape[-3], image.shape[-2]
    top, left = (h - size) // 2, (w - size) // 2
    return image[..., top:top + size, left:left + size, :]


def _uniform(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device)


def random_orientation(generator: Optional[torch.Generator], batch: int,
                       device=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-sample (rot90 count in 0..3, hflip, vflip), as the reference's
    random rotate and random flips."""
    rot = torch.randint(0, 4, (batch,), generator=generator, device=device)
    hflip = _uniform((batch,), generator, device) < 0.5
    vflip = _uniform((batch,), generator, device) < 0.5
    return rot, hflip, vflip


def apply_orientation(images: torch.Tensor, rot: torch.Tensor, hflip: torch.Tensor,
                      vflip: torch.Tensor) -> torch.Tensor:
    """Rotate (counter-clockwise, ``rot`` quarter turns, as ``jnp.rot90``),
    then flip, each sample of a square NHWC batch by its own draw."""
    turns = torch.stack([torch.rot90(images, k, dims=(1, 2)) for k in range(4)])
    images = turns[rot, torch.arange(images.shape[0], device=images.device)]
    images = torch.where(hflip[:, None, None, None], images.flip(2), images)
    return torch.where(vflip[:, None, None, None], images.flip(1), images)


def draw_crop_corners(generator: Optional[torch.Generator], batch: int, hr_hw: Tuple[int, int],
                      hr_crop: int, scale: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample (top, left) crop corners on the LR grid, uniform over every
    corner that keeps the HR crop inside an ``hr_hw`` image."""
    tops = torch.randint(0, (hr_hw[0] - hr_crop) // scale + 1, (batch,), generator=generator,
                         device=device)
    lefts = torch.randint(0, (hr_hw[1] - hr_crop) // scale + 1, (batch,), generator=generator,
                          device=device)
    return tops, lefts


def _crop(images: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor,
          size: int) -> torch.Tensor:
    span = torch.arange(size, device=images.device)
    rows = (tops[:, None] + span)[:, :, None]
    cols = (lefts[:, None] + span)[:, None, :]
    batch = torch.arange(images.shape[0], device=images.device)[:, None, None]
    return images[batch, rows, cols]


def crop_pairs(lr: torch.Tensor, hr: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor,
               hr_crop: int, scale: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Aligned (LR, HR) patches at LR-grid corners (``tops``, ``lefts``): the
    HR corner is the LR corner times ``scale``, so the pair is exactly
    aligned (the reference floors an arbitrary HR corner, which can misalign
    the pair by up to scale - 1 HR pixels)."""
    lr_patch = _crop(lr, tops, lefts, hr_crop // scale)
    hr_patch = _crop(hr, tops * scale, lefts * scale, hr_crop)
    return lr_patch, hr_patch


def paired_random_crop(generator: Optional[torch.Generator], lr: torch.Tensor,
                       hr: torch.Tensor, hr_crop: int,
                       scale: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Crop aligned (LR, HR) patches, one random position per sample."""
    tops, lefts = draw_crop_corners(generator, hr.shape[0], tuple(hr.shape[1:3]), hr_crop, scale,
                                    hr.device)
    return crop_pairs(lr, hr, tops, lefts, hr_crop, scale)
