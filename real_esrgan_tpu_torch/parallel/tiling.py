"""Overlap-tile decomposition for large-image serving: the port of
real_esrgan_tpu/parallel/tiling.py::tiled_upscale, on one device.

The image is reflect-padded so every core cell is covered and every halo is
in bounds, moved to the device once, cut into fixed-size tiles by slicing on
the device, run through the network in batches of ``tile_batch`` tiles, and
each tile's halo-trimmed core is stitched into the output there.  The last
batch holds only the tiles that are left.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch


def tiled_upscale(apply_fn: Callable[[torch.Tensor], torch.Tensor], image: np.ndarray,
                  scale: int = 4, tile: int = 528, overlap: int = 8,
                  tile_batch: int = 8, device=None) -> np.ndarray:
    """x``scale`` upscale of one (H, W, 3) float32 image in [0, 1].

    Args:
        apply_fn: (B, tile, tile, 3) NHWC tensor -> (B, tile*s, tile*s, 3).
        tile: tile size fed to the network.
        overlap: halo on each side; core stride is tile - 2 * overlap.
        tile_batch: tiles per network call.
        device: where the tiles live (``apply_fn``'s device).

    The 528/8/8 default makes the core 512, which divides 2K inputs; an
    overlap of 8 input pixels covers the generator's receptive field well
    enough that interior seams sit at the bf16 noise floor (``chip_smoke.py``
    measures the seam error on the card).
    """
    h, w, c = image.shape
    core = tile - 2 * overlap
    if core <= 0:
        raise ValueError("overlap too large for tile size")
    ny = max(1, math.ceil(h / core))
    nx = max(1, math.ceil(w / core))
    n_tiles = ny * nx

    pad_h = overlap + (ny * core - h) + overlap
    pad_w = overlap + (nx * core - w) + overlap
    padded = np.pad(image, ((overlap, pad_h - overlap),
                            (overlap, pad_w - overlap), (0, 0)), mode="reflect")
    padded = torch.from_numpy(np.ascontiguousarray(padded, np.float32)).to(device)

    c_s, o_s = core * scale, overlap * scale
    cores = []
    for start in range(0, n_tiles, tile_batch):
        flat = range(start, min(start + tile_batch, n_tiles))
        tiles = torch.stack([padded[(i // nx) * core:(i // nx) * core + tile,
                                    (i % nx) * core:(i % nx) * core + tile] for i in flat])
        sr = apply_fn(tiles)
        cores.append(sr[:, o_s:o_s + c_s, o_s:o_s + c_s, :])
    out = torch.cat(cores).reshape(ny, nx, c_s, c_s, c)
    out = out.permute(0, 2, 1, 3, 4).reshape(ny * c_s, nx * c_s, c)
    return out[:h * scale, :w * scale].cpu().numpy()
