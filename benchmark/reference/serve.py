"""Plain reference of serving one image, written from the serving
semantics and importing nothing of the program: an image whose longer side
is at most ``tile_threshold`` is reflect-padded at the bottom and right to
multiples of ``bucket`` (edge-padded where a side is 1), run whole, and its
output cropped to ``scale`` times the image; a larger image is cut into
``tile``-square tiles whose cores of ``tile - 2 * overlap`` cover it, over a
canvas reflect-padded by ``overlap`` on the top and left and enough at the
bottom and right, each tile run alone, its core's output kept and the cores
stitched in raster order, the result cropped to the image.  Each forward is
``generator.forward``."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.generator import Quant, forward_in_blocks


def _run(params, image: np.ndarray, cfg: dict, device, quant: Quant, dtype) -> np.ndarray:
    x = torch.from_numpy(np.ascontiguousarray(image, np.float32))[None].to(device)
    return forward_in_blocks(params, x, cfg, 1, quant, dtype)[0].cpu().numpy()


def serve(params, image: np.ndarray, cfg: dict, device, bucket: int = 32,
          tile_threshold: int = 512, tile: int = 528, overlap: int = 8,
          quant: Quant = None, dtype: torch.dtype = torch.float32) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1] -> (sH, sW, 3) float32; ``quant`` and
    ``dtype`` as in ``generator.forward_in_blocks``."""
    h, w, _ = image.shape
    s = cfg["scale"]
    if max(h, w) <= tile_threshold:
        hb, wb = math.ceil(h / bucket) * bucket, math.ceil(w / bucket) * bucket
        padded = np.pad(image, ((0, hb - h), (0, wb - w), (0, 0)),
                        mode="reflect" if min(h, w) > 1 else "edge")
        return _run(params, padded, cfg, device, quant, dtype)[:h * s, :w * s]
    core = tile - 2 * overlap
    ny, nx = math.ceil(h / core), math.ceil(w / core)
    padded = np.pad(image, ((overlap, overlap + ny * core - h),
                            (overlap, overlap + nx * core - w), (0, 0)), mode="reflect")
    out = np.zeros((ny * core * s, nx * core * s, image.shape[2]), np.float32)
    for i in range(ny):
        for j in range(nx):
            sr = _run(params, padded[i * core:i * core + tile, j * core:j * core + tile], cfg,
                      device, quant, dtype)
            out[i * core * s:(i + 1) * core * s, j * core * s:(j + 1) * core * s] = \
                sr[overlap * s:(overlap + core) * s, overlap * s:(overlap + core) * s]
    return out[:h * s, :w * s]
