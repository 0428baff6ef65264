"""Serving pipeline: load once, upscale anything.  The port of
real_esrgan_tpu/serve.py::SRPipeline.

* small images are padded to multiples of ``bucket`` (reflect) and cropped
  back, as in the JAX pipeline, so both serve the same shapes;
* images larger than ``tile_threshold`` go through overlap tiles
  (parallel/tiling.py);
* weights come from ``.npz`` snapshots or reference ``.pth.tar`` files.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from real_esrgan_tpu_torch import resolve_device
from real_esrgan_tpu_torch.models import Generator
from real_esrgan_tpu_torch.parallel.tiling import tiled_upscale
from real_esrgan_tpu_torch.train.checkpoint import load_generator_params


class SRPipeline:
    """x``upscale_factor`` super-resolution on one device.

    ``device`` defaults to CUDA and raises when there is none; pass
    ``device="cpu"`` to run on the CPU.  ``bfloat16`` picks the compute
    dtype of the generator (default True, as in the JAX pipeline)."""

    def __init__(self, weights_path: str = "", upscale_factor: int = 4,
                 num_rrdb: int = 23, bfloat16: bool = True,
                 bucket: int = 32, tile_threshold: int = 512,
                 tile: int = 528, tile_overlap: int = 8, tile_batch: int = 8,
                 device=None):
        self.device = torch.device(device) if device is not None else resolve_device()
        self.scale = upscale_factor
        self.bucket = bucket
        self.tile_threshold = tile_threshold
        self.tile = tile
        self.tile_overlap = tile_overlap
        self.tile_batch = tile_batch

        self.model = Generator(upscale_factor=upscale_factor, num_rrdb=num_rrdb,
                               dtype=torch.bfloat16 if bfloat16 else torch.float32,
                               device=self.device).eval()
        if weights_path:
            self.model.load_state_dict(load_generator_params(weights_path))

    @torch.no_grad()
    def apply(self, batch: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) NHWC on the pipeline's device -> (B, sH, sW, 3)."""
        return self.model(batch)

    def upscale(self, image: np.ndarray) -> np.ndarray:
        """x``scale`` one (H, W, 3) float RGB image in [0, 1]."""
        h, w, _ = image.shape
        if max(h, w) > self.tile_threshold:
            return tiled_upscale(self.apply, image, scale=self.scale, tile=self.tile,
                                 overlap=self.tile_overlap, tile_batch=self.tile_batch,
                                 device=self.device)

        hb = math.ceil(h / self.bucket) * self.bucket
        wb = math.ceil(w / self.bucket) * self.bucket
        padded = np.pad(image, ((0, hb - h), (0, wb - w), (0, 0)),
                        mode="reflect" if min(h, w) > 1 else "edge")
        batch = torch.from_numpy(np.ascontiguousarray(padded[None], np.float32))
        sr = self.apply(batch.to(self.device))
        return sr[0, :h * self.scale, :w * self.scale].cpu().numpy()

    def upscale_batch(self, images) -> list:
        return [self.upscale(img) for img in images]
