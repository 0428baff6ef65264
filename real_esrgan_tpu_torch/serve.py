"""Serving pipeline: load once, upscale anything.  The port of
real_esrgan_tpu/serve.py::SRPipeline.

* small images are padded to multiples of ``bucket`` (reflect) and cropped
  back, as in the JAX pipeline, so both serve the same shapes;
* images larger than ``tile_threshold`` go through overlap tiles
  (parallel/tiling.py), each tile batch spread over the pipeline's devices,
  one generator replica a device, as the JAX pipeline shards it over its
  mesh;
* weights come from ``.npz`` snapshots or reference ``.pth.tar`` files;
* ``arch`` picks the network: ``rrdbnet`` (Real-ESRGAN's ``Generator``) or
  ``swinir_l`` (SwinIR-L for real-world x4, ``models/swinir.py``), each
  served through the same code.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from real_esrgan_tpu_torch.models import Generator
from real_esrgan_tpu_torch.models.swinir import SwinIR
from real_esrgan_tpu_torch.parallel.mesh import local_devices
from real_esrgan_tpu_torch.parallel.tiling import tiled_upscale
from real_esrgan_tpu_torch.train.checkpoint import load_generator_params
from real_esrgan_tpu_torch.utils.profiling import add, span


def count_pixels(batch: torch.Tensor) -> None:
    """Adds the input pixels of an NHWC ``batch`` that the generator is
    about to run to the open request's ``px_run`` (``utils/profiling.py``)."""
    n, h, w, _ = batch.shape
    add(px_run=n * h * w)


def no_grad_forward(model: torch.nn.Module):
    """``model``'s forward under ``torch.no_grad``, its input pixels counted
    (``count_pixels``)."""
    @torch.no_grad()
    def forward(batch: torch.Tensor) -> torch.Tensor:
        count_pixels(batch)
        return model(batch)
    return forward


ARCHS = ("rrdbnet", "swinir_l")


def build_generator(arch: str = "rrdbnet", num_rrdb: int = 23, **kwargs) -> torch.nn.Module:
    """The network ``arch`` names (``ARCHS``): ``rrdbnet``, a ``Generator`` of
    ``num_rrdb`` RRDBs, or ``swinir_l``, SwinIR-L at its published widths
    (x4 only).  ``kwargs`` go to the network's constructor."""
    if arch == "rrdbnet":
        return Generator(num_rrdb=num_rrdb, **kwargs)
    if arch == "swinir_l":
        return SwinIR(**kwargs)
    raise ValueError(f"unknown arch {arch!r}; one of {ARCHS}")


def generator_replicas(devices, state_dict=None, arch: str = "rrdbnet",
                       **generator_kwargs) -> List[torch.nn.Module]:
    """One evaluation-mode ``build_generator(arch, **generator_kwargs)`` a
    device, each with ``state_dict`` loaded where one is given."""
    models = []
    for d in devices:
        model = build_generator(arch, device=d, **generator_kwargs).eval()
        if state_dict is not None:
            model.load_state_dict(state_dict)
        models.append(model)
    return models


class SRPipeline:
    """x``upscale_factor`` super-resolution on one device or several.

    ``devices`` defaults to every visible GPU (``local_devices()``) and
    raises when there is none; ``device`` means that one device (pass
    ``device="cpu"`` to run on the CPU).  Tiled requests spread each tile
    batch over ``devices``, one replica a device; every other request runs
    on the first, ``self.device``.  ``bfloat16`` picks the compute dtype of
    the generator (default True, as in the JAX pipeline); ``arch`` the network
    (``ARCHS``; ``num_rrdb`` is RRDBNet's alone)."""

    def __init__(self, weights_path: str = "", upscale_factor: int = 4,
                 num_rrdb: int = 23, bfloat16: bool = True,
                 bucket: int = 32, tile_threshold: int = 512,
                 tile: int = 528, tile_overlap: int = 8, tile_batch: int = 8,
                 device=None, devices=None, arch: str = "rrdbnet"):
        if device is not None:
            devices = [device]
        self.devices = [torch.device(d) for d in
                        (devices if devices is not None else local_devices())]
        self.device = self.devices[0]
        self.scale = upscale_factor
        self.bucket = bucket
        self.tile_threshold = tile_threshold
        self.tile = tile
        self.tile_overlap = tile_overlap
        self.tile_batch = tile_batch

        self.models = generator_replicas(
            self.devices, load_generator_params(weights_path) if weights_path else None,
            arch=arch, upscale_factor=upscale_factor, num_rrdb=num_rrdb,
            dtype=torch.bfloat16 if bfloat16 else torch.float32)
        self.model = self.models[0]

    @torch.no_grad()
    def apply(self, batch: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) NHWC on the pipeline's first device -> (B, sH, sW, 3)."""
        count_pixels(batch)
        return self.model(batch)

    def upscale(self, image: np.ndarray) -> np.ndarray:
        """x``scale`` one (H, W, 3) float RGB image in [0, 1].

        One request's spans (``utils/profiling.py``): the root
        ``serve.upscale``; ``serve.prepare`` (bucket pad, float32, copy to
        the device), ``serve.launch`` (the forward's enqueue), ``serve.wait``
        (the copy out, which waits for the device) and ``serve.finish``, or
        tiling's spans; counters ``px_useful`` (h * w) and, at the
        generator's call, ``px_run``."""
        with span("serve.upscale"):
            h, w, _ = image.shape
            if max(h, w) > self.tile_threshold:
                return tiled_upscale([no_grad_forward(m) for m in self.models], image,
                                     scale=self.scale, tile=self.tile,
                                     overlap=self.tile_overlap, tile_batch=self.tile_batch,
                                     devices=self.devices)

            with span("serve.prepare"):
                hb = math.ceil(h / self.bucket) * self.bucket
                wb = math.ceil(w / self.bucket) * self.bucket
                padded = np.pad(image, ((0, hb - h), (0, wb - w), (0, 0)),
                                mode="reflect" if min(h, w) > 1 else "edge")
                batch = torch.from_numpy(np.ascontiguousarray(padded[None], np.float32))
                batch = batch.to(self.device)
            add(px_useful=h * w)
            with span("serve.launch"):
                sr = self.apply(batch)
            with span("serve.wait"):
                sr = sr[0, :h * self.scale, :w * self.scale].cpu()
            with span("serve.finish"):
                return sr.numpy()

    def upscale_batch(self, images) -> list:
        return [self.upscale(img) for img in images]
