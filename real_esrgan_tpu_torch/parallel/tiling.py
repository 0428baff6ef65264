"""Overlap-tile decomposition for large-image serving: the port of
real_esrgan_tpu/parallel/tiling.py::tiled_upscale.

The image is reflect-padded so every core cell is covered and every halo is
in bounds, moved once to each device, cut into fixed-size tiles by slicing on
the device, run through the network in batches of ``tile_batch`` tiles, and
each tile's halo-trimmed core is stitched into the output on the first
device.  The last batch holds only the tiles that are left.

With several devices (the JAX package shards each tile batch over its mesh)
``tile_batch`` is rounded to a multiple of the device count and each batch
is split into equal chunks, one a device, each run by that device's replica
of the network.  Every chunk is launched before any result is read, so the
devices work at once; the cores stay on their devices until the last batch
is launched and are gathered on the first device at the end.

A tile's output does not depend on the tiles beside it in its batch, so on
the CPU N devices give one device's output bit for bit.  On the card the RDB
kernel computes each tile alone, but the generator's other convolutions go to
cuDNN, which may take another algorithm for another batch size.  On an
H100, at the serving geometry (528/8/8, a batch of 4 tiles against chunks
of 2), the float32 output is the same bits (``chip_smoke.py``'s
``tiled_devices``); at 96-pixel tiles it differed in the last bits (2e-8).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Union

import numpy as np
import torch

ApplyFn = Callable[[torch.Tensor], torch.Tensor]


def tiled_upscale(apply_fn: Union[ApplyFn, Sequence[ApplyFn]], image: np.ndarray,
                  scale: int = 4, tile: int = 528, overlap: int = 8,
                  tile_batch: int = 8, device=None, devices=None) -> np.ndarray:
    """x``scale`` upscale of one (H, W, 3) float32 image in [0, 1].

    Args:
        apply_fn: (B, tile, tile, 3) NHWC tensor -> (B, tile*s, tile*s, 3), on
            the tensor's device; or one such function a device of ``devices``
            (each device's replica of the network).
        tile: tile size fed to the network.
        overlap: halo on each side; core stride is tile - 2 * overlap.
        tile_batch: tiles per network call over all devices, rounded to a
            multiple of their count.
        device: where the tiles live with one device (``apply_fn``'s device).
        devices: the devices to spread each tile batch over, in place of
            ``device``; a device may appear twice (two replicas on one card).

    The 528/8/8 default makes the core 512, which divides 2K inputs; an
    overlap of 8 input pixels covers the generator's receptive field well
    enough that interior seams sit at the bf16 noise floor (``chip_smoke.py``
    measures the seam error on the card).
    """
    devices = [torch.device(d) for d in devices] if devices is not None else [
        torch.device(device) if device is not None else None]
    fns = list(apply_fn) if isinstance(apply_fn, Sequence) else [apply_fn] * len(devices)
    if len(fns) != len(devices):
        raise ValueError(f"{len(fns)} apply functions for {len(devices)} devices")
    n_dev = len(devices)
    if tile_batch % n_dev:
        tile_batch = max(n_dev, (tile_batch // n_dev) * n_dev)

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
    host = torch.from_numpy(np.ascontiguousarray(padded, np.float32))
    on_device = {d: host.to(d) for d in dict.fromkeys(devices)}

    c_s, o_s = core * scale, overlap * scale
    cores = []
    for start in range(0, n_tiles, tile_batch):
        batch = torch.arange(start, min(start + tile_batch, n_tiles))
        for d, fn, flat in zip(devices, fns, torch.tensor_split(batch, n_dev)):
            if len(flat) == 0:
                continue
            src = on_device[d]
            tiles = torch.stack([src[(i // nx) * core:(i // nx) * core + tile,
                                     (i % nx) * core:(i % nx) * core + tile]
                                 for i in flat.tolist()])
            sr = fn(tiles)
            cores.append(sr[:, o_s:o_s + c_s, o_s:o_s + c_s, :])
    first = devices[0]
    out = torch.cat([piece.to(first) for piece in cores]) if n_dev > 1 else torch.cat(cores)
    out = out.reshape(ny, nx, c_s, c_s, c)
    out = out.permute(0, 2, 1, 3, 4).reshape(ny * c_s, nx * c_s, c)
    return out[:h * scale, :w * scale].cpu().numpy()
