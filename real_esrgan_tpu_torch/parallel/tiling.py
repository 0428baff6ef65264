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
from typing import Callable, List, Mapping, Sequence, Tuple, Union

import numpy as np
import torch

ApplyFn = Callable[[torch.Tensor], torch.Tensor]


def round_tile_batch(tile_batch: int, n_devices: int) -> int:
    """``tile_batch`` rounded down to a multiple of ``n_devices`` (at least one
    tile a device)."""
    if tile_batch % n_devices:
        tile_batch = max(n_devices, (tile_batch // n_devices) * n_devices)
    return tile_batch


def tile_grid(h: int, w: int, tile: int, overlap: int) -> Tuple[int, int, int]:
    """(ny, nx, core): the tiles down and across an (h, w) image and the core
    stride, ``tile - 2 * overlap``."""
    core = tile - 2 * overlap
    if core <= 0:
        raise ValueError("overlap too large for tile size")
    return max(1, math.ceil(h / core)), max(1, math.ceil(w / core)), core


def pad_for_tiles(image: np.ndarray, tile: int, overlap: int) -> np.ndarray:
    """The (H, W, C) image reflect-padded to the tile grid's canvas: a halo
    of ``overlap`` on every side and the last core cells filled out."""
    h, w, _ = image.shape
    ny, nx, core = tile_grid(h, w, tile, overlap)
    return np.pad(image, ((overlap, overlap + ny * core - h),
                          (overlap, overlap + nx * core - w), (0, 0)), mode="reflect")


def _per_device(apply_fn, devices) -> List[ApplyFn]:
    fns = list(apply_fn) if isinstance(apply_fn, Sequence) else [apply_fn] * len(devices)
    if len(fns) != len(devices):
        raise ValueError(f"{len(fns)} apply functions for {len(devices)} devices")
    return fns


def tiled_canvas(apply_fn: Union[ApplyFn, Sequence[ApplyFn]],
                 padded: Union[torch.Tensor, Mapping[torch.device, torch.Tensor]],
                 ny: int, nx: int, tile: int, overlap: int, tile_batch: int,
                 scale: int = 4, devices=None) -> torch.Tensor:
    """The device part of ``tiled_upscale`` (the counterpart of the JAX
    package's ``_build_tiled_fn``): the padded image (``pad_for_tiles``),
    already on each device, in; the stitched (ny * core * scale, nx * core *
    scale, C) canvas out, on the first device, with nothing copied to the
    host.

    ``padded`` is the padded image on its device, or a mapping of each device
    of ``devices`` to its copy there.  ``apply_fn`` and ``devices`` are as in
    ``tiled_upscale``; ``tile_batch`` is rounded to a multiple of the device
    count.  The tiles run in ``ceil(ny * nx / tile_batch)`` batches, the last
    one holding only the tiles that are left."""
    if devices is None:
        devices = [padded.device] if isinstance(padded, torch.Tensor) else list(padded)
    devices = [torch.device(d) for d in devices]
    if isinstance(padded, torch.Tensor):
        padded = {d: padded for d in devices}
    fns = _per_device(apply_fn, devices)
    n_dev = len(devices)
    tile_batch = round_tile_batch(tile_batch, n_dev)
    n_tiles = ny * nx
    core = tile - 2 * overlap
    c_s, o_s = core * scale, overlap * scale
    cores = []
    for start in range(0, n_tiles, tile_batch):
        batch = torch.arange(start, min(start + tile_batch, n_tiles))
        for d, fn, flat in zip(devices, fns, torch.tensor_split(batch, n_dev)):
            if len(flat) == 0:
                continue
            src = padded[d]
            tiles = torch.stack([src[(i // nx) * core:(i // nx) * core + tile,
                                     (i % nx) * core:(i % nx) * core + tile]
                                 for i in flat.tolist()])
            sr = fn(tiles)
            cores.append(sr[:, o_s:o_s + c_s, o_s:o_s + c_s, :])
    first = devices[0]
    out = torch.cat([piece.to(first) for piece in cores]) if n_dev > 1 else torch.cat(cores)
    channels = out.shape[-1]
    out = out.reshape(ny, nx, c_s, c_s, channels)
    return out.permute(0, 2, 1, 3, 4).reshape(ny * c_s, nx * c_s, channels)


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

    The host part: pads the image (``pad_for_tiles``), copies it once to each
    device, runs ``tiled_canvas`` and brings the canvas, cropped to the
    image, back to the host.  The 528/8/8 default makes the core 512, which
    divides 2K inputs; an overlap of 8 input pixels covers the generator's
    receptive field well enough that interior seams sit at the bf16 noise
    floor (``chip_smoke.py`` measures the seam error on the card).
    """
    devices = [torch.device(d) for d in devices] if devices is not None else [
        torch.device(device if device is not None else "cpu")]
    h, w, _ = image.shape
    ny, nx, _ = tile_grid(h, w, tile, overlap)
    host = torch.from_numpy(np.ascontiguousarray(pad_for_tiles(image, tile, overlap),
                                                 np.float32))
    on_device = {d: host.to(d) for d in dict.fromkeys(devices)}
    out = tiled_canvas(apply_fn, on_device, ny, nx, tile, overlap, tile_batch, scale, devices)
    return out[:h * scale, :w * scale].cpu().numpy()
