"""Tiled-serving geometry sweep: find the best (tile, overlap, tile_batch).
The port of ``tools/tile_sweep.py``.

The 2K->8K tiled-serving metric (``bench --mode tiled``) runs the same
network as flagship inference, so the gap between them is geometry overhead:

  * halo fraction: only (core/tile)^2 of each tile's output is kept
    (core = tile - 2*overlap); tile=256/overlap=16 keeps 76.6%,
  * canvas waste: ny = ceil(H/core) rounds the canvas up (2048/224 -> 2240,
    +9.6% padded pixels).

The port's last tile batch holds only the tiles that are left, so it wastes
no forward on repeated tiles; ``useful_frac`` is the share of the computed
output pixels kept.  Geometries whose core divides 2048 (272/8 -> core 256,
64 tiles) remove the canvas waste.  ``--seam`` also scores each geometry's
worst seam error against a whole-image forward on a 512^2 crop of
``tests/data/tree_sr.png``, so overlap can be shrunk with evidence.

Usage (on the GPUs; ``--cpu`` on the CPU, a check of the tool):
  python -m real_esrgan_tpu_torch.tools.tile_sweep                 # throughput, 2K->8K
  python -m real_esrgan_tpu_torch.tools.tile_sweep --seam          # + seam error at 512^2
  python -m real_esrgan_tpu_torch.tools.tile_sweep --stages        # halo vs gather/stitch
  python -m real_esrgan_tpu_torch.tools.tile_sweep --combos "528,8,8;272,8,16" --seam
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Callable, List, Sequence

import numpy as np
import torch

from real_esrgan_tpu_torch.parallel.mesh import local_devices
from real_esrgan_tpu_torch.parallel.tiling import (
    pad_for_tiles, round_tile_batch, tile_grid, tiled_canvas, tiled_upscale,
)
from real_esrgan_tpu_torch.serve import generator_replicas, no_grad_forward
from real_esrgan_tpu_torch.train.checkpoint import load_generator_params
from real_esrgan_tpu_torch.utils.imgio import load_image_rgb

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEAM_IMAGE = os.path.join(REPO_ROOT, "tests", "data", "tree_sr.png")

# (tile, overlap, tile_batch) candidates.  272/8 and 264/4 have core sizes
# (256) that divide 2048; 144/8 probes the small-tile regime; 256/16 has the
# widest halo; 528/8 has a core of 512 and keeps 94.0% of each tile.
DEFAULT_COMBOS = (
    (256, 16, 8),
    (256, 16, 16),
    (256, 8, 16),
    (272, 8, 16),    # core 256: zero canvas waste, 64 tiles = 4 full batches
    (264, 4, 16),    # core 256, thinner halo
    (288, 16, 16),   # core 256, conservative halo
    (144, 8, 32),    # core 128: zero waste, small-tile regime
    (528, 8, 8),     # core 512: the serving default, 94.0% halo-useful
)

Forward = Callable[[torch.Tensor], torch.Tensor]


def build_apply(weights: str | None, num_rrdb: int = 23, devices=None,
                bfloat16: bool = True) -> List[Forward]:
    """One generator replica a device (bf16 by default), weights from
    ``weights`` or drawn from seed 0, each as its ``no_grad`` forward."""
    devices = devices if devices is not None else local_devices()
    state_dict = load_generator_params(weights) if weights else None
    return [no_grad_forward(m) for m in generator_replicas(
        devices, state_dict, upscale_factor=4, num_rrdb=num_rrdb,
        dtype=torch.bfloat16 if bfloat16 else torch.float32)]


def _useful(in_size: int, tile: int, ny: int, nx: int) -> float:
    """The share of the computed output pixels that the image keeps."""
    return in_size ** 2 / (ny * nx * tile ** 2)


def _padded_on(devices, in_size: int, tile: int, overlap: int) -> dict:
    rng = np.random.default_rng(0)
    padded = np.ascontiguousarray(pad_for_tiles(
        rng.random((in_size, in_size, 3)).astype(np.float32), tile, overlap))
    return {d: torch.from_numpy(padded).to(d) for d in dict.fromkeys(devices)}


def _mean_read(out: torch.Tensor) -> float:
    return float(out[:8, :8].mean())


def _timed(fn, iters: int, read=_mean_read) -> tuple:
    """(seconds of the first call, seconds a call over ``iters`` more), each
    call closed by one scalar read."""
    t0 = time.perf_counter()
    read(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        read(fn())
    return first, (time.perf_counter() - t0) / iters


def measure_geometry(apply_fn: Sequence[Forward], devices, in_size: int, tile: int,
                     overlap: int, tile_batch: int, iters: int) -> dict:
    """Throughput of ``tiled_canvas`` at one geometry, the image padded and
    on the devices before the timed calls; ``compile_s`` is the first call
    (the kernels' build, cuDNN's first choices)."""
    devices = [torch.device(d) for d in devices]
    ny, nx, _ = tile_grid(in_size, in_size, tile, overlap)
    batch = round_tile_batch(tile_batch, len(devices))
    n_batches = math.ceil(ny * nx / batch)
    on_device = _padded_on(devices, in_size, tile, overlap)
    first, per_call = _timed(lambda: tiled_canvas(apply_fn, on_device, ny, nx, tile, overlap,
                                                  tile_batch, 4, devices), iters)
    return {"tile": tile, "overlap": overlap, "tile_batch": batch,
            "tiles": ny * nx, "batches": n_batches,
            "useful_frac": round(_useful(in_size, tile, ny, nx), 3),
            "mp_per_s": round((in_size * 4) ** 2 / 1e6 / per_call, 3),
            "compile_s": round(first, 1)}


def stage_breakdown(apply_fn: Sequence[Forward], devices, in_size: int, tile: int,
                    overlap: int, tile_batch: int, iters: int) -> dict:
    """Per-stage residual table for one geometry: the tiled-vs-flagship gap
    split into

      * halo compute: the network runs on ``tile^2`` pixels but only
        ``core^2`` are kept; ``raw_net_s`` (the same batched forwards on
        tiles made beforehand, no gather or stitch) scaled by the share not
        kept;
      * gather + stitch + dispatch: ``tiled_s - raw_net_s``, the tile slices,
        the core stitch and the host's loop over batches.

    Both end in one scalar read a call."""
    devices = [torch.device(d) for d in devices]
    ny, nx, _ = tile_grid(in_size, in_size, tile, overlap)
    batch = round_tile_batch(tile_batch, len(devices))
    sizes = [min(batch, ny * nx - s) for s in range(0, ny * nx, batch)]
    on_device = _padded_on(devices, in_size, tile, overlap)
    rng = np.random.default_rng(0)
    host_tiles = torch.from_numpy(rng.random((batch, tile, tile, 3)).astype(np.float32))
    tiles = {d: host_tiles.to(d) for d in dict.fromkeys(devices)}

    def raw_net() -> List[torch.Tensor]:
        # the tiled call's batch sizes and chunks, with no tiling stages
        means = []
        for size in sizes:
            for d, fn, part in zip(devices, apply_fn, torch.tensor_split(torch.arange(size),
                                                                        len(devices))):
                if len(part):
                    means.append(fn(tiles[d][:len(part)]).float().mean())
        return means

    _, raw_s = _timed(raw_net, iters, read=lambda means: sum(float(m) for m in means))
    _, tiled_s = _timed(lambda: tiled_canvas(apply_fn, on_device, ny, nx, tile, overlap,
                                             tile_batch, 4, devices), iters)
    useful = _useful(in_size, tile, ny, nx)
    out_mp = (in_size * 4) ** 2 / 1e6
    return {"tile": tile, "overlap": overlap, "tile_batch": batch,
            "useful_frac": round(useful, 3),
            "raw_net_s": round(raw_s, 4),
            "tiled_s": round(tiled_s, 4),
            "gather_stitch_s": round(tiled_s - raw_s, 4),
            "halo_compute_s": round(raw_s * (1 - useful), 4),
            "tiled_mp_per_s": round(out_mp / tiled_s, 3),
            "net_only_mp_per_s": round(out_mp / raw_s, 3),
            "zero_overhead_mp_per_s": round(out_mp / (raw_s * useful), 3)}


def seam_error(apply_fn: Sequence[Forward], devices, tile: int, overlap: int,
               tile_batch: int, in_size: int = 512) -> dict:
    """max/mean/p99.9 abs difference, tiled against a whole-image forward,
    on real pixels in 8-bit levels (255 * diff): all of it, and the interior
    (64 output pixels in from the border).  The border differs for a reason
    unrelated to overlap: the tiled canvas is reflect-padded while the
    whole-image forward sees zero padding."""
    try:
        img = load_image_rgb(SEAM_IMAGE)[:in_size, :in_size]
        if img.shape[0] < in_size or img.shape[1] < in_size:
            img = np.pad(img, ((0, in_size - img.shape[0]), (0, in_size - img.shape[1]),
                               (0, 0)), "reflect")
    except (OSError, ValueError):
        img = np.random.default_rng(0).random((in_size, in_size, 3)).astype(np.float32)
    img = np.ascontiguousarray(img, np.float32)

    first = torch.device(devices[0])
    whole = apply_fn[0](torch.from_numpy(img)[None].to(first))[0].float().cpu().numpy()
    tiled = tiled_upscale(list(apply_fn), img, scale=4, tile=tile, overlap=overlap,
                          tile_batch=tile_batch, devices=devices)
    diff = np.abs(whole - tiled) * 255.0
    b = 64  # 16 input px * scale 4
    interior = diff[b:-b, b:-b]

    def stats(d):
        return {"max": round(float(d.max()), 3), "mean": round(float(d.mean()), 5),
                "p999": round(float(np.quantile(d, 0.999)), 3)}

    return {"all_8bit": stats(diff), "interior_8bit": stats(interior)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--in-size", type=int, default=2048)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--weights", default="",
                   help="checkpoint for realistic activations (seam check)")
    p.add_argument("--seam", action="store_true",
                   help="also score seam error vs whole-image at 512^2")
    p.add_argument("--stages", action="store_true",
                   help="per-stage residual table (halo compute vs gather/stitch) instead "
                        "of the plain throughput row")
    p.add_argument("--combos", default="", help="override: 'tile,ov,batch;tile,ov,batch;...'")
    p.add_argument("--num-rrdb", type=int, default=23,
                   help="trunk depth (reduce for CPU smoke tests)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    a = p.parse_args(argv)

    combos = DEFAULT_COMBOS
    if a.combos:
        combos = tuple(tuple(int(v) for v in c.split(",")) for c in a.combos.split(";"))

    devices = [torch.device("cpu")] if a.cpu else local_devices()
    forwards = build_apply(a.weights or None, a.num_rrdb, devices)
    for tile, ov, tb in combos:
        if a.stages:
            print(json.dumps(stage_breakdown(forwards, devices, a.in_size, tile, ov, tb,
                                             a.iters)), flush=True)
            continue
        row = measure_geometry(forwards, devices, a.in_size, tile, ov, tb, a.iters)
        if a.seam:
            row["seam"] = seam_error(forwards, devices, tile, ov, tb)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
