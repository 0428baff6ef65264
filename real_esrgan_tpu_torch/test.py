"""Directory evaluation CLI: the port of the root ``test.py``.

    python -m real_esrgan_tpu_torch.test --lr_dir data/Set5/LRbicx4 \\
        --sr_dir results/test/run --model_path assets/inenv10_esrnet_ema.npz

Super-resolves every image of ``--lr_dir`` in natural order, writes the
outputs to ``--sr_dir`` and prints each image's NIQE and the mean clamped to
100; where ``--hr_dir`` holds a same-named ground truth of the output's
shape, PSNR is printed as well.  Same flags as the JAX CLI, plus ``--cpu``:
without it the run needs a CUDA device, and a tiled image spreads its tile
batches over every visible GPU.  A distributed launch (``parallel/mesh.py``)
joins its process group first, as the JAX CLI does.  The defaults are the
literals of the repository's test configuration.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from real_esrgan_tpu_torch.metrics.niqe import DEFAULT_MODEL_PATH, NIQE
from real_esrgan_tpu_torch.parallel.mesh import local_devices, process_group
from real_esrgan_tpu_torch.serve import SRPipeline
from real_esrgan_tpu_torch.utils.imgio import (
    array_to_image, load_image_rgb, natsorted_files, save_image_rgb,
)
from real_esrgan_tpu_torch.utils.meters import AverageMeter


def psnr_db(sr: np.ndarray, hr: np.ndarray) -> float:
    """PSNR of two [0, 1] images in dB, in float64; 99 for identical images."""
    mse = float(np.mean((sr.astype(np.float64) - hr) ** 2))
    return 10 * np.log10(1.0 / mse) if mse > 0 else 99.0


def main(args) -> float:
    with process_group("gloo" if args.cpu else None):
        return evaluate(args)


def evaluate(args) -> float:
    devices = [torch.device("cpu")] if args.cpu else local_devices()
    device = devices[0]
    have_weights = bool(args.model_path and os.path.exists(args.model_path))
    pipeline = SRPipeline(weights_path=args.model_path if have_weights else "",
                          upscale_factor=args.upscale_factor, bfloat16=args.bfloat16,
                          devices=devices)
    if have_weights:
        print(f"Loaded `{args.model_path}` weights.")
    else:
        print("WARNING: no weights file found — using random initialization.")

    niqe_model = NIQE(crop_border=args.upscale_factor, model_path=args.niqe_model_path,
                      device=device)

    os.makedirs(args.sr_dir, exist_ok=True)
    niqe_meter = AverageMeter("NIQE", "4.2f")
    psnr_meter = AverageMeter("PSNR", "5.2f")

    files = natsorted_files(args.lr_dir)
    if not files:
        raise FileNotFoundError(f"No image files found in {args.lr_dir}")
    for index, path in enumerate(files):
        sr_np = pipeline.upscale(load_image_rgb(path))[None]
        save_image_rgb(os.path.join(args.sr_dir, os.path.basename(path)), array_to_image(sr_np))

        score = float(niqe_model(sr_np)[0])
        niqe_meter.update(score, 1)
        line = f"[{index + 1}/{len(files)}] {os.path.basename(path)}  NIQE {score:4.2f}"

        hr_path = os.path.join(args.hr_dir or "", os.path.basename(path))
        if args.hr_dir and os.path.exists(hr_path):
            hr = load_image_rgb(hr_path)
            if hr.shape == sr_np[0].shape:
                psnr = psnr_db(sr_np[0], hr)
                psnr_meter.update(psnr, 1)
                line += f"  PSNR {psnr:5.2f} dB"
            else:
                line += f"  PSNR n/a (GT shape {hr.shape} != {sr_np[0].shape})"
        print(line)

    avg = min(niqe_meter.avg, 100.0)
    # the NIQE line stays the run's summary; the PSNR line is added only
    # when ground truths were found
    print(f"NIQE: {avg:4.2f} 100u")
    if psnr_meter.count:
        print(f"PSNR: {psnr_meter.avg:5.2f} dB ({psnr_meter.count} pairs)")
    return avg


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Batch SR evaluation with NIQE (PyTorch/CUDA)")
    parser.add_argument("--lr_dir", type=str, default="./data/Set5/LRbicx4")
    parser.add_argument("--sr_dir", type=str, default="./results/test/RealESRNet_baseline")
    parser.add_argument("--hr_dir", type=str, default="./data/Set5/GTmod12")
    parser.add_argument("--model_path", type=str, default="")
    parser.add_argument("--niqe_model_path", type=str, default=DEFAULT_MODEL_PATH)
    parser.add_argument("--upscale_factor", type=int, default=4)
    parser.add_argument("--bfloat16", action="store_true")
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU instead of CUDA.")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
