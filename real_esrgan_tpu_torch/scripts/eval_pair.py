"""Score generator weights on aligned LR/HR pairs, PSNR and NIQE per image:
the port of ``scripts/eval_pair.py``.

PSNR against the aligned ground truth tracks convergence; NIQE tracks
perceptual quality once outputs look natural.  Takes reference ``.pth.tar``
files and compact ``.npz`` snapshots; an Orbax checkpoint directory raises
and names the script that converts it.

    python -m real_esrgan_tpu_torch.scripts.eval_pair --weights assets/inenv10_esrnet_ema.npz \\
        --lr-dir data/Set5/LRbicx4 --hr-dir data/Set5/GTmod12 [--use-params] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from real_esrgan_tpu_torch import resolve_device
from real_esrgan_tpu_torch.metrics.niqe import NIQE
from real_esrgan_tpu_torch.ops.resize import matlab_resize
from real_esrgan_tpu_torch.serve import SRPipeline
from real_esrgan_tpu_torch.test import psnr_db
from real_esrgan_tpu_torch.train.checkpoint import load_generator_params
from real_esrgan_tpu_torch.utils.imgio import load_image_rgb, natsorted_files


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--weights",
                   help="reference .pth.tar or .npz snapshot (omit with --bicubic)")
    p.add_argument("--bicubic", action="store_true",
                   help="score MATLAB-bicubic upscaling instead of a model: the "
                        "no-model baseline every SR result must beat")
    p.add_argument("--lr-dir", required=True)
    p.add_argument("--hr-dir", required=True)
    p.add_argument("--upscale-factor", type=int, default=4)
    p.add_argument("--num-rrdb", type=int, default=23)
    p.add_argument("--use-params", action="store_true",
                   help="score raw params instead of EMA (EMA stays near the init "
                        "for the first few thousand steps; short runs must use this)")
    p.add_argument("--cpu", action="store_true", help="Run on the CPU instead of CUDA.")
    return p


def main(argv=None) -> dict:
    p = build_parser()
    a = p.parse_args(argv)
    device = resolve_device(a.cpu)

    if a.bicubic:
        def upscale(lr):
            up = matlab_resize(torch.from_numpy(lr).to(device)[None], float(a.upscale_factor))
            return up[0].clamp(0.0, 1.0).cpu().numpy()
    else:
        if not a.weights:
            p.error("--weights is required unless --bicubic is given")
        pipeline = SRPipeline(upscale_factor=a.upscale_factor, num_rrdb=a.num_rrdb,
                              device=device)
        pipeline.model.load_state_dict(
            load_generator_params(a.weights, prefer_ema=not a.use_params))
        upscale = pipeline.upscale
    niqe_model = NIQE(crop_border=a.upscale_factor, device=device)

    psnrs, niqes = [], []
    by_source: dict = {}
    for path in natsorted_files(a.lr_dir):
        hr_path = os.path.join(a.hr_dir, os.path.basename(path))
        sr = upscale(load_image_rgb(path))
        hr = load_image_rgb(hr_path)
        if sr.shape != hr.shape:
            raise ValueError(f"{path}: SR {sr.shape} vs HR {hr.shape}")
        psnr = psnr_db(sr, hr)
        psnrs.append(psnr)
        # group tiles like "wood_heldout_003.png" under source "wood"
        source = os.path.splitext(os.path.basename(path))[0].split("_")[0]
        by_source.setdefault(source, []).append(psnr)
        # NIQE needs at least one 96x96 block after the border crop, and
        # the MVG fit degenerates (NaN) with too few blocks
        if min(sr.shape[:2]) - 2 * a.upscale_factor >= 96:
            score = min(float(niqe_model(sr[None])[0]), 100.0)
            if np.isfinite(score):
                niqes.append(score)
                niqe_txt = f"{score:5.2f}"
            else:
                niqe_txt = "  n/a (degenerate fit: too few blocks)"
        else:
            niqe_txt = "  n/a (image < 96px)"
        print(f"{os.path.basename(path)}: PSNR {psnr:5.2f} dB  NIQE {niqe_txt}")
    summary = {"psnr_mean": round(float(np.mean(psnrs)), 3),
               "niqe_mean": round(float(np.mean(niqes)), 3) if niqes else None,
               "n": len(psnrs),
               "which": "bicubic" if a.bicubic else "params" if a.use_params else "ema"}
    if len(by_source) > 1:
        summary["psnr_by_source"] = {
            s: round(float(np.mean(v)), 2) for s, v in sorted(by_source.items())}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
