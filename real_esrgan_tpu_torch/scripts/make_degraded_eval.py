"""Synthesize an in-distribution degraded eval set from held-out GT images:
the port of ``scripts/make_degraded_eval.py``.

Applies the trainers' fused second-order degradation (``ops/degradation.
degrade``) to tiles of held-out ground-truth images and writes aligned
(LR, HR) pairs to ``<out>/LRx{scale}`` and ``<out>/GTmod{scale}``, so
held-out PSNR can be measured in the input regime the model is trained on
(blurred, noisy, JPEG-compressed), not only on clean bicubic LR::

    python -m real_esrgan_tpu_torch.scripts.make_degraded_eval --gt-dir data/InEnv2/eval_src \\
        --output-dir data/InEnv2/eval_degraded --seed 7 [--cpu]
    python -m real_esrgan_tpu_torch.scripts.eval_pair --weights <weights> \\
        --lr-dir data/InEnv2/eval_degraded/LRx4 --hr-dir data/InEnv2/eval_degraded/GTmod4
    python -m real_esrgan_tpu_torch.scripts.eval_pair --bicubic ...   # the no-model baseline

Each tile draws its own per-sample degradation (kernels, noise, JPEG
quality) and each batch its own per-batch choices (resize kind, scale and
mode, noise family), as a training step does, so the set spans the
severity distribution.  Runs on CUDA; ``--cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch

from real_esrgan_tpu_torch import resolve_device
from real_esrgan_tpu_torch.configuration import (
    DegradationConfig, KernelSynthesisConfig, PipelineGeometry,
)
from real_esrgan_tpu_torch.ops.degradation import degrade
from real_esrgan_tpu_torch.utils.imgio import load_image_rgb, natsorted_files, save_image_rgb


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--gt-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hr-size", type=int, default=400,
                   help="tile size cut from each GT image (degradation "
                        "pipeline input size)")
    p.add_argument("--crop-size", type=int, default=256,
                   help="HR size of each written pair (centre of the tile "
                        "after degradation)")
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--cpu", action="store_true", help="Run on the CPU instead of CUDA.")
    a = p.parse_args(argv)
    device = resolve_device(a.cpu)

    geo = PipelineGeometry(hr_size=a.hr_size, crop_size=a.crop_size, scale=a.scale)
    kcfg = KernelSynthesisConfig()
    dcfg = DegradationConfig()

    lr_dir = os.path.join(a.output_dir, f"LRx{a.scale}")
    hr_dir = os.path.join(a.output_dir, f"GTmod{a.scale}")
    os.makedirs(lr_dir, exist_ok=True)
    os.makedirs(hr_dir, exist_ok=True)

    tiles, names = [], []
    for path in natsorted_files(a.gt_dir):
        img = load_image_rgb(path)                      # float32 [0,1] HWC
        stem = os.path.splitext(os.path.basename(path))[0]
        h, w = img.shape[:2]
        idx = 0
        for y in range(0, h - a.hr_size + 1, a.hr_size):
            for x in range(0, w - a.hr_size + 1, a.hr_size):
                tile = img[y:y + a.hr_size, x:x + a.hr_size]
                tiles.append((tile * 255.0 + 0.5).astype(np.uint8))
                names.append(f"{stem}_{idx:03d}")
                idx += 1
        if idx == 0:
            print(f"skipping {path}: smaller than --hr-size {a.hr_size}")

    if not tiles:
        raise SystemExit("no tiles produced — images smaller than --hr-size?")

    # augment=False: pairs stay in the source orientation so a human can
    # compare them against the GT photo; degradations still randomize.
    coin = random.Random(a.seed)
    host = torch.Generator().manual_seed(a.seed)
    generator = torch.Generator(device=device).manual_seed(a.seed)

    written = 0
    for start in range(0, len(tiles), a.batch_size):
        batch = tiles[start:start + a.batch_size]
        pad = a.batch_size - len(batch)           # every batch has the same shape
        hr_uint8 = torch.from_numpy(np.stack(batch + batch[:1] * pad)).to(device)
        up1 = coin.random() < dcfg.resize_probs1[0]
        up2 = coin.random() < dcfg.resize_probs2[0]
        lr, hr = degrade(generator, hr_uint8, geo, kcfg, dcfg, augment=False,
                         up1=up1, up2=up2, host_generator=host)
        lr = np.clip(lr.cpu().numpy(), 0.0, 1.0)
        hr = np.clip(hr.cpu().numpy(), 0.0, 1.0)
        for i, name in enumerate(names[start:start + a.batch_size]):
            save_image_rgb(os.path.join(lr_dir, f"{name}.png"), lr[i])
            save_image_rgb(os.path.join(hr_dir, f"{name}.png"), hr[i])
            written += 1
    print(f"wrote {written} degraded (LR, HR) pairs to {a.output_dir} "
          f"(LR {a.crop_size // a.scale}px, HR {a.crop_size}px, "
          f"seed {a.seed}, device {device.type})")


if __name__ == "__main__":
    main()
