"""Generate MATLAB-bicubic LR pairs from a ground-truth image directory: the
port of ``scripts/make_lr.py``.

Produces the ``GTmod{scale}`` / ``LRbicx{scale}`` layout the valid and test
sets use (``Set5/LRbicx4``): each GT image is mod-cropped to a multiple of
``--scale`` and downscaled with the MATLAB-exact antialiased bicubic
(``ops/resize.py::matlab_resize``), so PSNR against the cropped GT is
alignment-exact.  The resize runs on the GPU; ``--cpu`` runs it on the CPU.

    python -m real_esrgan_tpu_torch.scripts.make_lr --gt-dir photos/ \\
        --output-dir data/Heldout --scale 4
"""

from __future__ import annotations

import argparse
import os

import torch

from real_esrgan_tpu_torch.ops.resize import matlab_resize
from real_esrgan_tpu_torch.parallel.mesh import local_device
from real_esrgan_tpu_torch.utils.imgio import load_image_rgb, natsorted_files, save_image_rgb


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--gt-dir", required=True)
    p.add_argument("--output-dir", required=True,
                   help="writes <output-dir>/GTmod<scale> and <output-dir>/LRbicx<scale>")
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--cpu", action="store_true", help="resize on the CPU")
    a = p.parse_args(argv)
    device = local_device(a.cpu)

    gt_out = os.path.join(a.output_dir, f"GTmod{a.scale}")
    lr_out = os.path.join(a.output_dir, f"LRbicx{a.scale}")
    os.makedirs(gt_out, exist_ok=True)
    os.makedirs(lr_out, exist_ok=True)

    n = 0
    for path in natsorted_files(a.gt_dir):
        gt = load_image_rgb(path)  # float32 [0,1] HWC
        h = gt.shape[0] - gt.shape[0] % a.scale
        w = gt.shape[1] - gt.shape[1] % a.scale
        if h < a.scale or w < a.scale:
            continue
        gt = gt[:h, :w]
        lr = matlab_resize(torch.from_numpy(gt).to(device), 1.0 / a.scale)
        lr = lr.clamp(0.0, 1.0).cpu().numpy()
        name = os.path.splitext(os.path.basename(path))[0] + ".png"
        save_image_rgb(os.path.join(gt_out, name), gt)
        save_image_rgb(os.path.join(lr_out, name), lr)
        n += 1
        print(f"{name}: GT {gt.shape[0]}x{gt.shape[1]} -> LR {lr.shape[0]}x{lr.shape[1]}")
    print(f"wrote {n} pairs to {a.output_dir} on {device.type}")


if __name__ == "__main__":
    main()
