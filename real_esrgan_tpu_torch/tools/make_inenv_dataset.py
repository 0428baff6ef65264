"""Build the in-env quality dataset with held-out eval regions: the port of
``tools/make_inenv_dataset.py``.

Assembles every real photograph it is given: the 2 MP outdoor tree photo
(``tests/data/tree_sr.png``), matplotlib's 0.3 MP indoor Grace Hopper
portrait (``--hopper``), and, with ``--textures``, the photographic texture
assets some installed packages bundle (``TEXTURE_SRCS``: wood grain, marble,
skin, grass, a 3 MP outdoor skybox); a texture that cannot be read is
skipped and named.  Training on crops of one photo bakes that photo's colour
statistics into the generator, so the quality runs train on spatially
disjoint crops of every source and evaluate on held-out regions the trainer
never saw:

  tree     train: rows 0:512 x cols 512:2048  +  rows 512:1024 x cols 0:2048
           eval:  rows 0:512 x cols 0:512     (top-left 512x512)
  hopper   train: rows 0:400                  (400x512)
           eval:  rows 400:600                (bottom 200x512 strip)
  textures train: rows 256:H                  (per image)
           eval:  rows 0:256                  (top strip; images too small
                                               to split train-only)

Hopper train crops are file-replicated (``--hopper-repeat``) so the minority
photo stays a meaningful share of each epoch.  Images are read through
``utils/imgio.py::load_image_rgb`` (a PNG without cv2; any other format
needs cv2) and written as PNGs by ``write_png``: the same pixels the JAX
tool's cv2 round trip writes.  Eval pairs are MATLAB-bicubic
``LRbicx4``/``GTmod4`` made by the port's ``scripts.make_lr`` on the tool's
device, PSNR-ready for ``scripts.eval_pair``; ``eval_src/`` feeds
``scripts.make_degraded_eval``.

    python -m real_esrgan_tpu_torch.tools.make_inenv_dataset --out data/InEnv2 --hopper <photo>
    python -m real_esrgan_tpu_torch.tools.make_inenv_dataset --out data/InEnv10 --textures

Runs the pairs' resize on CUDA; ``--cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sysconfig

import numpy as np

from real_esrgan_tpu_torch import resolve_device
from real_esrgan_tpu_torch.utils.imgio import load_image_rgb, write_png

# installed packages' data files, under this interpreter's site-packages
_SP = sysconfig.get_paths()["purelib"]
HOPPER_SRC = os.path.join(_SP, "matplotlib", "mpl-data", "sample_data", "grace_hopper.jpg")

# Photographic texture assets bundled with simulator packages: real camera
# imagery (wood grain, marble, skin, grass, outdoor skybox)
TEXTURE_SRCS = [
    ("wood", f"{_SP}/gymnasium_robotics/envs/assets/kitchen_franka/"
             "kitchen_assets/textures/wood1.png"),
    ("darkwood", f"{_SP}/gymnasium_robotics/envs/assets/adroit_hand/"
                 "resources/textures/darkwood.png"),
    ("skin", f"{_SP}/gymnasium_robotics/envs/assets/adroit_hand/"
             "resources/textures/skin.png"),
    ("dogskin", f"{_SP}/dm_control/suite/dog_assets/skin_texture.png"),
    ("marble", f"{_SP}/gymnasium_robotics/envs/assets/kitchen_franka/"
               "kitchen_assets/textures/white_marble_tile.png"),
    ("marble2", f"{_SP}/gymnasium_robotics/envs/assets/kitchen_franka/"
                "kitchen_assets/textures/white_marble_tile2.png"),
    ("skybox", f"{_SP}/dm_control/locomotion/arenas/assets/"
               "outdoor_natural/OutdoorSkybox2048.png"),
    ("grass", f"{_SP}/dm_control/locomotion/arenas/assets/"
              "outdoor_natural/OutdoorGrassFloorD.png"),
]


def read_rgb8(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of an image file, as cv2 reads its colour."""
    return np.rint(load_image_rgb(path) * 255.0).astype(np.uint8)


def read_source(path: str, flag: str) -> np.ndarray:
    """A required source image; says which flag names it when it cannot be read."""
    try:
        return read_rgb8(path)
    except ImportError:
        raise SystemExit(f"{flag} {path}: only PNG reads without cv2; give {flag} a PNG")
    except (OSError, ValueError) as exc:
        raise SystemExit(f"{flag} {path}: cannot read it ({exc}); give {flag} an image file")


def sliding_crops(image: np.ndarray, size: int, step: int):
    h, w = image.shape[:2]
    for top in list(range(0, h - size + 1, step)) or [0]:
        for left in list(range(0, w - size + 1, step)) or [0]:
            yield image[top:top + size, left:left + size]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="data/InEnv2")
    p.add_argument("--tree", default="tests/data/tree_sr.png")
    p.add_argument("--hopper", default=HOPPER_SRC,
                   help="the second photograph (default: matplotlib's sample JPEG, which "
                        "reads only through cv2)")
    p.add_argument("--crop-size", type=int, default=400)
    p.add_argument("--tree-step", type=int, default=48)
    p.add_argument("--hopper-step", type=int, default=8)
    p.add_argument("--hopper-repeat", type=int, default=6)
    p.add_argument("--textures", action="store_true",
                   help="also include the site-packages photographic texture assets "
                        "(TEXTURE_SRCS)")
    p.add_argument("--texture-step", type=int, default=128)
    p.add_argument("--cpu", action="store_true", help="make the eval pairs on the CPU")
    return p


def main(argv=None) -> None:
    a = build_parser().parse_args(argv)
    device = resolve_device(a.cpu)  # no GPU and no --cpu: an error before any file
    tree = read_source(a.tree, "--tree")
    hopper = read_source(a.hopper, "--hopper")

    train_dir = os.path.join(a.out, "train")
    eval_src = os.path.join(a.out, "eval_src")
    shutil.rmtree(a.out, ignore_errors=True)
    os.makedirs(train_dir)
    os.makedirs(eval_src)

    n = 0
    train_regions = [("tree_a", tree[0:512, 512:2048]),
                     ("tree_b", tree[512:1024, 0:2048])]
    for name, region in train_regions:
        for crop in sliding_crops(region, a.crop_size, a.tree_step):
            n += 1
            write_png(os.path.join(train_dir, f"{name}_{n:04d}.png"), crop)
    n_tree = n
    hopper_crops = list(sliding_crops(hopper[0:400], a.crop_size, a.hopper_step))
    for rep in range(a.hopper_repeat):
        for i, crop in enumerate(hopper_crops):
            n += 1
            write_png(os.path.join(train_dir, f"hopper_r{rep}_{i:04d}.png"), crop)
    print(f"train crops: {n_tree} tree + {n - n_tree} hopper "
          f"({len(hopper_crops)} unique x{a.hopper_repeat}) = {n}")

    write_png(os.path.join(eval_src, "tree_heldout.png"), tree[0:512, 0:512])
    write_png(os.path.join(eval_src, "hopper_heldout.png"), hopper[400:600, 0:512])

    if a.textures:
        eval_rows = 256
        for tex_name, path in TEXTURE_SRCS:
            try:
                img = read_rgb8(path)
            except (ImportError, OSError, ValueError):
                print(f"texture {tex_name}: unreadable at {path}, skipped")
                continue
            if img.shape[0] - eval_rows >= a.crop_size:
                write_png(os.path.join(eval_src, f"{tex_name}_heldout.png"), img[0:eval_rows])
                region = img[eval_rows:]
            else:
                region = img  # too small to split: train-only
            n_before = n
            for crop in sliding_crops(region, a.crop_size, a.texture_step):
                n += 1
                write_png(os.path.join(train_dir, f"{tex_name}_{n:04d}.png"), crop)
            held = "held-out top strip" if region is not img else "train-only"
            print(f"texture {tex_name}: {n - n_before} crops ({held})")

    from real_esrgan_tpu_torch.scripts import make_lr

    make_lr.main(["--gt-dir", eval_src, "--output-dir", os.path.join(a.out, "eval"),
                  "--scale", "4"] + (["--cpu"] if device.type == "cpu" else []))
    print(f"dataset at {a.out}: train/ + eval/{{GTmod4,LRbicx4}}")


if __name__ == "__main__":
    main()
