"""Single-image super-resolution CLI: the port of the root ``inference.py``.

    python -m real_esrgan_tpu_torch.inference --inputs_path tests/data/tree_lr.png \\
        --output_path sr.png --weights_path assets/inenv10_esrnet_ema.npz

Same flags as the JAX CLI.  Runs on CUDA; ``--cpu`` runs on the CPU instead,
and without ``--cpu`` a machine with no CUDA device is an error.  With
``--tile`` each tile batch is spread over every visible GPU, one generator
replica a GPU, as the JAX CLI shards it over its mesh.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from real_esrgan_tpu_torch.parallel.mesh import local_devices
from real_esrgan_tpu_torch.parallel.tiling import tiled_upscale
from real_esrgan_tpu_torch.serve import generator_replicas, no_grad_forward
from real_esrgan_tpu_torch.train.checkpoint import load_generator_params
from real_esrgan_tpu_torch.utils.imgio import (
    array_to_image, image_to_array, load_image_rgb, save_image_rgb,
)


def main(args) -> str:
    # the tiled path spreads over every GPU; the whole image runs on the first
    devices = [torch.device("cpu")] if args.cpu else local_devices()
    if args.tile <= 0:
        devices = devices[:1]
    device = devices[0]
    state_dict = None
    if args.weights_path and os.path.exists(args.weights_path):
        state_dict = load_generator_params(args.weights_path)
        print(f"Loaded `{args.weights_path}` weights.")
    else:
        print("WARNING: no weights file found — using random initialization.")
    models = generator_replicas(devices, state_dict, upscale_factor=args.upscale_factor,
                                dtype=torch.bfloat16 if args.bfloat16 else torch.float32)

    lr_image = load_image_rgb(args.inputs_path)
    forwards = [no_grad_forward(m) for m in models]

    t0 = time.time()
    if args.tile > 0:
        sr_np = tiled_upscale(forwards, lr_image, scale=args.upscale_factor,
                              tile=args.tile, overlap=args.tile_overlap,
                              tile_batch=args.tile_batch, devices=devices)
    else:
        batch = torch.from_numpy(image_to_array(lr_image)).to(device)
        sr_np = forwards[0](batch).cpu().numpy()
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"SR {lr_image.shape[0]}x{lr_image.shape[1]} -> "
          f"{sr_np.shape[-3]}x{sr_np.shape[-2]} in {time.time() - t0:.3f}s on {name}")

    save_image_rgb(args.output_path, array_to_image(sr_np))
    print(f"SR image save location: {args.output_path}")
    return args.output_path


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Real-ESRGAN x4 single-image super-resolution (PyTorch/CUDA)")
    parser.add_argument("--inputs_path", type=str, default="./figure/tree_lr.png",
                        help="Path to the low-resolution input image.")
    parser.add_argument("--output_path", type=str, default="./figure/tree_sr.png",
                        help="Where to write the super-resolved image.")
    parser.add_argument("--weights_path", type=str,
                        default="./results/pretrained_models/RealESRGAN_x4-DFO2K.pth.tar",
                        help="Generator weights (.pth.tar or .npz snapshot).")
    parser.add_argument("--upscale_factor", type=int, default=4)
    parser.add_argument("--bfloat16", action="store_true",
                        help="Run the network in bfloat16.")
    parser.add_argument("--tile", type=int, default=0,
                        help="Tile size for overlap-tile large-image serving "
                             "(0 = whole image in one forward).")
    parser.add_argument("--tile_overlap", type=int, default=8)
    parser.add_argument("--tile_batch", type=int, default=8)
    parser.add_argument("--cpu", action="store_true",
                        help="Run on the CPU instead of CUDA.")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
