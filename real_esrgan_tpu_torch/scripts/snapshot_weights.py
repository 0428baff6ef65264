"""Archive a trained generator as one compact ``.npz`` weight snapshot: the
port of ``scripts/snapshot_weights.py``.

Reads the port's own checkpoint directories (``g_epoch_N``, ``g_best``,
``g_last``), reference ``.pth.tar`` files and ``.npz`` snapshots through
``train/checkpoint.py::load_generator_params``, and writes through
``save_params_npz``: ``/``-joined flax paths, f16 unless ``--float32``, the
format both packages load.  An Orbax checkpoint directory of the JAX trainer
needs the root script, which reads it through JAX.

    python -m real_esrgan_tpu_torch.scripts.snapshot_weights \\
        --checkpoint results/<exp>/g_best --output assets/<exp>_ema.npz   # EMA weights
    python -m real_esrgan_tpu_torch.scripts.snapshot_weights ... --use-params   # raw params
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from real_esrgan_tpu_torch.train.checkpoint import load_generator_params, save_params_npz


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="generator weights -> compact .npz snapshot")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="the port's checkpoint dir, .pth.tar, or .npz")
    p.add_argument("--output", type=str, required=True, help="output .npz path")
    p.add_argument("--use-params", action="store_true",
                   help="snapshot raw params instead of EMA weights")
    p.add_argument("--float32", action="store_true",
                   help="keep f32 (double the size; f16 is within bf16 round-off of the "
                        "f32 originals)")
    return p


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    params = load_generator_params(args.checkpoint, prefer_ema=not args.use_params)
    dtype = np.float32 if args.float32 else np.float16
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    save_params_npz(args.output, params, dtype=dtype)
    size = os.path.getsize(args.output) / 1e6
    print(f"Snapshot `{args.checkpoint}` -> `{args.output}` ({dtype.__name__}, {size:.1f} MB)")
    return args.output


if __name__ == "__main__":
    main()
