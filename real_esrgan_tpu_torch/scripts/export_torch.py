"""Export a generator checkpoint to the reference's ``.pth.tar`` format: the
port of ``scripts/export_torch.py``, with no JAX.

Takes an Orbax checkpoint directory of the JAX trainers or a checkpoint
directory of the port's (``g_best``, ``g_last``, ``g_epoch_N``) and writes
the reference's payload: ``epoch``, ``best_niqe``, ``state_dict``, the
``model.``-prefixed ``ema_state_dict`` (the raw params where the checkpoint
has no EMA), and ``optimizer`` and ``scheduler`` as None, since the
reference's optimizer state has no counterpart here.

    python -m real_esrgan_tpu_torch.scripts.export_torch \\
        --checkpoint results/<exp>/g_best --output g_best.pth.tar
"""

from __future__ import annotations

import argparse
import os

import torch

from real_esrgan_tpu_torch.train.checkpoint import load_checkpoint


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="checkpoint directory -> reference .pth.tar")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="checkpoint directory, Orbax or the port's (g_best / g_epoch_N)")
    p.add_argument("--output", type=str, required=True, help="output .pth.tar path")
    return p


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    tree = load_checkpoint(args.checkpoint)
    params = {k: v.float().contiguous() for k, v in tree["params"].items()}
    ema = tree.get("ema_params")
    ema = params if not ema else {k: v.float().contiguous() for k, v in ema.items()}
    payload = {
        "epoch": int(tree.get("epoch", 0)),
        "best_niqe": float(tree.get("best_niqe", 100.0)),
        "state_dict": params,
        "ema_state_dict": {f"model.{k}": v for k, v in ema.items()},
        "optimizer": None,
        "scheduler": None,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    torch.save(payload, args.output)
    print(f"Exported `{args.checkpoint}` -> `{args.output}` ({len(params)} tensors)")
    return args.output


if __name__ == "__main__":
    main()
