"""Per-source gradient-norm probe: which training tiles drive the blow-ups?
The port of ``tools/grad_probe.py``.

Loads a generator's weights (the EMA by default) and, for each SOURCE (the
tile file name before its last ``_``), runs the training loss and its
gradients over that source's tiles only: the same degradation (the port's
``degrade``, seeded by the draw's index), the L1 loss of the generator's
clamped output (straight-through, as the JAX tool's ``model.apply``) on it,
and the global gradient norm, over several draws of a batch.  If one
or two sources carry the explosive gradients, the fix is data curation (or
per-source loss scaling), not more optimizer machinery.

    python -m real_esrgan_tpu_torch.tools.grad_probe [--weights assets/inenv10_esrnet_ema.npz]
        [--train-dir data/InEnv10/train] [--draws 8] [--batch 16]

``--weights`` takes a checkpoint directory of the port's trainer, an
``.npz`` snapshot or a ``.pth.tar`` (``load_generator_params``).  The run's
values come from ``real_esrgan_tpu_torch.config``.  Runs on CUDA; ``--cpu``
runs on the CPU.
"""

from __future__ import annotations

import argparse
import collections
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from real_esrgan_tpu_torch import config as run_config
from real_esrgan_tpu_torch import resolve_device


def group_by_source(train_dir: str) -> Dict[str, List[str]]:
    """The tile files of ``train_dir`` by source: the name before its last ``_``."""
    by_source: Dict[str, List[str]] = collections.defaultdict(list)
    for f in sorted(os.listdir(train_dir)):
        by_source[f.rsplit("_", 1)[0]].append(os.path.join(train_dir, f))
    return dict(by_source)


def loss_and_grad_norm(model: torch.nn.Module, params: Dict[str, torch.Tensor],
                       lr_b: torch.Tensor, hr_b: torch.Tensor) -> Tuple[float, float]:
    """The L1 loss of ``model`` with ``params`` on the pair and the global
    norm of its gradients (float32 sum of squares)."""
    from torch.func import functional_call

    from real_esrgan_tpu_torch.train.optim import global_norm

    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    sr = functional_call(model, leaves, (lr_b,))
    loss = torch.abs(sr - hr_b).mean()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), float(global_norm(list(grads)))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--weights", default="results/RealESRNet_inenv10/g_last")
    p.add_argument("--train-dir", default="data/InEnv10/train")
    p.add_argument("--draws", type=int, default=8)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--use-params", action="store_true",
                   help="probe raw params instead of the EMA")
    p.add_argument("--random-init", action="store_true",
                   help="probe a fresh random init instead of a checkpoint")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    return p


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    """Prints the table; returns each source's row."""
    from real_esrgan_tpu_torch.ops.degradation import degrade
    from real_esrgan_tpu_torch.train.checkpoint import load_generator_params
    from real_esrgan_tpu_torch.train.esrnet import build_generator
    from real_esrgan_tpu_torch.utils.imgio import read_png

    args = build_parser().parse_args(argv)
    device = resolve_device(args.cpu)
    geo, kcfg, dcfg = run_config.geometry, run_config.kernel_synthesis, run_config.degradation
    cfg = run_config.train_esrnet
    model = build_generator(run_config.model, cfg, device, training=True,
                            generator=torch.Generator().manual_seed(0))
    if args.random_init:
        params = {k: v.detach() for k, v in model.named_parameters()}
    else:
        loaded = load_generator_params(args.weights, prefer_ema=not args.use_params)
        params = {k: loaded[k].to(device) for k, _ in model.named_parameters()}

    print(f"{'source':<12} {'tiles':>5} {'gnorm_med':>10} {'gnorm_max':>10} "
          f"{'loss_med':>9} {'n>500':>6}")
    rows = {}
    for src, files in sorted(group_by_source(args.train_dir).items()):
        imgs = [read_png(f) for f in files]
        gnorms, losses = [], []
        rng = np.random.default_rng(0)
        for d in range(args.draws):
            pick = rng.choice(len(imgs), size=args.batch, replace=True)
            batch = torch.from_numpy(np.stack([imgs[i] for i in pick])).to(device)
            gen = torch.Generator(device=device).manual_seed(1000 + d)
            with torch.no_grad():
                lr_b, hr_b = degrade(gen, batch, geo, kcfg, dcfg,
                                     host_generator=torch.Generator().manual_seed(1000 + d))
            loss, gn = loss_and_grad_norm(model, params, lr_b, hr_b)
            gnorms.append(gn)
            losses.append(loss)
        gnorms, losses = np.array(gnorms), np.array(losses)
        rows[src] = {"tiles": len(files), "gnorm_med": float(np.median(gnorms)),
                     "gnorm_max": float(gnorms.max()), "loss_med": float(np.median(losses)),
                     "n_over_500": int((gnorms > 500).sum())}
        print(f"{src:<12} {len(files):>5} {np.median(gnorms):>10.1f} {gnorms.max():>10.1f} "
              f"{np.median(losses):>9.4f} {(gnorms > 500).sum():>6}")
    return rows


if __name__ == "__main__":
    main()
