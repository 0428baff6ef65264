"""Layer-level dissection of a stage-1 forward/backward explosion: the port of
``tools/explode_analysis.py``.

Reads what ``tools/nan_probe.py`` wrote for one step (``step<N>_e<epoch>``
under ``--dir``: the HR batch and the params before the step), replays the
coin stream and the degradation of that (step, epoch, batch), and walks the
forward module by module in the training dtype (bf16) and in f32: the top
outputs by max |value| with their non-finite counts
(``nan_probe.capture_outputs``) and the outputs that hold a non-finite
value, first to finish first, then the gradients' max |value|, to tell
genuine divergence from a precision pathology.

    python -m real_esrgan_tpu_torch.tools.explode_analysis [--step 106] [--epoch 4] [--batch 22]

Runs on CUDA; ``--cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from real_esrgan_tpu_torch import config as run_config
from real_esrgan_tpu_torch import resolve_device
from real_esrgan_tpu_torch.tools.nan_probe import DEFAULT_OUT, capture_outputs, nonfinite_layers


def load_params(npz_path: str, template: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``nan_probe``'s params npz as tensors like ``template`` (names,
    shapes, device)."""
    with np.load(npz_path) as flat:
        loaded = {k: torch.from_numpy(flat[k]) for k in flat.files}
    if loaded.keys() != template.keys() or any(
            loaded[k].shape != t.shape for k, t in template.items()):
        raise ValueError(f"{npz_path} does not hold this generator's parameters")
    return {k: v.to(template[k].device, template[k].dtype) for k, v in loaded.items()}


def layer_maxabs(outputs: Dict[str, torch.Tensor], limit: int = 30) -> List[tuple]:
    """(name, max |value| ignoring NaN, non-finite count), largest first."""
    rows = []
    for name, t in outputs.items():
        t = t.float()
        rows.append((name or "output",
                     float(torch.nan_to_num(t.abs(), nan=0.0, posinf=float("inf")).max()),
                     int((~torch.isfinite(t)).sum())))
    rows.sort(key=lambda r: -r[1])
    return rows[:limit]


def replay_coins(seed: int, epoch: int, batch: int, dcfg) -> tuple:
    """The resize coins (up1, up2) of batch ``batch`` of 1-indexed ``epoch``,
    from the trainer's stream ``default_rng((seed, epoch - 1, 17))``."""
    coin_rng = np.random.default_rng((seed, epoch - 1, 17))
    for _ in range(batch):
        coin_rng.random(), coin_rng.random()
    return (bool(coin_rng.random() < dcfg.resize_probs1[0]),
            bool(coin_rng.random() < dcfg.resize_probs2[0]))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--step", type=int, default=106)
    p.add_argument("--epoch", type=int, default=4, help="1-indexed, as logged")
    p.add_argument("--batch", type=int, default=22, help="batch index in epoch")
    p.add_argument("--dir", default=DEFAULT_OUT)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns, by dtype, the loss, the top outputs, the non-finite ones and the
    gradients' max |value|."""
    from torch.func import functional_call

    from real_esrgan_tpu_torch.train.esrnet import build_generator, degrade_for_step

    a = build_parser().parse_args(argv)
    device = resolve_device(a.cpu)
    geo, kcfg, dcfg = run_config.geometry, run_config.kernel_synthesis, run_config.degradation
    cfg = run_config.train_esrnet

    tag = f"step{a.step}_e{a.epoch}"
    hr_uint8 = torch.from_numpy(np.load(os.path.join(a.dir, f"{tag}_hr_uint8.npy")))
    print("batch:", tuple(hr_uint8.shape), hr_uint8.dtype)
    up1, up2 = replay_coins(cfg.seed, a.epoch, a.batch, dcfg)
    print("coins:", up1, up2)
    lr_b, hr_b = degrade_for_step(a.step, hr_uint8.to(device), geo, kcfg, dcfg, cfg.seed,
                                  up1, up2)
    print("lr range", float(lr_b.min()), float(lr_b.max()))

    result = {}
    params = None
    for dtype_name in ("bf16", "f32"):
        model = build_generator(run_config.model,
                                dataclasses.replace(cfg, use_bfloat16=dtype_name == "bf16"),
                                device, training=True)
        if params is None:
            params = load_params(os.path.join(a.dir, f"{tag}_params.npz"),
                                 dict(model.named_parameters()))
        out, outputs = capture_outputs(model, params, lr_b)
        loss = float(torch.mean(torch.abs(out - hr_b)))
        print(f"\n=== forward [{dtype_name}] loss {loss:.6f} — top activations ===")
        rows = layer_maxabs(outputs, 16)
        for name, mx, bad in rows:
            print(f"  {mx:14.6g}  nonfinite {bad:8d}  {name}")
        bad_outputs = nonfinite_layers(outputs, limit=len(outputs))
        print(f"non-finite outputs [{dtype_name}]: {len(bad_outputs)}"
              + (f", first {bad_outputs[0][0] or 'output'}" if bad_outputs else ""))
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        sr = functional_call(model, leaves, (lr_b,))
        grads = torch.autograd.grad(torch.mean(torch.abs(sr - hr_b)), list(leaves.values()))
        gmax = max(float(g.double().abs().max()) for g in grads)
        print(f"grads [{dtype_name}] maxabs {gmax:.6g}")
        result[dtype_name] = {"loss": loss, "top": rows, "nonfinite_outputs": bad_outputs,
                              "grads_maxabs": gmax}
    return result


if __name__ == "__main__":
    main()
