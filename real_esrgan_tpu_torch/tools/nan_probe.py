"""Instrumented replay of stage-1 training to its first non-finite step: the
port of ``tools/nan_probe.py``.

Mirrors ``train_realesrnet``'s setup (the same config, seeds, loader, coin
stream ``default_rng((seed, epoch, 17))`` and train step) and, at the first
step whose loss or gradient norm is not finite, dissects every link:

  * the state before the step (a copy is kept before each step): params,
    EMA and optimizer state, non-finite counts and max |value|;
  * the degraded batch, drawn again from the step's seed;
  * the loss and every parameter's gradient norm at that exact (params,
    batch); where the loss is not finite, the named module outputs of the
    forward that first hold a non-finite value (``capture_outputs``: forward
    hooks, the counterpart of flax's ``capture_intermediates``);
  * the optimizer on those gradients, plain (clip and Adam) and guarded
    (``train/guard.py``): did the guard hold?

Artifacts land in ``--out`` (default ``<tmp>/nan_probe``): ``<label>.json``,
``<label>_hr_uint8.npy`` and ``<label>_params.npz`` (the params before the
step, keyed by the port's state_dict names), with ``<label>`` =
``step<N>_e<epoch>``; ``tools/explode_analysis.py`` reads them.

    python -m real_esrgan_tpu_torch.tools.nan_probe [--epochs 8] [--train-dir data/InEnv10/train]

Runs on CUDA; ``--cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from real_esrgan_tpu_torch import config as run_config
from real_esrgan_tpu_torch import resolve_device

DEFAULT_OUT = os.path.join(tempfile.gettempdir(), "nan_probe")


def tensors_of(obj) -> List[torch.Tensor]:
    """Every tensor in a tree of dicts, dataclasses, lists and tuples."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    elif isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in tensors_of(v)]
    return []


def clone_tree(obj):
    """A copy of ``obj`` with every tensor cloned."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: clone_tree(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: clone_tree(v) for k, v in obj.items()}
    return obj


def tree_nonfinite(tree) -> int:
    return int(sum(int((~torch.isfinite(t)).sum()) for t in tensors_of(tree)
                   if t.is_floating_point()))


def tree_maxabs(tree) -> float:
    return max(float(t.double().abs().max()) for t in tensors_of(tree)
               if t.is_floating_point() and t.numel())


def capture_outputs(model: torch.nn.Module, params: Dict[str, torch.Tensor],
                    x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``model``'s output on ``x`` with ``params``, and the output of every
    named submodule that ran, keyed by its name (``trunk.5.rdb2``), in the
    order the modules finished: flax's ``capture_intermediates`` for the
    port's modules.  The model's own output, NHWC, is under ``""``; its
    submodules' NCHW activations are given as NHWC, the JAX layout."""
    outputs: Dict[str, torch.Tensor] = {}
    handles = []
    for name, module in model.named_modules():
        def hook(_module, _inputs, output, name=name):
            if isinstance(output, torch.Tensor):
                outputs[name] = output.detach() if not name else output.detach().permute(
                    0, 2, 3, 1)
        handles.append(module.register_forward_hook(hook))
    try:
        # with autograd recording, every module runs: under no_grad on a CUDA
        # device the tail kernel takes conv3's place and its hooks never fire
        with torch.enable_grad():
            out = functional_call(model, params, (x.detach().requires_grad_(),))
    finally:
        for handle in handles:
            handle.remove()
    return out.detach(), outputs


@dataclasses.dataclass
class Probe:
    """What the replay and the dissection share: the run's configuration,
    the training model, its optimizer and step, the device and ``out``."""

    geo: Any
    kcfg: Any
    dcfg: Any
    cfg: Any
    model: torch.nn.Module
    opt: Any
    train_step: Any
    device: torch.device
    out: str


def build_probe(a: argparse.Namespace, steps_per_epoch: int, device: torch.device) -> Tuple[
        Probe, Any]:
    """The trainer's model, optimizer, step and initial state, as
    ``train_realesrnet`` builds them for this configuration."""
    from real_esrgan_tpu_torch.train.esrnet import (
        build_generator, build_optimizer, init_state, make_train_step,
    )

    cfg = configure(a)
    model = build_generator(run_config.model, cfg, device, training=True,
                            generator=torch.Generator().manual_seed(cfg.seed))
    opt = build_optimizer(cfg, steps_per_epoch)
    state = init_state(model, opt)
    step = make_train_step(
        model, opt, run_config.geometry, run_config.kernel_synthesis, run_config.degradation,
        cfg.ema_decay, seed=cfg.seed, reject_limit=cfg.grad_reject_limit,
        rollback_after=cfg.rollback_after, guard_updates=cfg.skip_nonfinite_updates,
        reject_mult=cfg.grad_reject_mult, clamp_mode=cfg.train_clamp)
    probe = Probe(run_config.geometry, run_config.kernel_synthesis, run_config.degradation, cfg,
                  model, opt, step, device, a.out)
    return probe, state


def configure(a: argparse.Namespace):
    cfg = dataclasses.replace(run_config.train_esrnet, epochs=a.total_epochs,
                              train_image_dir=a.train_dir)
    if a.lr:
        cfg = dataclasses.replace(cfg, lr=a.lr)
    if a.warmup_steps >= 0:
        cfg = dataclasses.replace(cfg, lr_warmup_steps=a.warmup_steps)
    if a.train_clamp:
        cfg = dataclasses.replace(cfg, train_clamp=a.train_clamp)
    return cfg


def nonfinite_layers(outputs: Dict[str, torch.Tensor], limit: int = 20) -> List[list]:
    """[name, non-finite count, max |finite value|] of every output that
    holds a non-finite value, first to finish first."""
    bad = []
    for name, t in outputs.items():
        t = t.float()
        n_bad = int((~torch.isfinite(t)).sum())
        if n_bad:
            finite = t[torch.isfinite(t)]
            bad.append([name, n_bad, float(finite.abs().max()) if finite.numel() else float("nan")])
    return bad[:limit]


def dissect(probe: Probe, prev_state, hr_uint8: torch.Tensor, up1: bool, up2: bool,
            label: str) -> dict:
    """Every link of one step from the state before it: see the module's
    docstring.  Writes ``<label>.json``, ``<label>_hr_uint8.npy`` and
    ``<label>_params.npz`` under ``probe.out`` and returns the report."""
    from real_esrgan_tpu_torch.train.esrnet import degrade_for_step
    from real_esrgan_tpu_torch.train.guard import guarded_update
    from real_esrgan_tpu_torch.train.optim import apply_updates, global_norm

    print(f"--- dissecting {label} ---", flush=True)
    cfg = probe.cfg
    report: Dict[str, Any] = {"label": label}
    for name, tree in (("params", prev_state.params), ("ema", prev_state.ema_params),
                       ("opt_state", prev_state.opt_state)):
        report[f"{name}_nonfinite"] = tree_nonfinite(tree)
        report[f"{name}_maxabs"] = tree_maxabs(tree)
    lr_b, hr_b = degrade_for_step(prev_state.step, hr_uint8, probe.geo, probe.kcfg, probe.dcfg,
                                  cfg.seed, up1, up2)
    report["lr_nonfinite"] = int((~torch.isfinite(lr_b)).sum())
    report["hr_nonfinite"] = int((~torch.isfinite(hr_b)).sum())
    report["lr_minmax"] = [float(lr_b.min()), float(lr_b.max())]
    report["hr_minmax"] = [float(hr_b.min()), float(hr_b.max())]

    loss, grads = probe.train_step.loss_and_grads(prev_state.params, lr_b, hr_b)
    report["loss"] = float(loss)
    if not np.isfinite(report["loss"]):
        # where in the forward the non-finite value first appears
        _, outputs = capture_outputs(probe.model, prev_state.params, lr_b)
        report["forward_nonfinite_layers"] = nonfinite_layers(outputs)
    report["grads_nonfinite"] = tree_nonfinite(grads)
    report["grads_maxabs"] = tree_maxabs(grads)
    report["grads_global_norm"] = float(global_norm(list(grads.values())))
    # the optimizer on this exact (grads, opt_state, params): plain, then guarded
    updates, new_opt = probe.opt.update(grads, prev_state.opt_state)
    report["updates_nonfinite"] = tree_nonfinite(updates)
    report["updates_maxabs"] = tree_maxabs(updates)
    report["new_opt_nonfinite"] = tree_nonfinite(new_opt)
    report["params_after_nonfinite"] = tree_nonfinite(apply_updates(prev_state.params, updates))
    params, _, _, guard, info = guarded_update(
        probe.opt, grads, prev_state.opt_state, prev_state.params, prev_state.ema_params,
        prev_state.guard, reject_limit=cfg.grad_reject_limit, rollback_after=cfg.rollback_after,
        ema_decay=cfg.ema_decay, reject_mult=cfg.grad_reject_mult)
    report["guard_rejected"] = int(info["rejected"])
    report["guarded_params_after_nonfinite"] = tree_nonfinite(params)
    report["total_notfinite_after"] = int(guard.rejected_total)
    norms = {k: float(torch.linalg.vector_norm(g.float())) for k, g in grads.items()}
    report["worst_layer_grad_norms"] = sorted(
        norms.items(), key=lambda kv: -np.nan_to_num(kv[1], nan=np.inf, posinf=np.inf))[:12]

    os.makedirs(probe.out, exist_ok=True)
    np.save(os.path.join(probe.out, f"{label}_hr_uint8.npy"), hr_uint8.cpu().numpy())
    np.savez(os.path.join(probe.out, f"{label}_params.npz"),
             **{k: v.detach().cpu().numpy() for k, v in prev_state.params.items()})
    with open(os.path.join(probe.out, f"{label}.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(json.dumps(report, indent=1, default=str), flush=True)
    return report


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--train-dir", default="data/InEnv10/train")
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--total-epochs", type=int, default=700,
                   help="cfg.epochs as the real run set it (LR schedule)")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=0.0,
                   help="override cfg.lr (A/B the step-size regime)")
    p.add_argument("--warmup-steps", type=int, default=-1,
                   help="override cfg.lr_warmup_steps (-1 = config)")
    p.add_argument("--train-clamp", default="", choices=("", "none", "st", "hard"),
                   help="training-loss clamp mode ('' = config default)")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Replays ``--epochs`` epochs; returns ``{"steps", "bad_steps",
    "reports"}``.  Stops after the third dissected step."""
    from real_esrgan_tpu_torch.data.dataset import TrainImageDataset
    from real_esrgan_tpu_torch.data.prefetcher import DevicePrefetcher
    from real_esrgan_tpu_torch.train_realesrnet import make_train_loader

    a = build_parser().parse_args(argv)
    device = resolve_device(a.cpu)
    os.makedirs(a.out, exist_ok=True)
    geo, dcfg, cfg = run_config.geometry, run_config.degradation, configure(a)
    train_ds = TrainImageDataset(cfg.train_image_dir, geo.hr_size,
                                 cache_bytes=cfg.decoded_cache_bytes)
    loader = make_train_loader(train_ds, a.batch_size, cfg, geo, device)
    steps_per_epoch = len(loader)
    print(f"{len(train_ds)} train images, {steps_per_epoch} steps/epoch", flush=True)
    probe, state = build_probe(a, steps_per_epoch, device)

    reports, step = [], 0
    for epoch in range(a.epochs):
        coin_rng = np.random.default_rng((cfg.seed, epoch, 17))
        for batch_index, hr_uint8 in enumerate(DevicePrefetcher(loader, device)):
            up1 = bool(coin_rng.random() < dcfg.resize_probs1[0])
            up2 = bool(coin_rng.random() < dcfg.resize_probs2[0])
            prev_state = clone_tree(state)  # the dissection sees the state before the step
            state, m = probe.train_step(state, hr_uint8, up1, up2)
            loss, gn = float(m["loss"]), float(m["grad_norm"])
            finite = np.isfinite(loss) and np.isfinite(gn)
            if batch_index == 0 or not finite:
                print(f"e{epoch + 1} s{step}: loss {loss:.6g} gnorm {gn:.6g}", flush=True)
            if not finite:
                reports.append(dissect(probe, prev_state, hr_uint8, up1, up2,
                                       f"step{step}_e{epoch + 1}"))
                print(f"post-step nonfinite: params {tree_nonfinite(state.params)}, "
                      f"ema {tree_nonfinite(state.ema_params)}, "
                      f"opt {tree_nonfinite(state.opt_state)}", flush=True)
                if len(reports) >= 3:
                    print("3 bad steps dissected; stopping.", flush=True)
                    return {"steps": step + 1, "bad_steps": len(reports), "reports": reports}
            step += 1
    print("no non-finite step found in the probed window", flush=True)
    return {"steps": step, "bad_steps": len(reports), "reports": reports}


if __name__ == "__main__":
    main()
