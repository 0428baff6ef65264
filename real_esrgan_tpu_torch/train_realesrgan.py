"""Real-ESRGAN (stage-2) adversarial training: the port of the root
``train_realesrgan.py``.

    python -m real_esrgan_tpu_torch.train_realesrgan --train-dir data/InEnv2/train \\
        --resume assets/inenv10_esrnet_ema.npz --content-backbone trunk \\
        --exp-name MyGan --epochs 100 --no-tensorboard
    python -m real_esrgan_tpu_torch.train_realesrgan --cpu --synthetic --epochs 1 \\
        --steps-per-epoch 2 --batch-size 2 --no-tensorboard     # a smoke run

The JAX trainer's epoch loop: the fused G+D step (``train/esrgan.py``), the
storm monitor (``--abort-on-storm`` exits rc=3), validation of G's EMA with
NIQE (the evaluation model runs the RDB kernel), and at each saving epoch
``samples/<exp>/g_epoch_N`` and ``d_epoch_N`` with ``results/<exp>/{g,d}_best``
and ``{g,d}_last`` copies, written by ``AsyncSaver`` while the next epoch
trains; then the host-memory failsafe (rc=4).

Resume is three-way: ``--resume`` warm-starts G from stage-1 weights (a
checkpoint directory, ``.npz`` or ``.pth.tar``; matching names and shapes
only), ``--resume-g`` / ``--resume-d`` take a path or ``auto`` (the newest
``g_epoch_N`` / ``d_epoch_N``) and restore the whole GAN state.

The content loss's features are VGG19's (``--content-backbone vgg``): a
torchvision ``vgg19`` state_dict at ``vgg_weights_path``, or random features
with ``--allow-random-vgg`` (``--synthetic`` implies it); without either it
refuses.  ``--content-backbone trunk`` taps the warm-started generator's own
trunk (conv1 and RRDBs 1-2, each weighted 1) and refuses without a warm start.
The flags are the root script's, plus ``--cpu``; without CUDA and without
``--cpu`` it raises.  Both TF32 flags are turned off.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from collections import deque

import numpy as np
import torch

from real_esrgan_tpu_torch import config as run_config
from real_esrgan_tpu_torch import resolve_device
from real_esrgan_tpu_torch.data.dataset import TrainImageDataset, build_eval_datasets
from real_esrgan_tpu_torch.data.prefetcher import DevicePrefetcher
from real_esrgan_tpu_torch.metrics.niqe import NIQE
from real_esrgan_tpu_torch.models.convert import vgg_state_from_torchvision
from real_esrgan_tpu_torch.models.ema import ema_init
from real_esrgan_tpu_torch.models.rrdbnet import TrunkFeatures, trunk_feature_params
from real_esrgan_tpu_torch.train import checkpoint as ckpt_lib
from real_esrgan_tpu_torch.train.esrgan import (
    GanTrainState, build_models, build_optimizers, init_gan_state, make_gan_train_step,
)
from real_esrgan_tpu_torch.train.esrnet import (
    build_generator, make_eval_fn, notfinite_count, rollback_count,
)
from real_esrgan_tpu_torch.train.guard import guard_from_dict, guard_to_dict
from real_esrgan_tpu_torch.train_realesrnet import (
    SyntheticHRDataset, check_storm, failsafe, make_train_loader, restore_opt_state, save_epoch,
    validate,
)
from real_esrgan_tpu_torch.utils.meters import AverageMeter, ProgressMeter

# --content-backbone trunk: conv1 (0) and the first two RRDB outputs
TRUNK_FEATURE_TAPS = (0, 1, 2)


def load_vgg_params(vgg, cfg, allow_random: bool = False) -> None:
    """Pretrained torchvision VGG19 weights into ``vgg`` where
    ``cfg.vgg_weights_path`` exists; else its random features, which only
    ``allow_random`` permits: long GAN runs drift against random features,
    so a quality run must not fall into them unnoticed."""
    path = cfg.vgg_weights_path
    if path and os.path.exists(path):
        sd = vgg_state_from_torchvision(torch.load(path, map_location="cpu", weights_only=True))
        vgg.load_state_dict({k: sd[k] for k in vgg.state_dict()})
        print(f"Loaded VGG19 weights from `{path}`.")
        return
    if not allow_random:
        raise SystemExit(
            f"No VGG19 weights at `{path}`. The perceptual content loss needs pretrained "
            "features for a quality run (random features drift over long horizons). Provide "
            "vgg_weights_path, pass --allow-random-vgg to train with random VGG features, or "
            "use --content-backbone trunk with a stage-1 --resume.")
    print("WARNING: no VGG19 weights file — content loss uses random features "
          "(--allow-random-vgg).")


def checkpoint_payloads(state: GanTrainState, epoch: int, best_niqe: float):
    """The ``g_`` and ``d_`` checkpoints' payloads (the JAX trainer's fields)."""
    g = {"epoch": epoch, "best_niqe": best_niqe, "step": state.step,
         "params": state.g_params, "ema_params": state.g_ema,
         "opt_state": state.g_opt.as_dict(), "guard": guard_to_dict(state.g_guard)}
    d = {"epoch": epoch, "best_niqe": best_niqe, "params": state.d_params,
         "batch_stats": state.d_stats, "opt_state": state.d_opt.as_dict(),
         "guard": guard_to_dict(state.d_guard)}
    return g, d


def resume_generator(state: GanTrainState, path: str):
    """(state, start_epoch, best_niqe) with G's part from the ``g_`` checkpoint
    ``path``: params and EMA must match the live model; a mismatched
    optimizer state is replaced by the fresh one, with a warning."""
    tree = ckpt_lib.load_checkpoint(path)
    device = state.g_guard.lr_scale.device
    state = dataclasses.replace(
        state, step=int(tree["step"]),
        g_params=ckpt_lib.restore_like(state.g_params, tree["params"], "g_params"),
        g_ema=ckpt_lib.restore_like(state.g_ema, tree["ema_params"], "g_ema"),
        g_opt=restore_opt_state(state.g_opt, tree.get("opt_state")),
        g_guard=guard_from_dict(tree.get("guard"), device))
    return state, int(tree.get("epoch", 0)), float(tree.get("best_niqe", 100.0))


def resume_discriminator(state: GanTrainState, path: str) -> GanTrainState:
    """``state`` with D's part from the ``d_`` checkpoint ``path``."""
    tree = ckpt_lib.load_checkpoint(path)
    return dataclasses.replace(
        state, d_params=ckpt_lib.restore_like(state.d_params, tree["params"], "d_params"),
        d_stats=ckpt_lib.restore_like(state.d_stats, tree["batch_stats"], "d_stats"),
        d_opt=restore_opt_state(state.d_opt, tree.get("opt_state")),
        d_guard=guard_from_dict(tree.get("guard"), state.d_guard.lr_scale.device))


def _configure(args):
    cfg = run_config.train_esrgan
    overrides = {"epochs": args.epochs, "checkpoint_frequency": args.checkpoint_frequency,
                 "loader": args.loader, "train_image_dir": args.train_dir,
                 "valid_image_dir": args.valid_dir, "test_lr_image_dir": args.test_lr_dir,
                 "test_hr_image_dir": args.test_hr_dir, "exp_name": args.exp_name,
                 "lr": args.lr, "train_clamp": args.train_clamp}
    cfg = dataclasses.replace(cfg, **{k: v for k, v in overrides.items() if v})
    if args.warmup_steps >= 0:
        cfg = dataclasses.replace(cfg, lr_warmup_steps=args.warmup_steps)
    return cfg


def _resolve_auto(path: str, samples_dir: str, prefix: str) -> str:
    if path != "auto":
        return path
    found = ckpt_lib.find_latest_checkpoint(samples_dir, prefix)
    if not found:
        print(f"--resume-{prefix[0]} auto: no checkpoint found, starting fresh.")
    return found


def main(args) -> None:
    device = resolve_device(args.cpu)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"Training on {device} (TF32 off for matmul and cuDNN).")
    geo = run_config.geometry
    kcfg = run_config.kernel_synthesis
    dcfg = run_config.degradation
    model_cfg = run_config.model
    cfg = _configure(args)
    batch = args.batch_size or cfg.batch_size

    if args.synthetic:
        train_ds = SyntheticHRDataset(geo.hr_size, length=args.steps_per_epoch * batch)
        valid_ds, test_ds = [], []
    else:
        train_ds = TrainImageDataset(cfg.train_image_dir, geo.hr_size)
        valid_ds, test_ds = build_eval_datasets(cfg.valid_image_dir, cfg.test_lr_image_dir,
                                                cfg.test_hr_image_dir, geo.crop_size, geo.scale)
    loader = make_train_loader(train_ds, batch, cfg)
    steps_per_epoch = len(loader)
    print(f"Loaded datasets: {len(train_ds)} train images, {steps_per_epoch} steps/epoch.")

    generator, discriminator, backbone = build_models(model_cfg, cfg, device)
    g_tx, d_tx = build_optimizers(cfg, steps_per_epoch)
    state = init_gan_state(generator, discriminator, g_tx, d_tx)
    content_backbone = args.content_backbone or "vgg"
    if content_backbone == "trunk":
        # the frozen stage-1 trunk as the feature space; its weights are taken
        # from G after the warm start below
        trunk_taps = tuple(t for t in TRUNK_FEATURE_TAPS if t <= model_cfg.num_rrdb)
        backbone = TrunkFeatures(
            trunk_taps, upscale_factor=model_cfg.upscale_factor, channels=model_cfg.channels,
            growth=model_cfg.growth_channels, dtype=generator.dtype,
            in_channels=model_cfg.in_channels, device=device).requires_grad_(False)
        cfg = dataclasses.replace(cfg, content_weights=(1.0,) * len(trunk_taps))
    else:
        load_vgg_params(backbone, cfg, allow_random=args.allow_random_vgg or args.synthetic)

    samples_dir = os.path.join("samples", cfg.exp_name)
    results_dir = os.path.join("results", cfg.exp_name)
    start_epoch, best_niqe, warm = 0, 100.0, False
    resume = args.resume or cfg.resume
    resume_g = _resolve_auto(args.resume_g or cfg.resume_g, samples_dir, "g_epoch_")
    resume_d = _resolve_auto(args.resume_d or cfg.resume_d, samples_dir, "d_epoch_")
    if resume and os.path.exists(resume):
        loaded = ckpt_lib.load_generator_params(resume, prefer_ema=False)
        g_params = {k: v.to(device) for k, v in
                    ckpt_lib.merge_matching(state.g_params, loaded).items()}
        state = dataclasses.replace(state, g_params=g_params, g_ema=ema_init(g_params))
        warm = True
        print(f"Warm-started generator from `{resume}`.")
    if resume_g and os.path.exists(resume_g):
        state, start_epoch, best_niqe = resume_generator(state, resume_g)
        warm = True
        print(f"Resumed generator GAN state from `{resume_g}` at epoch {start_epoch}.")
    if resume_d and os.path.exists(resume_d):
        state = resume_discriminator(state, resume_d)
        print(f"Resumed discriminator from `{resume_d}`.")
    if content_backbone == "trunk":
        if not warm and not args.synthetic:
            raise SystemExit(
                "--content-backbone trunk needs a stage-1 warm start (--resume <weights> that "
                "exists, or --resume-g): the frozen feature space is the TRAINED trunk, not a "
                "random one.")
        backbone.load_state_dict(trunk_feature_params(state.g_params, trunk_taps))
        print(f"Content loss backbone: frozen generator trunk (taps {trunk_taps}).")

    train_step = make_gan_train_step(generator, discriminator, backbone, g_tx, d_tx, geo, kcfg,
                                     dcfg, cfg)
    eval_fn = make_eval_fn(build_generator(model_cfg, cfg, device, training=False))
    niqe_model = NIQE(crop_border=model_cfg.upscale_factor, device=device)

    os.makedirs(samples_dir, exist_ok=True)
    os.makedirs(results_dir, exist_ok=True)
    writer = None
    if not args.no_tensorboard:
        from torch.utils.tensorboard import SummaryWriter

        writer = SummaryWriter(os.path.join("samples", "logs", cfg.exp_name))

    epochs = cfg.epochs
    storm_hist = deque(maxlen=32)
    saver = ckpt_lib.AsyncSaver() if cfg.async_checkpoint else None
    for epoch in range(start_epoch, epochs):
        meters = {name: AverageMeter(name, "6.6f") for name in
                  ("Pixel", "Content", "Adversarial", "D(HR)", "D(SR)")}
        batch_time = AverageMeter("Time", "6.3f")
        progress = ProgressMeter(steps_per_epoch, [batch_time, *meters.values()],
                                 prefix=f"Epoch: [{epoch + 1}]")
        end = time.time()
        # per-batch resize-upscale coins, epoch-seeded so resume draws them again
        coin_rng = np.random.default_rng((cfg.seed, epoch, 17))
        # every step's metrics add up on the device; the host reads one window
        # mean per print interval
        acc, window_n = None, 0
        for batch_index, hr_uint8 in enumerate(DevicePrefetcher(loader, device)):
            up1 = bool(coin_rng.random() < dcfg.resize_probs1[0])
            up2 = bool(coin_rng.random() < dcfg.resize_probs2[0])
            state, metrics = train_step(state, hr_uint8, up1, up2)
            acc = metrics if acc is None else {k: acc[k] + v for k, v in metrics.items()}
            window_n += 1
            if batch_index % cfg.print_frequency == 0:
                keys = list(acc)
                m = dict(zip(keys, (v / window_n for v in
                                    torch.stack([acc[k].float() for k in keys]).tolist())))
                n, window_steps = batch * window_n, window_n
                acc, window_n = None, 0
                for name, key in (("Pixel", "pixel"), ("Content", "content"),
                                  ("Adversarial", "adversarial"), ("D(HR)", "d_hr_prob"),
                                  ("D(SR)", "d_sr_prob")):
                    meters[name].update(m[key], n)
                g_rejected = m.get("g_rejected", 0.0) * window_steps
                rejected = g_rejected + m.get("d_rejected", 0.0) * window_steps
                g_scale = float(state.g_guard.lr_scale)
                if rejected or not all(np.isfinite(m[k]) for k in
                                       ("g_loss", "d_loss", "g_grad_norm", "d_grad_norm")):
                    print(f"WARNING: {rejected:.0f} rejected update(s) in window (G loss "
                          f"{m['g_loss']}, D loss {m['d_loss']}, grad norms G "
                          f"{m['g_grad_norm']} / D {m['d_grad_norm']}); "
                          f"{notfinite_count(state.g_guard)}/{notfinite_count(state.d_guard)} "
                          f"G/D rejected, {rollback_count(state.g_guard)} G EMA rollbacks "
                          f"total, G lr_scale {g_scale:.4f} — the guard is holding training "
                          "on healthy weights.", flush=True)
                check_storm(storm_hist, window_steps, g_rejected, g_scale, args.abort_on_storm,
                            saver, what="G updates")
                if writer is not None:
                    iters = batch_index + epoch * steps_per_epoch + 1
                    for tag, key in (("D_Loss", "d_loss"), ("G_Loss", "g_loss"),
                                     ("Pixel_Loss", "pixel"), ("Content_Loss", "content"),
                                     ("Adversarial_Loss", "adversarial"),
                                     ("D(HR)_Probability", "d_hr_prob"),
                                     ("D(SR)_Probability", "d_sr_prob")):
                        writer.add_scalar(f"Train/{tag}", m[key], iters)
                batch_time.update(time.time() - end)
                progress.display(batch_index)
            else:
                batch_time.update(time.time() - end)
            end = time.time()

        # best_niqe folds in only on saving epochs, so g_best always names a
        # checkpoint that exists
        saving = (epoch + 1) % cfg.checkpoint_frequency == 0 or (epoch + 1) == epochs
        if not saving and writer is None:
            continue  # the NIQE would be discarded
        valid_niqe = (validate(eval_fn, state.g_ema, valid_ds, niqe_model, "Valid", epoch,
                               device, writer, scale=model_cfg.upscale_factor)
                      if valid_ds else None)
        test_niqe = (validate(eval_fn, state.g_ema, test_ds, niqe_model, "Test", epoch, device,
                              writer, scale=model_cfg.upscale_factor)
                     if test_ds else None)
        print("")
        if not saving:
            continue
        # best: test NIQE, else valid NIQE; with no evaluation at all every
        # saving epoch refreshes g_best and d_best
        signal = test_niqe if test_niqe is not None else valid_niqe
        is_best = signal < best_niqe if signal is not None else True
        if signal is not None:
            best_niqe = min(signal, best_niqe)
        g_payload, d_payload = checkpoint_payloads(state, epoch + 1, best_niqe)
        items = []
        for kind, payload in (("g", g_payload), ("d", d_payload)):
            copies = ([os.path.join(results_dir, f"{kind}_best")] if is_best else []) \
                + [os.path.join(results_dir, f"{kind}_last")]
            items.append((os.path.join(samples_dir, f"{kind}_epoch_{epoch + 1}"), payload,
                          copies))
        save_epoch(saver, items)
        print(f"Saving `{items[0][0]}` and `{items[1][0]}` with their "
              f"{'best and ' if is_best else ''}last copies "
              f"({'asynchronously' if saver is not None else 'synchronously'}).", flush=True)
        failsafe(saver)
    if saver is not None:
        saver.wait()  # the last checkpoints are durable before the CLI returns


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Real-ESRGAN stage-2 GAN training "
                                                 "(PyTorch/CUDA)")
    parser.add_argument("--epochs", type=int, default=0, help="override config")
    parser.add_argument("--batch-size", type=int, default=0)
    parser.add_argument("--lr", type=float, default=0.0,
                        help="override the config learning rate")
    parser.add_argument("--warmup-steps", type=int, default=-1,
                        help="linear LR warmup steps (-1 = config default)")
    parser.add_argument("--train-clamp", type=str, default="",
                        choices=("", "none", "st", "hard"),
                        help="G training-loss output clamp mode (default: config)")
    parser.add_argument("--abort-on-storm", action="store_true",
                        help="exit rc=3 when the guard reports a rollback storm")
    parser.add_argument("--resume", type=str, default="",
                        help="stage-1 generator weights to warm-start G from")
    parser.add_argument("--resume-g", type=str, default="",
                        help="a g_epoch_N checkpoint directory, or auto: the newest")
    parser.add_argument("--resume-d", type=str, default="",
                        help="a d_epoch_N checkpoint directory, or auto: the newest")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of CUDA")
    parser.add_argument("--synthetic", action="store_true",
                        help="train on random data (smoke test / benchmarking)")
    parser.add_argument("--steps-per-epoch", type=int, default=8,
                        help="steps per epoch in --synthetic mode")
    parser.add_argument("--no-tensorboard", action="store_true")
    parser.add_argument("--checkpoint-frequency", type=int, default=0,
                        help="save every N epochs (0 = config default); the last epoch "
                             "always saves")
    parser.add_argument("--loader", type=str, default="",
                        choices=("", "auto", "device", "grain", "threads"),
                        help="training data loader (default: config); device and grain "
                             "are not yet ported")
    parser.add_argument("--train-dir", type=str, default="")
    parser.add_argument("--valid-dir", type=str, default="")
    parser.add_argument("--test-lr-dir", type=str, default="")
    parser.add_argument("--test-hr-dir", type=str, default="")
    parser.add_argument("--exp-name", type=str, default="",
                        help="override config exp_name (samples/results dirs)")
    parser.add_argument("--content-backbone", type=str, default="vgg",
                        choices=("vgg", "trunk"),
                        help="perceptual feature space: VGG19 (the reference's) or the "
                             "frozen stage-1 generator trunk (no external weights needed)")
    parser.add_argument("--allow-random-vgg", action="store_true",
                        help="allow GAN training with random VGG features when no "
                             "pretrained weights exist")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
