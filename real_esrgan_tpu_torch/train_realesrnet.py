"""RealESRNet (stage-1) training: the port of the root ``train_realesrnet.py``.

    python -m real_esrgan_tpu_torch.train_realesrnet --train-dir data/InEnv2/train \\
        --exp-name MyRun --epochs 500 --batch-size 16 --no-tensorboard --resume auto
    python -m real_esrgan_tpu_torch.train_realesrnet --cpu --synthetic --epochs 1 \\
        --steps-per-epoch 2 --batch-size 2 --no-tensorboard     # a smoke run

The same epoch loop as the JAX trainer: train (the degradation on the device,
the forward and backward of the training model, the guarded Adam step and
the EMA: ``train/esrnet.py``), validate the EMA weights with NIQE, save the
epoch checkpoint under ``samples/<exp>/g_epoch_N`` with ``results/<exp>/
g_best`` and ``g_last`` copies, and ``--resume auto`` from the newest one.
The values come from ``real_esrgan_tpu_torch.config``; the flags are the
root script's, plus ``--cpu``.  Without CUDA and without ``--cpu`` it raises.

A saving epoch's checkpoint is written by ``AsyncSaver`` while the next
epoch trains (synchronously where ``async_checkpoint`` is off), then the
host-memory failsafe runs: past 80% of the machine's RAM the run exits
rc=4, for a fresh process to resume.  Both TF32 flags are turned off, so
``use_bfloat16=False`` trains in float32.  ``--loader`` takes the JAX
trainer's choices (``make_train_loader``): ``auto`` (the device-resident
pool, else the C++ decode loader, else Python threads), ``device``,
``grain`` (the resumable stream, whose position is saved at every saving
epoch and restored on resume) and ``threads``.

Data parallel, one rank a GPU (``parallel/mesh.py``), under torchrun or with
the JAX CLI's launch names::

    torchrun --nproc_per_node=N -m real_esrgan_tpu_torch.train_realesrnet ...
    COORDINATOR_ADDRESS=host:port NUM_PROCESSES=N PROCESS_ID=r \
        python -m real_esrgan_tpu_torch.train_realesrnet ...

``--batch-size`` is the global batch, rounded down to a multiple of the
world size; each rank loads ``batch / world`` (its shard of the data, or of
each pool batch) and the step averages the gradients over the ranks.  The
lead (rank 0) resolves ``--resume auto`` and loads the checkpoint, and
every rank gets the path and the state from it, so no filesystem needs to
be shared; only the lead validates and writes checkpoints, while each rank
saves its own grain stream position (``loader_state_p{rank}.bin``).
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
from real_esrgan_tpu_torch.data import grain_loader, native_loader
from real_esrgan_tpu_torch.data.dataset import (
    ThreadedLoader, TrainImageDataset, build_eval_datasets,
)
from real_esrgan_tpu_torch.data.device_pool import DevicePoolLoader, build_pool_array
from real_esrgan_tpu_torch.data.prefetcher import DevicePrefetcher
from real_esrgan_tpu_torch.metrics.niqe import NIQE
from real_esrgan_tpu_torch.parallel.mesh import (
    broadcast_pytree, broadcast_string, is_lead, local_device, process_group, rank, single_host,
    world_size,
)
from real_esrgan_tpu_torch.train import checkpoint as ckpt_lib
from real_esrgan_tpu_torch.train.esrnet import (
    TrainState, build_generator, build_optimizer, init_state, make_eval_fn, make_train_step,
    notfinite_count, rollback_count,
)
from real_esrgan_tpu_torch.train.guard import guard_from_dict, guard_to_dict
from real_esrgan_tpu_torch.train.optim import AdamState
from real_esrgan_tpu_torch.utils import hostmem
from real_esrgan_tpu_torch.utils.meters import AverageMeter, ProgressMeter

LR_SCALE_FLOOR = 1.0 / 64.0


LOADERS = ("auto", "device", "grain", "threads")


def make_train_loader(train_ds, batch: int, cfg, geo, device, sharded: bool = True):
    """The training batch loader of ``cfg.loader``, the JAX trainer's chain.

    ``auto`` takes the device-resident pool (``data/device_pool.py``: the
    whole crop set on ``device``, each batch gathered there by index) when
    the set fits ``cfg.device_pool_budget_bytes``; then the C++ decode and
    crop pool (GIL-free, ``cfg.decoded_cache_bytes`` of decoded images in
    RAM) where it builds; then Python threads.  ``device`` forces the pool
    and raises if the set does not fit or is not ``hr_size``-square;
    ``grain`` takes the resumable stream loader; ``threads`` forces Python
    threads.  Each choice prints the loader it took.

    ``batch`` is the rank's batch.  ``sharded``: each rank loads its shard
    (``rank()`` of ``world_size()``): the host loaders a disjoint stride of
    the set, the pool its share of each global batch; without it every rank
    iterates the whole set (the synthetic set is already a rank's size).  As
    in the JAX trainer the pool is refused across hosts (``--loader
    device``) or passed over (``auto``); the GPUs of one host may share it."""
    mode = cfg.loader
    if mode not in LOADERS:
        raise ValueError(f"unknown loader {mode!r}; choose one of {LOADERS}")
    shard_id, num_shards = (rank(), world_size()) if sharded else (0, 1)
    if mode == "device" and not single_host():
        raise ValueError("--loader device is single-host only; a run across hosts keeps the "
                         "sharded host loaders")
    pool_budget = cfg.device_pool_budget_bytes
    if mode == "device" or (mode == "auto" and pool_budget and single_host()):
        pool = build_pool_array(train_ds, geo.hr_size, pool_budget or (1 << 62))
        if pool is not None:
            print(f"Using device-resident pool loader ({pool.nbytes / 1e6:.0f} MB on {device}).")
            return DevicePoolLoader(pool, batch * num_shards, seed=cfg.seed, device=device,
                                    rank=shard_id, world=num_shards)
        if mode == "device":
            raise ValueError("--loader device: dataset exceeds device_pool_budget_bytes or "
                             "images are not uniformly hr_size-shaped")
    if mode == "grain":
        if not hasattr(train_ds, "files"):
            raise ValueError("--loader grain streams image files; this dataset has none "
                             "(--synthetic takes auto, device or threads)")
        print("Using grain-contract stream loader (torch.utils.data workers).")
        return grain_loader.GrainLoader(train_ds.files, batch, geo.hr_size,
                                        num_workers=cfg.num_workers, seed=cfg.seed,
                                        shard_id=shard_id, num_shards=num_shards)
    if mode == "auto" and hasattr(train_ds, "files"):
        if native_loader.available():
            print("Using native C++ data loader.")
            return native_loader.NativeThreadedLoader(
                train_ds.files, batch, geo.hr_size, num_threads=cfg.num_workers, seed=cfg.seed,
                cache_bytes=cfg.decoded_cache_bytes, shard_id=shard_id, num_shards=num_shards)
        print(f"Native loader unavailable ({native_loader.unavailable_reason().splitlines()[0]}); "
              "using Python threads.")
    print("Using Python threaded loader.")
    return ThreadedLoader(train_ds, batch, cfg.num_workers, seed=cfg.seed,
                          shard_id=shard_id, num_shards=num_shards)


class SyntheticHRDataset:
    """Random uint8 crops: lets the whole trainer run without a dataset."""

    def __init__(self, hr_size: int, length: int = 256, seed: int = 0):
        self.hr_size = hr_size
        self.length = length
        base = np.random.default_rng(seed)
        self._images = (base.random((8, hr_size, hr_size, 3)) * 255).astype(np.uint8)

    def __len__(self):
        return self.length

    def load(self, index: int, rng: np.random.Generator) -> np.ndarray:
        return self._images[index % len(self._images)]


def validate(eval_fn, params, dataset, niqe_model, name: str, epoch: int, device,
             writer=None, scale: int = 4, bucket: int = 32) -> float:
    """Per-epoch NIQE over a directory of images of any size.  Each LR image
    is reflect-padded (edge-padded where the pad exceeds it) up to multiples
    of ``bucket`` before the forward and its output cropped back, as the
    JAX trainer does."""
    niqe_meter = AverageMeter("NIQE", "4.2f")
    for i in range(len(dataset)):
        lr = dataset[i]["lr"]
        h, w, _ = lr.shape
        hb = -(-h // bucket) * bucket
        wb = -(-w // bucket) * bucket
        mode = "reflect" if min(h, w) > max(hb - h, wb - w) else "edge"
        padded = np.pad(lr, ((0, hb - h), (0, wb - w), (0, 0)), mode=mode)
        sr = eval_fn(params, torch.from_numpy(np.ascontiguousarray(padded[None])).to(device))
        sr = sr[:, :h * scale, :w * scale]
        niqe_meter.update(float(niqe_model(sr)[0]), 1)
    print(f"{name}: * NIQE {niqe_meter.avg:4.2f}", flush=True)
    if writer is not None:
        writer.add_scalar(f"{name}/NIQE", niqe_meter.avg, epoch + 1)
    return niqe_meter.avg


def restore_opt_state(template: AdamState, saved) -> AdamState:
    """The saved optimizer state where its names and shapes are the live
    ones; otherwise a loud warning and ``template``, the fresh state."""
    return AdamState(**ckpt_lib.restore_like(template.as_dict(), saved, "opt_state",
                                             on_mismatch="template"))


def checkpoint_payload(state: TrainState, epoch: int, best_niqe: float) -> dict:
    """The epoch checkpoint's payload (the JAX trainer's fields)."""
    return {"epoch": epoch, "best_niqe": best_niqe, "step": state.step,
            "params": state.params, "ema_params": state.ema_params,
            "opt_state": state.opt_state.as_dict(),
            "guard": guard_to_dict(state.guard)}


def resume_state(state: TrainState, path: str, device):
    """(state, start_epoch, best_niqe) from the checkpoint directory ``path``."""
    tree = ckpt_lib.load_checkpoint(path)
    to = lambda d: {k: v.to(device) for k, v in d.items()}  # noqa: E731
    state = TrainState(
        step=int(tree["step"]),
        params=to(ckpt_lib.merge_matching(state.params, tree["params"])),
        ema_params=to(ckpt_lib.merge_matching(state.ema_params, tree["ema_params"])),
        opt_state=restore_opt_state(state.opt_state, tree.get("opt_state")),
        guard=guard_from_dict(tree.get("guard"), device))
    return state, int(tree.get("epoch", 0)), float(tree.get("best_niqe", 100.0))


def _configure(args):
    cfg = run_config.train_esrnet
    overrides = {"epochs": args.epochs, "checkpoint_frequency": args.checkpoint_frequency,
                 "loader": args.loader, "train_image_dir": args.train_dir,
                 "valid_image_dir": args.valid_dir, "test_lr_image_dir": args.test_lr_dir,
                 "test_hr_image_dir": args.test_hr_dir, "lr": args.lr,
                 "train_clamp": args.train_clamp}
    cfg = dataclasses.replace(cfg, **{k: v for k, v in overrides.items() if v})
    if args.warmup_steps >= 0:
        cfg = dataclasses.replace(cfg, lr_warmup_steps=args.warmup_steps)
    return cfg


def main(args) -> None:
    with process_group("gloo" if args.cpu else None):
        train(args)


def global_batch(batch: int, world: int) -> int:
    """``batch`` rounded down to a multiple of ``world`` (at least ``world``),
    as the JAX trainer rounds it to its device count."""
    if batch % world:
        batch = (batch // world) * world or world
        print(f"Adjusted batch size to {batch} for {world} ranks.")
    return batch


def train(args) -> None:
    device = local_device(args.cpu)
    # f32 convolutions and products in true f32 (PyTorch lets cuDNN use TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world, lead = world_size(), is_lead()
    print(f"Training on {device}, rank {rank()} of {world} (TF32 off for matmul and cuDNN).")
    geo = run_config.geometry
    kcfg = run_config.kernel_synthesis
    dcfg = run_config.degradation
    model_cfg = run_config.model
    cfg = _configure(args)
    exp_name = args.exp_name or run_config.exp_name
    batch = global_batch(args.batch_size or cfg.batch_size, world)
    local_batch = batch // world

    if args.synthetic:
        # a rank-sized set keeps --steps-per-epoch at any world size
        train_ds = SyntheticHRDataset(geo.hr_size, length=args.steps_per_epoch * local_batch)
        valid_ds, test_ds = [], []
    else:
        train_ds = TrainImageDataset(cfg.train_image_dir, geo.hr_size,
                                     cache_bytes=cfg.decoded_cache_bytes)
        valid_ds, test_ds = build_eval_datasets(cfg.valid_image_dir, cfg.test_lr_image_dir,
                                                cfg.test_hr_image_dir, geo.crop_size, geo.scale)
    loader = make_train_loader(train_ds, local_batch, cfg, geo, device,
                               sharded=not args.synthetic)
    steps_per_epoch = len(loader)
    print(f"Loaded datasets: {len(train_ds)} train images, {steps_per_epoch} steps/epoch, "
          f"{world} ranks of {local_batch}.")

    model = build_generator(model_cfg, cfg, device, training=True,
                            generator=torch.Generator().manual_seed(cfg.seed))
    opt = build_optimizer(cfg, steps_per_epoch)
    state = init_state(model, opt)
    eval_model = build_generator(model_cfg, cfg, device, training=False) if lead else None
    print("Build all model successfully.")

    samples_dir = os.path.join("samples", exp_name)
    results_dir = os.path.join("results", exp_name)
    start_epoch, best_niqe = 0, 100.0
    resume = args.resume or cfg.resume
    if resume == "auto":
        # the lead writes the checkpoints: it resolves the path and sends it
        resume = broadcast_string(ckpt_lib.find_latest_checkpoint(samples_dir) if lead else "")
        if not resume:
            print("--resume auto: no checkpoint found, starting fresh.")
    if resume and lead:
        state, start_epoch, best_niqe = resume_state(state, resume, device)
    # every rank starts from the lead's state, resumed or fresh
    state, start_epoch, best_niqe = broadcast_pytree((state, start_epoch, best_niqe))
    if resume:
        print(f"Resumed from `{resume}` at epoch {start_epoch}.")
        if grain_loader.restore_loader_state(loader, samples_dir, start_epoch, rank()):
            print("Restored data-loader stream position.")

    train_step = make_train_step(
        model, opt, geo, kcfg, dcfg, cfg.ema_decay, seed=cfg.seed,
        reject_limit=cfg.grad_reject_limit, rollback_after=cfg.rollback_after,
        guard_updates=cfg.skip_nonfinite_updates, reject_mult=cfg.grad_reject_mult,
        clamp_mode=cfg.train_clamp)
    eval_fn = make_eval_fn(eval_model) if lead else None
    niqe_model = NIQE(crop_border=model_cfg.upscale_factor, device=device) if lead else None

    os.makedirs(samples_dir, exist_ok=True)  # every rank's loader state lands here
    writer = None
    if lead:
        os.makedirs(results_dir, exist_ok=True)
        if not args.no_tensorboard:
            from torch.utils.tensorboard import SummaryWriter

            writer = SummaryWriter(os.path.join("samples", "logs", exp_name))

    epochs = cfg.epochs
    # trailing-window rejection telemetry: a rollback storm turns into a loud
    # verdict, and --abort-on-storm exits rc=3
    storm_hist = deque(maxlen=32)
    saver = ckpt_lib.AsyncSaver() if cfg.async_checkpoint and lead else None
    for epoch in range(start_epoch, epochs):
        batch_time = AverageMeter("Time", "6.3f")
        data_time = AverageMeter("Data", "6.3f")
        losses = AverageMeter("Loss", "6.6f")
        gnorms = AverageMeter("GNorm", "6.3f")
        progress = ProgressMeter(steps_per_epoch, [batch_time, data_time, losses, gnorms],
                                 prefix=f"Epoch: [{epoch + 1}]")
        end = time.time()
        # per-batch resize-upscale coins, epoch-seeded so resume draws them again
        coin_rng = np.random.default_rng((cfg.seed, epoch, 17))
        # the loss, grad norm and rejections add up on the device; the host
        # reads one window mean per print interval
        loss_window, gn_window, rej_window, window_n = None, None, None, 0
        for batch_index, hr_uint8 in enumerate(DevicePrefetcher(loader, device)):
            data_time.update(time.time() - end)
            up1 = bool(coin_rng.random() < dcfg.resize_probs1[0])
            up2 = bool(coin_rng.random() < dcfg.resize_probs2[0])
            state, metrics = train_step(state, hr_uint8, up1, up2)
            loss_window = metrics["loss"] if loss_window is None else loss_window + metrics["loss"]
            gn_window = (metrics["grad_norm"] if gn_window is None
                         else gn_window + metrics["grad_norm"])
            rej = metrics.get("rejected")
            if rej is not None:
                rej_window = rej if rej_window is None else rej_window + rej
            window_n += 1
            if batch_index % cfg.print_frequency == 0:
                loss = float(loss_window) / window_n
                gnorm = float(gn_window) / window_n
                losses.update(loss, batch * window_n)
                gnorms.update(gnorm, batch * window_n)
                rejected = float(rej_window) if rej_window is not None else 0.0
                window_steps = window_n
                loss_window, gn_window, rej_window, window_n = None, None, None, 0
                lr_scale_now = float(state.guard.lr_scale)
                if rejected or not np.isfinite(loss) or not np.isfinite(gnorm):
                    print(f"WARNING: {rejected:.0f} rejected update(s) in window (loss {loss}, "
                          f"grad norm {gnorm}); {notfinite_count(state.guard)} rejected / "
                          f"{rollback_count(state.guard)} EMA rollbacks total, lr_scale "
                          f"{lr_scale_now:.4f} — the guard is holding training on healthy "
                          "weights.", flush=True)
                check_storm(storm_hist, window_steps, rejected, lr_scale_now,
                            args.abort_on_storm, saver)
                if writer is not None:
                    writer.add_scalar("Train/Loss", loss,
                                      batch_index + epoch * steps_per_epoch + 1)
                batch_time.update(time.time() - end)
                progress.display(batch_index)
            else:
                batch_time.update(time.time() - end)
            end = time.time()

        # best_niqe folds in only on saving epochs, so g_best always names a
        # checkpoint that exists
        saving = (epoch + 1) % cfg.checkpoint_frequency == 0 or (epoch + 1) == epochs
        if saving:  # the stream position the next epoch starts from, a file a rank
            grain_loader.save_loader_state(loader, samples_dir, epoch + 1, rank())
        # validation and checkpoint IO run on the lead alone; the other ranks
        # wait for it in the next step's collective
        if lead and (saving or writer is not None):
            best_niqe = validate_and_save(
                eval_fn, state, valid_ds, test_ds, niqe_model, epoch, device, writer, saving,
                best_niqe, exp_name, samples_dir, results_dir, saver, model_cfg.upscale_factor)
        if saving:
            failsafe(saver)
    if saver is not None:
        saver.wait()  # the last checkpoint is durable before the CLI returns


def validate_and_save(eval_fn, state: TrainState, valid_ds, test_ds, niqe_model, epoch: int,
                      device, writer, saving: bool, best_niqe: float, exp_name: str,
                      samples_dir: str, results_dir: str, saver, scale: int) -> float:
    """The lead's end of an epoch: the EMA weights' NIQE on the valid and test
    sets, then, on a saving epoch, the epoch checkpoint with its ``g_best``
    and ``g_last`` copies.  Returns the best NIQE."""
    valid_niqe = (validate(eval_fn, state.ema_params, valid_ds, niqe_model, "Valid", epoch,
                           device, writer, scale=scale)
                  if valid_ds else None)
    test_niqe = (validate(eval_fn, state.ema_params, test_ds, niqe_model, "Test", epoch,
                          device, writer, scale=scale)
                 if test_ds else None)
    print("")
    if not saving:
        return best_niqe
    # best: test NIQE, else valid NIQE; with no evaluation at all the last
    # saving epoch is the best guess (g_best must exist: it is stage 2's
    # default warm start)
    signal = test_niqe if test_niqe is not None else valid_niqe
    is_best = signal < best_niqe if signal is not None else True
    if signal is not None:
        if best_niqe < 100.0 and signal > max(3.0 * best_niqe, best_niqe + 30.0):
            print(f"WARNING: eval NIQE {signal:.2f} is far above the best {best_niqe:.2f} "
                  f"— the model may have diverged ({notfinite_count(state.guard)} rejected "
                  f"updates, {rollback_count(state.guard)} EMA rollbacks so far). Consider "
                  f"resuming from results/{exp_name}/g_best.", flush=True)
        best_niqe = min(signal, best_niqe)
    epoch_path = os.path.join(samples_dir, f"g_epoch_{epoch + 1}")
    # g_last tracks every saving epoch, so an interrupted run leaves one
    copies = ([os.path.join(results_dir, "g_best")] if is_best else []) \
        + [os.path.join(results_dir, "g_last")]
    items = [(epoch_path, checkpoint_payload(state, epoch + 1, best_niqe), copies)]
    save_epoch(saver, items)
    print(f"Saving `{epoch_path}` and {', '.join(os.path.basename(d) for d in copies)} "
          f"({'asynchronously' if saver is not None else 'synchronously'}).", flush=True)
    return best_niqe


def check_storm(storm_hist: deque, window_steps: int, rejected: float, lr_scale: float,
                abort: bool, saver, what: str = "updates") -> None:
    """The storm monitor: ``storm_hist`` keeps (steps, rejections) of the
    last printed windows; over at least 200 trailing steps, more than 10%
    rejected (2% once ``lr_scale`` sits on its floor) is a rollback storm,
    printed as a verdict; with ``abort`` the save in flight is finished and
    the run exits rc=3."""
    storm_hist.append((window_steps, rejected))
    trail_steps = sum(s for s, _ in storm_hist)
    trail_rej = sum(r for _, r in storm_hist)
    if trail_steps < 200 or not trail_rej or not (
            trail_rej / trail_steps > 0.10
            or (lr_scale <= LR_SCALE_FLOOR + 1e-9 and trail_rej / trail_steps > 0.02)):
        return
    print(f"STORM: training is NOT progressing — {trail_rej:.0f}/{trail_steps} recent {what} "
          f"rejected ({100 * trail_rej / trail_steps:.1f}%), lr_scale {lr_scale:.4f}. The guard "
          "is in a rollback storm; this run will not produce a usable model at the current "
          "settings.", flush=True)
    if abort:
        if saver is not None:
            saver.wait()
        print("Aborting (rc=3): --abort-on-storm set. Resume from the last healthy checkpoint "
              "with a lower --lr or different guard settings.", flush=True)
        raise SystemExit(3)


def save_epoch(saver, items) -> None:
    """``items`` through ``saver.save_many``, or written at once without one."""
    if saver is not None:
        saver.save_many(items)
    else:
        ckpt_lib.write_checkpoints(items)


def failsafe(saver, watermark: float = 0.8) -> None:
    """The host-memory failsafe after a checkpoint: past ``watermark`` the
    save in flight is finished and the run exits rc=4 (``utils/hostmem.py``).
    The lead's reading decides for every rank, so no rank is left waiting
    in a collective for one that exited."""
    over = broadcast_pytree(is_lead() and hostmem.host_memory_fraction() >= watermark)
    if over:
        if saver is not None:
            saver.wait()
        if is_lead():
            hostmem.check_host_memory(watermark)
        if world_size() > 1:
            raise SystemExit(hostmem.RESTART_EXIT_CODE)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="RealESRNet stage-1 training (PyTorch/CUDA)")
    parser.add_argument("--epochs", type=int, default=0, help="override config")
    parser.add_argument("--batch-size", type=int, default=0)
    parser.add_argument("--lr", type=float, default=0.0,
                        help="override the config learning rate")
    parser.add_argument("--warmup-steps", type=int, default=-1,
                        help="linear LR warmup steps (-1 = config default)")
    parser.add_argument("--train-clamp", type=str, default="",
                        choices=("", "none", "st", "hard"),
                        help="training-loss output clamp mode (default: config)")
    parser.add_argument("--abort-on-storm", action="store_true",
                        help="exit rc=3 when the guard reports a rollback storm "
                             "(trailing rejection rate >10%%)")
    parser.add_argument("--resume", type=str, default="",
                        help="a checkpoint directory, or auto: the newest epoch checkpoint")
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
                        choices=("", *LOADERS),
                        help="training data loader (default: config)")
    parser.add_argument("--train-dir", type=str, default="")
    parser.add_argument("--valid-dir", type=str, default="")
    parser.add_argument("--test-lr-dir", type=str, default="")
    parser.add_argument("--test-hr-dir", type=str, default="")
    parser.add_argument("--exp-name", type=str, default="",
                        help="override config exp_name (samples/results dirs)")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
