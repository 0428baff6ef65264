"""Benchmark suite: the four headline throughput metrics on one GPU.  The port
of the root ``bench.py``.

    python -m real_esrgan_tpu_torch.bench                 # all four, flagship last
    python -m real_esrgan_tpu_torch.bench --mode tiled    # one metric
    python -m real_esrgan_tpu_torch.bench --cpu --mode inference --batch 1 --lr-size 32

Default (no arguments) measures all four and prints one JSON line a metric,
inference last so that a reader of the last line gets the flagship number,
which also carries the other three as extra keys:

  x4_train_images_per_sec_per_chip        ESRNet step (degradation + bf16
                                          fwd/bwd + guarded Adam + EMA)
  x4_gan_train_images_per_sec_per_chip    G+D GAN step
  x4_tiled_2k_to_8k_megapixels_per_sec    overlap-tile 2K -> 8K serving
  x4_sr_output_megapixels_per_sec_per_chip  flagship batch inference

Methodology: the bf16 generator (23 RRDBs, 64 channels), weights drawn from
seed 0.  Inference is a chained loop (iteration i+1 consumes a slice of
iteration i's output) launched whole and closed by one scalar read, so the
device runs the iterations back to back and the host clock measures them;
the generator is in evaluation mode, so its RDBs run the fused RDB kernel.
Train and GAN feed state i into step i + 1 (hr 400 -> crop 256, remat off,
the trainers' resize coins) and close with one loss read; their forward runs
the RDBs' plain math, as the trainers do.  Tiled serving runs the device part
of ``parallel/tiling.py`` (``tiled_canvas``) on an image padded once outside
the timed loop, reading one scalar of the 8K canvas a call.  Each rate is the
median of three timed passes over the same warm program.

FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode`` over one
untimed call: inference and tiled on a twin of the generator on the ``meta``
device with the plain RDB math (the counter cannot see the RDB kernel, and
the plain math computes the same convolutions), tiled over every tile batch
the call runs, a short last batch included; train and GAN over one step on
the device.  Each line carries ``effective_tflops`` and, on a GPU, ``mfu``:
its share of an H100 SXM's dense bf16 peak, ``peak_tflops``, beside the
card's name and power limit as nvidia-smi prints them.

A stage of ``--mode all`` that raises is reported as ``# <mode> stage
failed`` while the others run, and the process then exits 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Callable, List, Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from real_esrgan_tpu_torch.configuration import (
    DegradationConfig, GanTrainConfig, KernelSynthesisConfig, ModelConfig, PipelineGeometry,
    TrainConfig,
)
from real_esrgan_tpu_torch.models.rrdbnet import Generator
from real_esrgan_tpu_torch.ops.fused_rdb import fused_rdb
from real_esrgan_tpu_torch.parallel.mesh import local_device, local_devices
from real_esrgan_tpu_torch.parallel.tiling import (
    pad_for_tiles, round_tile_batch, tile_grid, tiled_canvas,
)
from real_esrgan_tpu_torch.serve import no_grad_forward

# Dense bf16 tensor-core peak of one H100 SXM (NVIDIA's data sheet, at the
# 700 W power limit); ``mfu`` is a line's effective rate over it.
H100_BF16_PEAK_TFLOPS = 989.4
PEAK_NOTE = "H100 SXM dense bf16 peak (NVIDIA data sheet, 700 W)"

# Long-running jobs on the GPU hold this lock; the bench waits for it to go.
GPU_BUSY_LOCK = os.environ.get("GPU_BUSY_LOCK",
                               os.path.join(tempfile.gettempdir(), "gpu_busy.lock"))

# The measured configuration (the tests shrink these).
MODEL = ModelConfig()
TRAIN_GEOMETRY = PipelineGeometry(hr_size=400, crop_size=256, scale=4)
DEGRADATION = DegradationConfig()


@dataclasses.dataclass
class Measured:
    """A rate, the FLOPs of one unit of it (an output megapixel, a training
    image) where they were counted, and keys the line carries beside it."""
    value: float
    flops_per_unit: Optional[float] = None
    extra: dict = dataclasses.field(default_factory=dict)


def _pid_gone(path: str) -> bool:
    """True when the lock's recorded holder PID ("<tag> <pid> <ts>") is no
    longer alive.  An unparsable lock is treated as live: waiting on a busy
    GPU beats measuring one."""
    try:
        with open(path) as f:
            pid = int(f.read().split()[1])
    except (OSError, IndexError, ValueError):
        return False
    return not os.path.exists(f"/proc/{pid}")


def wait_for_idle_chip(max_wait_s: float = 1800.0) -> bool:
    """Block while GPU_BUSY_LOCK exists (up to max_wait_s).  Returns True if
    the GPU was contended at any point: the lines then carry ``contended``."""
    contended = False
    t0 = time.time()
    while os.path.exists(GPU_BUSY_LOCK):
        if _pid_gone(GPU_BUSY_LOCK):
            print(f"# removing stale {GPU_BUSY_LOCK} (holder PID dead)", flush=True)
            try:
                os.remove(GPU_BUSY_LOCK)
            except OSError:
                pass
            break
        contended = True
        waited = time.time() - t0
        if waited >= max_wait_s:
            print(f"# WARNING: {GPU_BUSY_LOCK} still present after {waited:.0f}s — "
                  "measuring anyway; numbers may be contended", flush=True)
            return True
        if waited % 120 < 15:
            print(f"# GPU busy ({GPU_BUSY_LOCK} held) — waiting ({waited:.0f}s)", flush=True)
        time.sleep(15)
    return contended


def card_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             "-i", str(index)], capture_output=True, text=True, check=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(index)}, power limit not read"


def _median_rate(timed_once: Callable[[], float], repeats: int = 3) -> float:
    """Median of ``repeats`` timed passes over the same warm program."""
    return statistics.median(timed_once() for _ in range(repeats))


def count_flops(fn: Callable, *args) -> int:
    """FLOPs of ``fn(*args)`` as ``FlopCounterMode`` counts them (convolutions
    and matrix products, forward and backward)."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def _bf16_generator(device, plain: bool = False) -> Generator:
    """The measured generator in bf16 and evaluation mode, weights from seed
    0; ``plain`` runs its RDBs as ``rdb_plain`` (the FLOP counter's twin)."""
    return Generator(upscale_factor=4, num_rrdb=MODEL.num_rrdb, channels=MODEL.channels,
                     growth=MODEL.growth_channels, dtype=torch.bfloat16, device=device,
                     plain_rdb=plain).eval()


def _resize_flags(iters: int, dcfg: DegradationConfig, mix: bool = True) -> list:
    """Host-drawn per-batch resize-upscale coins (the trainers' mix of canvas
    sizes); ``mix=False`` pins the most probable combo (no upscale in either
    stage), as the all-mode run does."""
    if not mix:
        return [(False, False)] * iters
    coin = np.random.default_rng(7)
    return [(bool(coin.random() < dcfg.resize_probs1[0]),
             bool(coin.random() < dcfg.resize_probs2[0]))
            for _ in range(iters)]


def measure(batch: int, lr_size: int, iters: int, device: torch.device) -> Measured:
    """Flagship x4 inference, output MP/s: ``iters`` chained forwards."""
    model = _bf16_generator(device)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (batch, lr_size, lr_size, 3)).astype(np.float32)).to(device)

    @torch.no_grad()
    def chained(n: int) -> torch.Tensor:
        y = x
        for _ in range(n):
            out = model(y)
            # feed a slice of the output back in: forces serial execution
            y = out[:, :lr_size, :lr_size, :] * 0.999 + 0.0005
        return y

    out_mp = batch * (lr_size * 4) ** 2 / 1e6
    with torch.no_grad():
        flops = count_flops(_bf16_generator("meta", plain=True),
                            torch.empty(x.shape, device="meta"))
    launches = fused_rdb.launches
    float(chained(1)[0, 0, 0, 0])  # kernel build + warmup

    def timed_once() -> float:
        t0 = time.perf_counter()
        float(chained(iters)[0, 0, 0, 0])
        return out_mp * iters / (time.perf_counter() - t0)

    rate = _median_rate(timed_once)
    return Measured(rate, flops / out_mp,
                    {"fused_rdb_launches": fused_rdb.launches - launches})


def _train_batch(batch: int, device) -> torch.Tensor:
    hr = TRAIN_GEOMETRY.hr_size
    return torch.from_numpy((np.random.default_rng(0).random((batch, hr, hr, 3))
                             * 255).astype(np.uint8)).to(device)


def _time_steps(step, state, hr, flags, batch: int, loss_key: str) -> Measured:
    """Counts one untimed step's FLOPs, runs every resize combo once, then
    the median rate of three passes over ``flags``, state i feeding step
    i + 1, each pass closed by one loss read."""
    launches = fused_rdb.launches
    with FlopCounterMode(display=False) as counter:
        state, metrics = step(state, hr, False, False)
    flops = counter.get_total_flops()
    for combo in sorted(set(flags)):
        state, metrics = step(state, hr, *combo)
    float(metrics[loss_key])

    def timed_once() -> float:
        nonlocal state
        t0 = time.perf_counter()
        for f in flags:
            state, m = step(state, hr, *f)
        loss = float(m[loss_key])
        if not math.isfinite(loss):
            raise FloatingPointError(f"{loss_key} is {loss}")
        return batch * len(flags) / (time.perf_counter() - t0)

    rate = _median_rate(timed_once)
    return Measured(rate, flops / batch, {"fused_rdb_launches": fused_rdb.launches - launches})


def measure_train(batch: int, iters: int, device: torch.device, mix: bool = True) -> Measured:
    """ESRNet step (degradation + fwd/bwd + guarded Adam + EMA), imgs/s."""
    from real_esrgan_tpu_torch.train import esrnet

    cfg = TrainConfig(batch_size=batch, remat_rrdb=False)
    model = esrnet.build_generator(MODEL, cfg, device, generator=torch.Generator().manual_seed(0))
    opt = esrnet.build_optimizer(cfg, steps_per_epoch=100)
    step = esrnet.make_train_step(model, opt, TRAIN_GEOMETRY, KernelSynthesisConfig(),
                                  DEGRADATION, cfg.ema_decay)
    return _time_steps(step, esrnet.init_state(model, opt), _train_batch(batch, device),
                       _resize_flags(iters, DEGRADATION, mix), batch, "loss")


def measure_gan(batch: int, iters: int, device: torch.device, mix: bool = True) -> Measured:
    """G+D step (degradation + G fwd/bwd + D fwd/bwd + two guarded Adams +
    EMA + spectral-norm power iteration), imgs/s, random VGG19 backbone."""
    from real_esrgan_tpu_torch.train import esrgan

    cfg = GanTrainConfig(batch_size=batch, remat_rrdb=False)
    generator, discriminator, vgg = esrgan.build_models(MODEL, cfg, device)
    g_tx, d_tx = esrgan.build_optimizers(cfg, steps_per_epoch=100)
    step = esrgan.make_gan_train_step(generator, discriminator, vgg, g_tx, d_tx,
                                      TRAIN_GEOMETRY, KernelSynthesisConfig(), DEGRADATION, cfg)
    state = esrgan.init_gan_state(generator, discriminator, g_tx, d_tx)
    return _time_steps(step, state, _train_batch(batch, device),
                       _resize_flags(iters, DEGRADATION, mix), batch, "g_loss")


def measure_tiled(iters: int, device: torch.device, devices: Optional[List[torch.device]] = None,
                  in_size: int = 2048, tile: int = 528, tile_batch: int = 8,
                  overlap: int = 8) -> Measured:
    """2K -> 8K overlap-tile serving, output MP/s: ``tiled_canvas`` over the
    devices (one generator replica each), the padded image on them before the
    timed loop, one scalar of the canvas read a call."""
    devices = [torch.device(d) for d in (devices or [device])]
    forwards = [no_grad_forward(_bf16_generator(d)) for d in devices]
    ny, nx, core = tile_grid(in_size, in_size, tile, overlap)
    rng = np.random.default_rng(0)
    padded = np.ascontiguousarray(pad_for_tiles(
        rng.random((in_size, in_size, 3)).astype(np.float32), tile, overlap))
    on_device = {d: torch.from_numpy(padded).to(d) for d in dict.fromkeys(devices)}
    out_mp = (in_size * 4) ** 2 / 1e6

    def call() -> torch.Tensor:
        return tiled_canvas(forwards, on_device, ny, nx, tile, overlap, tile_batch, 4, devices)

    # FLOPs of every tile batch the call runs, on the meta twin
    twin = no_grad_forward(_bf16_generator("meta", plain=True))
    meta = [torch.device("meta")] * len(devices)
    per_call = count_flops(tiled_canvas, [twin] * len(devices),
                           torch.empty(padded.shape, device="meta"), ny, nx, tile, overlap,
                           tile_batch, 4, meta)
    batch = round_tile_batch(tile_batch, len(devices))
    per_batch = count_flops(twin, torch.empty((batch, tile, tile, 3), device="meta"))
    n_batches = math.ceil(ny * nx / batch)

    launches = fused_rdb.launches
    out = call()  # kernel build + warmup
    if out.shape[0] != ny * core * 4:
        raise RuntimeError(f"tiled canvas has {out.shape[0]} rows, not {ny * core * 4}")
    float(out[:8, :8].mean())

    def timed_once() -> float:
        t0 = time.perf_counter()
        for _ in range(iters):
            float(call()[:8, :8].mean())  # sync, scalar read only
        return out_mp * iters / (time.perf_counter() - t0)

    rate = _median_rate(timed_once)
    return Measured(rate, per_call / out_mp, {
        "fused_rdb_launches": fused_rdb.launches - launches, "geometry": [tile, overlap, batch],
        "devices": len(devices), "tile_batches": n_batches, "flops_per_call": per_call,
        "flops_per_tile_batch": per_batch})


def _line(mode: str, metric: str, m: Measured, unit: str, device: torch.device,
          card: str, **extra) -> dict:
    out = {"metric": metric, "value": round(m.value, 3), "unit": unit, "mode": mode,
           "device": card}
    if m.flops_per_unit:
        eff = m.value * m.flops_per_unit / 1e12
        out.update(flops_per_unit=m.flops_per_unit, effective_tflops=round(eff, 3))
        if device.type == "cuda":
            out.update(mfu=round(eff / H100_BF16_PEAK_TFLOPS, 5),
                       peak_tflops=H100_BF16_PEAK_TFLOPS, peak_note=PEAK_NOTE)
    out.update(m.extra)
    out.update(extra)
    return out


METRICS = {
    "inference": ("x4_sr_output_megapixels_per_sec_per_chip", "MP/s", "inference_mp_per_s"),
    "tiled": ("x4_tiled_2k_to_8k_megapixels_per_sec", "MP/s", "tiled_mp_per_s"),
    "train": ("x4_train_images_per_sec_per_chip", "imgs/s", "train_imgs_per_s"),
    "gan": ("x4_gan_train_images_per_sec_per_chip", "imgs/s", "gan_imgs_per_s"),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", choices=("all", "inference", "train", "gan", "tiled"),
                   default="all")
    p.add_argument("--batch", type=int, default=0,
                   help="0 = mode default (16, for inference and train alike)")
    p.add_argument("--lr-size", type=int, default=256,
                   help="inference mode only; train/gan use the 400px HR geometry")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--budget", type=int, default=2700,
                   help="all-mode wall-clock budget (s): heavy stages are skipped, not "
                        "half-measured, when exceeded")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (a check of the bench, not a measurement of a GPU)")
    a = p.parse_args(argv)
    a.batch = a.batch or 16

    device = local_device(a.cpu)
    devices = [device] if a.cpu else local_devices()
    card = card_name(device)
    extra_flags = {"contended": True} if wait_for_idle_chip() else {}
    measures = {
        "inference": lambda: measure(a.batch, a.lr_size, a.iters, device),
        "tiled": lambda: measure_tiled(max(1, a.iters // 3), device, devices=devices),
        "train": lambda: measure_train(a.batch, a.iters, device, mix=a.mode == "train"),
        "gan": lambda: measure_gan(a.batch, a.iters, device, mix=a.mode == "gan"),
    }

    def line(mode: str, m: Measured, **extra) -> str:
        metric, unit, _ = METRICS[mode]
        return json.dumps(_line(mode, metric, m, unit, device, card, **extra, **extra_flags))

    if a.mode != "all":
        print(line(a.mode, measures[a.mode]()), flush=True)
        return 0

    # --mode all: everything, the flagship line LAST, carrying the others
    t_start = time.perf_counter()
    flagship = measures["inference"]()
    extras, failed = {}, []
    for mode in ("tiled", "train", "gan"):
        if time.perf_counter() - t_start > a.budget:
            print(f"# skipped {mode}: over --budget {a.budget}s (run `python -m "
                  f"real_esrgan_tpu_torch.bench --mode {mode}` for it)", flush=True)
            continue
        try:
            m = measures[mode]()
        except Exception as exc:  # a failed stage must not hide the others
            traceback.print_exc()
            print(f"# {mode} stage failed: {type(exc).__name__}: {exc}", flush=True)
            failed.append(mode)
            continue
        print(line(mode, m), flush=True)
        extras[METRICS[mode][2]] = round(m.value, 3)
    print(line("inference", flagship, **extras), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
