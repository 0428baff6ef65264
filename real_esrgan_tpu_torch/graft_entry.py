"""Entry points for a harness: a single-device forward and a multi-process dry run.
The port of the root ``__graft_entry__.py``.

    python -m real_esrgan_tpu_torch.graft_entry          # entry() on the GPU, then the dry run
    python -m real_esrgan_tpu_torch.graft_entry --cpu

``entry()`` returns the flagship x4 forward and its example arguments;
``dryrun_multichip(n)`` runs one data-parallel stage-1 step and one G+D step
as ``n`` gloo ranks on the CPU, as the JAX dry run forces a virtual CPU mesh,
and traces the full-size stage-1 loss and gradients on the ``meta`` device.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.flop_counter import FlopCounterMode

from real_esrgan_tpu_torch.models.rrdbnet import Generator
from real_esrgan_tpu_torch.parallel.mesh import (
    local_device, process_group, rank, shard_slice, world_size,
)

DRYRUN_TIMEOUT = 600.0


def entry(device=None) -> Tuple[Callable, Tuple[Dict[str, torch.Tensor], torch.Tensor]]:
    """(fn, (params, x)): the bf16 23-RRDB x4 ``Generator`` in evaluation
    mode, its parameters drawn from seed 0 as a name -> tensor dict, and ``x``
    of shape (1, 64, 64, 3) from ``np.random.default_rng(0)``; ``fn(params,
    x)`` is the forward with ``params`` (``torch.func.functional_call``)
    under ``torch.no_grad``, so on a GPU its RDBs run the fused RDB kernel.
    On the GPU unless ``device`` says otherwise (``device="cpu"``)."""
    device = torch.device(device) if device is not None else local_device()
    model = Generator(upscale_factor=4, num_rrdb=23, dtype=torch.bfloat16, device=device,
                      generator=torch.Generator().manual_seed(0)).eval()
    params = {k: v.detach() for k, v in model.named_parameters()}
    x = torch.from_numpy(np.random.default_rng(0).random((1, 64, 64, 3)).astype(np.float32))

    @torch.no_grad()
    def fn(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        return functional_call(model, params, (x,))

    return fn, (params, x.to(device))


def _dryrun_rank() -> None:
    """One rank of ``dryrun_multichip``: the JAX dry run's toy steps on this
    rank's share of the global batch, then the full-size trace on ``meta``;
    the lead prints the three result lines."""
    from real_esrgan_tpu_torch.configuration import (
        DegradationConfig, GanTrainConfig, KernelSynthesisConfig, ModelConfig,
        PipelineGeometry, TrainConfig,
    )
    from real_esrgan_tpu_torch.train import esrgan, esrnet

    with process_group("gloo"):
        n, me, device = world_size(), rank(), local_device(cpu=True)
        torch.set_num_threads(max(1, min(4, (os.cpu_count() or 1) // n)))
        print(f"Joined as rank {me} of {n} on {device}.", flush=True)
        lead = me == 0

        def mine(batch: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(batch[shard_slice(len(batch), me, n)]))

        kcfg, dcfg = KernelSynthesisConfig(), DegradationConfig(usm_radius=13)
        model_cfg = ModelConfig(num_rrdb=2, channels=32, growth_channels=16)

        geo = PipelineGeometry(hr_size=64, crop_size=32, scale=4)
        cfg = TrainConfig(batch_size=2 * n)
        model = esrnet.build_generator(model_cfg, cfg, device,
                                       generator=torch.Generator().manual_seed(0))
        opt = esrnet.build_optimizer(cfg, steps_per_epoch=10)
        step = esrnet.make_train_step(model, opt, geo, kcfg, dcfg, cfg.ema_decay)
        hr = (np.random.default_rng(0).random((cfg.batch_size, geo.hr_size, geo.hr_size, 3))
              * 255).astype(np.uint8)
        state, metrics = step(esrnet.init_state(model, opt), mine(hr))
        loss = float(metrics["loss"])
        if not math.isfinite(loss) or state.step != 1:
            raise RuntimeError(f"stage-1 step: loss {loss}, step {state.step}")
        if lead:
            print(f"dryrun_multichip({n}): one fused train step OK, loss={loss:.4f}", flush=True)

        gan_geo = PipelineGeometry(hr_size=64, crop_size=64, scale=4)
        gan_cfg = GanTrainConfig(batch_size=2 * n, use_bfloat16=False, remat_rrdb=False)
        generator, discriminator, vgg = esrgan.build_models(model_cfg, gan_cfg, device)
        g_tx, d_tx = esrgan.build_optimizers(gan_cfg, steps_per_epoch=10)
        gan_step = esrgan.make_gan_train_step(generator, discriminator, vgg, g_tx, d_tx, gan_geo,
                                              kcfg, dcfg, gan_cfg)
        hr_gan = (np.random.default_rng(1).random(
            (gan_cfg.batch_size, gan_geo.hr_size, gan_geo.hr_size, 3)) * 255).astype(np.uint8)
        gstate, gm = gan_step(esrgan.init_gan_state(generator, discriminator, g_tx, d_tx),
                              mine(hr_gan))
        g_loss, d_loss = float(gm["g_loss"]), float(gm["d_loss"])
        if not (math.isfinite(g_loss) and math.isfinite(d_loss)) or gstate.step != 1:
            raise RuntimeError(f"G+D step: g_loss {g_loss}, d_loss {d_loss}, step {gstate.step}")
        if lead:
            print(f"dryrun_multichip({n}): one fused GAN step OK, "
                  f"g_loss={g_loss:.4f} d_loss={d_loss:.4f}", flush=True)

        share, flops, n_grads = full_size_trace(n)
        if lead:
            print(f"dryrun_multichip({n}): full-size (23-RRDB, bs{share * n}, 256px) train "
                  f"step's loss and gradients traced OK on the meta device over {n} ranks "
                  f"({share} crops a rank, {n_grads} gradients, {flops:.4g} FLOPs a rank)",
                  flush=True)


def full_size_trace(n_ranks: int) -> Tuple[int, int, int]:
    """The counterpart of the JAX dry run's abstract full-size lowering: one
    rank's stage-1 ``loss_and_grads`` at the production shapes (23 RRDBs, 64
    channels, a global batch of ``(48 // n_ranks) * n_ranks`` crops of 256,
    remat on) on the ``meta`` device, where nothing is computed or
    allocated.  It takes the rank's LR and HR batches already in shape: the
    degradation's random draws cannot run on ``meta``.  Returns (crops a
    rank, FLOPs a rank, gradients), and raises unless every parameter has a
    gradient of its shape."""
    from real_esrgan_tpu_torch.configuration import (
        DegradationConfig, KernelSynthesisConfig, ModelConfig, PipelineGeometry, TrainConfig,
    )
    from real_esrgan_tpu_torch.train import esrnet

    share = max(48 // n_ranks, 1)
    geo = PipelineGeometry(hr_size=400, crop_size=256, scale=4)
    cfg = TrainConfig(batch_size=share * n_ranks)
    model = esrnet.build_generator(ModelConfig(), cfg, "meta")
    step = esrnet.make_train_step(model, esrnet.build_optimizer(cfg, steps_per_epoch=100), geo,
                                  KernelSynthesisConfig(), DegradationConfig(), cfg.ema_decay)
    params = {k: v.detach() for k, v in model.named_parameters()}
    lr = torch.empty((share, geo.crop_size // 4, geo.crop_size // 4, 3), device="meta")
    hr = torch.empty((share, geo.crop_size, geo.crop_size, 3), device="meta")
    with FlopCounterMode(display=False) as counter:
        _, grads = step.loss_and_grads(params, lr, hr)
    bad = [k for k, v in params.items() if k not in grads or grads[k].shape != v.shape]
    if bad:
        raise RuntimeError(f"full-size trace: no gradient of the right shape for {bad[:5]}")
    return share, counter.get_total_flops(), len(grads)


def dryrun_multichip(n_devices: int) -> None:
    """Run one data-parallel stage-1 step (on-device degradation + bf16 RRDB
    fwd/bwd + guarded Adam + EMA) and one G+D step at toy shapes (2 RRDBs,
    32 channels, growth 16; hr 64 -> crop 32, and 64 for stage 2; a global
    batch of 2 * n_devices), as ``n_devices`` gloo ranks on the CPU of this
    host, then trace the full-size stage-1 loss and gradients on ``meta``
    (``full_size_trace``); prints the JAX dry run's three lines.  The ranks
    see no GPU.  Raises if a rank fails, or after ``DRYRUN_TIMEOUT`` s."""
    from real_esrgan_tpu_torch.tools.dp_check import launch_local

    results = launch_local(["-m", "real_esrgan_tpu_torch.graft_entry", "--dryrun-rank"],
                           n_devices, DRYRUN_TIMEOUT, env={"CUDA_VISIBLE_DEVICES": ""})
    for r, (rc, out) in enumerate(results):
        if rc != 0:
            raise RuntimeError(f"dryrun_multichip({n_devices}): rank {r} exited {rc}:\n"
                               f"{out[-4000:]}")
    for line in results[0][1].splitlines():
        if line.startswith(f"dryrun_multichip({n_devices})"):
            print(line, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action="store_true", help="run entry() on the CPU")
    p.add_argument("--dryrun-rank", action="store_true", help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    if a.dryrun_rank:
        _dryrun_rank()
        return 0
    fn, args = entry("cpu" if a.cpu else None)
    out = fn(*args)
    print("entry() forward:", tuple(out.shape), out.dtype, out.device, flush=True)
    dryrun_multichip(1 if a.cpu else torch.cuda.device_count())
    return 0


if __name__ == "__main__":
    sys.exit(main())
