"""Holds data-parallel training steps against the single-process step.

    torchrun --nproc_per_node=2 -m real_esrgan_tpu_torch.tools.dp_check --cpu --out OUT
    torchrun --nproc_per_node=2 -m real_esrgan_tpu_torch.tools.dp_check --preset card --out OUT
    python -m real_esrgan_tpu_torch.tools.dp_check --cpu --out OUT     # one process

Each rank builds the same models from seeds and the same global batch from a
numpy seed, runs the trainers' steps on its slice of it (``parallel/mesh.py``
averages the gradients), and writes what it got to ``OUT/rank{r}.pt``; run
with no process group, the same cases give the single-process step on the
whole batch.  ``launch_local`` starts N ranks of a command on this host with
JAX's launch names, as the tests and ``chip_smoke.py`` do.  The cases
(``CASES``):

* ``esrnet_step``: stage-1 steps, the degradation included, from
  (seed + 1, step) draws of the global batch;
* ``gan_step``: stage-2 G+D steps the same way (the state after the first
  step kept too);
* ``esrnet_update``: stage-1 updates on fixed (LR, HR) batches from start
  weights in ``OUT/start.pt`` (written by the caller, e.g. JAX's);
* ``guard``: one update whose reject limit lies between a rank's own
  gradient norm and the global one, in both directions: the decision must be
  the global one, on every rank;
* ``all_reduce``: the time of one ``all_reduce_mean`` of the full-width
  generator's gradients (one flat buffer).

Presets: ``small`` (2 RRDBs, 16 channels, growth 8, D 16, VGG19 to conv2_2,
hr 64 -> crop 32, global batch 4, three steps) and ``card`` (2 RRDBs, 64
channels, growth 32, D 64, VGG19 to conv5_4, hr 400 -> crop 256, global
batch 48, one step).  Everything runs in float32 with TF32 off.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from real_esrgan_tpu_torch.configuration import (
    DegradationConfig, GanTrainConfig, KernelSynthesisConfig, ModelConfig, PipelineGeometry,
    TrainConfig,
)
from real_esrgan_tpu_torch.models.discriminator import UNetDiscriminator
from real_esrgan_tpu_torch.models.rrdbnet import Generator
from real_esrgan_tpu_torch.models.vgg import VGG19Features
from real_esrgan_tpu_torch.parallel.mesh import (
    all_reduce_mean, local_device, process_group, rank, shard_slice, world_size,
)
from real_esrgan_tpu_torch.train import esrgan, esrnet
from real_esrgan_tpu_torch.train.optim import global_norm


@dataclasses.dataclass(frozen=True)
class Preset:
    rrdbs: int
    channels: int
    growth: int
    d_channels: int
    vgg_nodes: Tuple[str, ...]
    content_weights: Tuple[float, ...]
    hr_size: int
    crop_size: int
    batch: int
    steps: int


PRESETS = {
    "small": Preset(2, 16, 8, 16, ("conv1_2", "conv2_2"), (0.1, 1.0), 64, 32, 4, 3),
    "card": Preset(2, 64, 32, 64, GanTrainConfig.vgg_nodes, GanTrainConfig.content_weights,
                   400, 256, 48, 1),
}
STEPS_PER_EPOCH = 10
# the clip of tests/test_torch_train_step.py: under these gradient norms, so it works
GRAD_CLIP = 0.5
UPDATE_SIZES = (16, 64)  # esrnet_update's LR and HR sides
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _geometry(p: Preset) -> PipelineGeometry:
    return PipelineGeometry(hr_size=p.hr_size, crop_size=p.crop_size, scale=4)


def _model_cfg(p: Preset) -> ModelConfig:
    return ModelConfig(num_rrdb=p.rrdbs, channels=p.channels, growth_channels=p.growth)


def _hr_batch(p: Preset, seed: int = 3) -> np.ndarray:
    return (np.random.default_rng(seed).random((p.batch, p.hr_size, p.hr_size, 3))
            * 255).astype(np.uint8)


def _up_flags(p: Preset) -> List[Tuple[bool, bool]]:
    rng = np.random.default_rng(17)
    return [(bool(rng.random() < 0.5), bool(rng.random() < 0.5)) for _ in range(p.steps)]


def _mine(batch: np.ndarray, device) -> torch.Tensor:
    """This rank's slice of a global numpy batch, on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(
        batch[shard_slice(len(batch), rank(), world_size())])).to(device)


def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in tensors.items()}


def _floats(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_steps(step, state, hr, p: Preset, device):
    """``p.steps`` steps; (state, the state after the first step, metrics a
    step, host ms a step with the device synchronized)."""
    metrics, ms, first = [], [], None
    for up1, up2 in _up_flags(p):
        _sync(device)
        t0 = time.perf_counter()
        state, m = step(state, hr, up1, up2)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(_floats(m))
        first = first or state
    return state, first, metrics, ms


def _esrnet(p: Preset, device):
    cfg = TrainConfig(use_bfloat16=False, remat_rrdb=False, grad_clip_norm=GRAD_CLIP)
    model = esrnet.build_generator(_model_cfg(p), cfg, device,
                                   generator=torch.Generator().manual_seed(5))
    opt = esrnet.build_optimizer(cfg, STEPS_PER_EPOCH)
    return model, opt, cfg


def esrnet_step(p: Preset, device, out_dir: str) -> dict:
    model, opt, cfg = _esrnet(p, device)
    step = esrnet.make_train_step(model, opt, _geometry(p), KernelSynthesisConfig(),
                                  DegradationConfig(usm_radius=13), cfg.ema_decay, seed=cfg.seed)
    state = esrnet.init_state(model, opt)
    start = _cpu(state.params)
    state, _, metrics, ms = _run_steps(step, state, _mine(_hr_batch(p), device), p, device)
    return {"metrics": metrics, "step_ms": ms, "start": start, "params": _cpu(state.params),
            "ema": _cpu(state.ema_params)}


def gan_step(p: Preset, device, out_dir: str) -> dict:
    cfg = GanTrainConfig(use_bfloat16=False, remat_rrdb=False, vgg_nodes=p.vgg_nodes,
                         content_weights=p.content_weights)
    generator = esrnet.build_generator(_model_cfg(p), cfg, device,
                                       generator=torch.Generator().manual_seed(cfg.seed))
    discriminator = UNetDiscriminator(channels=p.d_channels, device=device,
                                      generator=torch.Generator().manual_seed(cfg.seed + 1))
    vgg = VGG19Features(nodes=p.vgg_nodes, device=device,
                        generator=torch.Generator().manual_seed(3)).requires_grad_(False)
    g_tx, d_tx = esrgan.build_optimizers(cfg, STEPS_PER_EPOCH)
    step = esrgan.make_gan_train_step(generator, discriminator, vgg, g_tx, d_tx, _geometry(p),
                                      KernelSynthesisConfig(), DegradationConfig(usm_radius=13),
                                      cfg)
    state = esrgan.init_gan_state(generator, discriminator, g_tx, d_tx)
    start, d_start = _cpu(state.g_params), _cpu(state.d_params)
    state, first, metrics, ms = _run_steps(step, state, _mine(_hr_batch(p, seed=4), device), p,
                                           device)
    return {"metrics": metrics, "step_ms": ms, "start": start, "params": _cpu(state.g_params),
            "ema": _cpu(state.g_ema), "d_start": d_start, "d_params": _cpu(state.d_params),
            "d_stats": _cpu(state.d_stats),
            "first": {"params": _cpu(first.g_params), "d_params": _cpu(first.d_params),
                      "d_stats": _cpu(first.d_stats)}}


def update_batches(p: Preset, n: int, seed: int = 0) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``esrnet_update``'s fixed global batches: HR scaled by 0.5, 1.0, 1.5,
    ... so the gradients differ from step to step."""
    lr_side, hr_side = UPDATE_SIZES
    rng = np.random.default_rng(seed)
    return [(rng.random((p.batch, lr_side, lr_side, 3)).astype(np.float32),
             (rng.random((p.batch, hr_side, hr_side, 3)) * (0.5 + 0.5 * i)).astype(np.float32))
            for i in range(n)]


def esrnet_update(p: Preset, device, out_dir: str) -> dict:
    model, opt, cfg = _esrnet(p, device)
    model.load_state_dict(torch.load(os.path.join(out_dir, "start.pt"), weights_only=True))
    step = esrnet.make_train_step(model, opt, None, None, None, cfg.ema_decay,
                                  reject_limit=cfg.grad_reject_limit,
                                  rollback_after=cfg.rollback_after,
                                  reject_mult=cfg.grad_reject_mult)
    state = esrnet.init_state(model, opt)
    metrics = []
    for lr, hr in update_batches(p, p.steps):
        state, m = step.update(state, _mine(lr, device), _mine(hr, device))
        metrics.append(_floats(m))
    return {"metrics": metrics, "params": _cpu(state.params), "ema": _cpu(state.ema_params)}


def guard_batch(p: Preset) -> Tuple[np.ndarray, np.ndarray]:
    """One global batch whose second half has a black HR target: the L1
    gradient's signs there all agree, so that half's gradient norm is far
    above the first half's."""
    (lr, hr), = update_batches(p, 1, seed=7)
    hr[p.batch // 2:] = 0.0
    return lr, hr


def guard(p: Preset, device, out_dir: str) -> dict:
    """For each direction, a reject limit between the global gradient norm
    and one half's own: ``accept`` (the global norm under it, the larger
    half's over it) and ``reject`` (the global norm over it, the smaller
    half's under it).  Every rank computes the norms of both halves and of
    the whole batch alone, so all take the same limits."""
    lr, hr = guard_batch(p)
    model, opt, cfg = _esrnet(p, device)
    probe = esrnet.make_train_step(model, opt, None, None, None, cfg.ema_decay)
    params = esrnet.init_state(model, opt).params

    def norm(rows):
        _, grads = probe.loss_and_grads(params, torch.from_numpy(lr[rows]).to(device),
                                        torch.from_numpy(hr[rows]).to(device))
        return float(global_norm(list(grads.values())))

    half = p.batch // 2
    halves = [norm(slice(0, half)), norm(slice(half, p.batch))]
    whole = norm(slice(0, p.batch))
    limits = {"accept": (whole + max(halves)) / 2, "reject": (whole + min(halves)) / 2}
    out = {"halves": halves, "whole": whole, "limits": limits}
    for name, limit in limits.items():
        step = esrnet.make_train_step(model, opt, None, None, None, cfg.ema_decay,
                                      reject_limit=limit, reject_mult=0.0)
        state, m = step.update(esrnet.init_state(model, opt), _mine(lr, device),
                               _mine(hr, device))
        out[name] = {"metrics": _floats(m), "params": _cpu(state.params)}
    return out


def all_reduce(p: Preset, device, out_dir: str) -> dict:
    """ms of one ``all_reduce_mean`` of gradients of the full-width
    generator's shapes (23 RRDBs, 64 channels: 16.7 M float32 values in
    some 700 tensors), the median of five after one warm-up; at world size 1
    with a group up the collective still runs (``force``)."""
    grads = {k: torch.ones_like(v) for k, v in Generator(device=device).named_parameters()}
    times = []
    for _ in range(6):
        _sync(device)
        t0 = time.perf_counter()
        reduced = all_reduce_mean(grads, force=True)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return {"ms": float(np.median(times[1:])), "elements": sum(v.numel() for v in grads.values()),
            "tensors": len(grads),
            "mean_is_one": all(bool((v == 1).all()) for v in reduced.values())}


CASES = {"esrnet_step": esrnet_step, "gan_step": gan_step, "esrnet_update": esrnet_update,
         "guard": guard, "all_reduce": all_reduce}


def run_cases(names: Sequence[str], preset: str, device, out_dir: str) -> dict:
    """The cases on this rank, with TF32 off (float32 as float32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = PRESETS[preset]
    return {name: CASES[name](p, device, out_dir) for name in names}


def free_port() -> int:
    """A TCP port free on localhost now (another process may take it before
    it is used: ``launch_local`` tries a new one once)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_local(argv: Sequence[str], world: int, timeout: float,
                 cwds: Optional[Sequence[str]] = None, env: Optional[dict] = None,
                 joined: str = "rank {rank} of {world}") -> List[Tuple[int, str]]:
    """Runs ``python argv`` as ``world`` ranks of one process group on this
    host, with JAX's launch names (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``,
    ``PROCESS_ID``), rank r in ``cwds[r]``; returns each rank's (exit code,
    output).  Past ``timeout`` seconds every rank is killed (exit code None).
    A rank that did not print ``joined`` had not joined the group: a failed
    attempt where one had not is taken again once, with a new port, since a
    rendezvous on a loaded machine can time out; any other failure stands."""
    for attempt in range(2):
        base = dict(os.environ, **(env or {}))
        # the ranks import this package from wherever they run
        base["PYTHONPATH"] = os.pathsep.join(p for p in (PACKAGE_ROOT, base.get("PYTHONPATH"))
                                             if p)
        base.update(COORDINATOR_ADDRESS=f"localhost:{free_port()}", NUM_PROCESSES=str(world))
        procs = [subprocess.Popen([sys.executable, *argv], cwd=cwds[r] if cwds else None,
                                  env=dict(base, PROCESS_ID=str(r)), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(world)]
        deadline = time.monotonic() + timeout
        results = []
        try:
            for proc in procs:
                try:
                    out, _ = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
                    results.append((proc.returncode, out))
                except subprocess.TimeoutExpired:
                    proc.kill()
                    out, _ = proc.communicate()
                    results.append((None, out + f"\n(killed after {timeout} s)"))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        failed = any(rc != 0 for rc, _ in results)
        unjoined = any(joined.format(rank=r, world=world) not in out
                       for r, (_, out) in enumerate(results))
        if not (failed and unjoined and attempt == 0):
            return results
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--preset", choices=tuple(PRESETS), default="small")
    parser.add_argument("--cases", default="esrnet_step,gan_step,guard",
                        help="comma-separated names of CASES (esrnet_update needs OUT/start.pt)")
    parser.add_argument("--out", required=True, help="directory of rank{r}.pt (and start.pt)")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (gloo)")
    parser.add_argument("--backend", default=None,
                        help="the process group's backend (default: nccl on CUDA, else gloo)")
    args = parser.parse_args(argv)
    backend = args.backend or ("gloo" if args.cpu else None)
    with process_group(backend):
        device, me = local_device(args.cpu), rank()
        print(f"Joined as rank {me} of {world_size()} on {device}.", flush=True)
        os.makedirs(args.out, exist_ok=True)
        results = run_cases([c for c in args.cases.split(",") if c], args.preset, device,
                            args.out)
        torch.save(results, os.path.join(args.out, f"rank{me}.pt"))
    print(f"DP_CHECK_OK rank={me}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
