"""Stage-1 (RealESRNet) training step: the port of real_esrgan_tpu/train/esrnet.py.

A step is two parts:

* ``degrade_batch``: the second-order degradation of the batch's HR crops
  on the training device, under ``torch.no_grad``, from a generator seeded
  by ``(seed + 1, state.step)`` as the JAX trainer folds ``state.step`` into
  its key: a resumed run draws what an unbroken run on the same kind of
  device draws.  The draws are made on the device: a batch of 48 on the 608
  canvas takes some 71 M normals a stage, which the CPU would take longer to
  draw and copy than the step takes.
* ``update(state, lr, hr)``: the L1 loss of the training model's output
  (raw, straight-through or hard clamped: ``train_forward_model``), its
  gradients, and the guarded Adam step with the EMA (``train/guard.py``).

``TrainState.step`` counts batches and is a host integer, since it advances
on every batch whatever the data; the optimizer's count advances only on
accepted steps and lives on the device, as does everything the guard reads.

The training model runs the RDBs as ``rdb_plain`` (stock convolutions that
autograd differentiates): the RDB kernel has no backward, and the JAX
trainer's own forward runs XLA's convolutions, never the Pallas RDB.  The
evaluation model, built apart by ``build_generator(..., training=False)``,
runs the kernel under ``torch.no_grad``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Tuple

import torch
from torch.func import functional_call

from real_esrgan_tpu_torch.configuration import (
    DegradationConfig, KernelSynthesisConfig, ModelConfig, PipelineGeometry, TrainConfig,
)
from real_esrgan_tpu_torch.models.ema import ema_init, ema_update
from real_esrgan_tpu_torch.models.rrdbnet import Generator
from real_esrgan_tpu_torch.ops.degradation import degrade, generator_seed
from real_esrgan_tpu_torch.train.guard import GuardState, guard_init, guarded_update
from real_esrgan_tpu_torch.train.optim import (
    AdamState, ClippedAdam, apply_updates, global_norm,
)
from real_esrgan_tpu_torch.train.schedule import step_lr

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: int
    params: Tensors
    ema_params: Tensors
    opt_state: AdamState
    guard: GuardState


def build_generator(model_cfg: ModelConfig, train_cfg: TrainConfig, device=None,
                    training: bool = True, generator: torch.Generator = None) -> Generator:
    """The generator at ``model_cfg``'s widths in ``train_cfg``'s compute type.

    ``training=True``: the model the loss runs on, its RDBs on ``rdb_plain``
    and each RRDB rematerialized when ``train_cfg.remat_rrdb``.
    ``training=False``: the evaluation model, its RDBs on the kernel."""
    return Generator(in_channels=model_cfg.in_channels, out_channels=model_cfg.out_channels,
                     upscale_factor=model_cfg.upscale_factor, num_rrdb=model_cfg.num_rrdb,
                     channels=model_cfg.channels, growth=model_cfg.growth_channels,
                     dtype=torch.bfloat16 if train_cfg.use_bfloat16 else torch.float32,
                     device=device, generator=generator, plain_rdb=training,
                     remat=training and train_cfg.remat_rrdb)


def build_optimizer(train_cfg: TrainConfig, steps_per_epoch: int) -> ClippedAdam:
    """Adam(lr, betas) with StepLR (and its warmup) behind the global-norm clip
    (``grad_clip_norm``; 0: no clip)."""
    schedule = step_lr(train_cfg.lr, train_cfg.effective_lr_step_size, train_cfg.lr_gamma,
                       steps_per_epoch, warmup_steps=getattr(train_cfg, "lr_warmup_steps", 0))
    return ClippedAdam(schedule, b1=train_cfg.betas[0], b2=train_cfg.betas[1],
                       clip_norm=train_cfg.grad_clip_norm)


def train_forward_model(model: Generator, clamp_mode: str) -> Generator:
    """The generator variant the training loss runs on: ``none`` the raw
    output, ``st`` the straight-through clamp, ``hard`` the reference's clamp.
    Shares ``model``'s modules; evaluation keeps ``model`` itself."""
    if clamp_mode not in ("none", "st", "hard"):
        raise ValueError(f"train_clamp must be none|st|hard, got {clamp_mode!r}")
    clone = copy.copy(model)
    clone.clamp, clone.st_clamp = clamp_mode != "none", clamp_mode == "st"
    return clone


def notfinite_count(guard: GuardState) -> int:
    """Total gradient steps rejected (reads the device)."""
    return int(guard.rejected_total)


def rollback_count(guard: GuardState) -> int:
    """Total EMA rollbacks (reads the device)."""
    return int(guard.rollback_total)


def init_state(model: Generator, opt: ClippedAdam) -> TrainState:
    """Step 0 from the model's current parameters, on their device."""
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    device = next(iter(params.values())).device
    return TrainState(step=0, params=params, ema_params=ema_init(params),
                      opt_state=opt.init(params), guard=guard_init(device))


def degrade_for_step(step: int, hr_uint8: torch.Tensor, geo: PipelineGeometry,
                     kcfg: KernelSynthesisConfig, dcfg: DegradationConfig, seed: int,
                     up1: bool = False, up2: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training batch of step ``step``: ``degrade`` under ``no_grad``,
    its draws made on ``hr_uint8``'s device from ``(seed + 1, step)``."""
    s = generator_seed(seed + 1, step)
    generator = torch.Generator(device=hr_uint8.device).manual_seed(s)
    host = torch.Generator().manual_seed(s)
    with torch.no_grad():
        return degrade(generator, hr_uint8, geo, kcfg, dcfg, augment=True, up1=up1, up2=up2,
                       host_generator=host)


def make_train_step(model: Generator, opt: ClippedAdam, geo: PipelineGeometry,
                    kcfg: KernelSynthesisConfig, dcfg: DegradationConfig, ema_decay: float, *,
                    seed: int = 0, reject_limit: float = 500.0, rollback_after: int = 4,
                    guard_updates: bool = True, reject_mult: float = 8.0,
                    clamp_mode: str = "none") -> Callable:
    """Returns ``step(state, hr_uint8, up1=False, up2=False) -> (state,
    metrics)``, with its two parts as ``step.degrade_batch(state, hr_uint8,
    up1, up2) -> (lr, hr)`` and ``step.update(state, lr, hr) -> (state,
    metrics)``; ``update`` is ``step.loss_and_grads(params, lr, hr) -> (loss,
    grads)`` then ``step.apply(state, grads) -> (state, info)``, the guarded
    optimizer step and the EMA.  ``model`` is the training model (``build_generator``);
    ``seed`` is the run's seed, the draws use ``seed + 1``.  metrics hold 0-d
    device tensors: ``loss``, the pre-clip ``grad_norm`` and, with the guard,
    ``lr_scale``, ``rejected`` and ``rollback``."""
    train_model = train_forward_model(model, clamp_mode)

    def degrade_batch(state: TrainState, hr_uint8: torch.Tensor, up1: bool = False,
                      up2: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        return degrade_for_step(state.step, hr_uint8, geo, kcfg, dcfg, seed, up1, up2)

    def loss_and_grads(params: Tensors, lr_batch: torch.Tensor, hr_batch: torch.Tensor
                       ) -> Tuple[torch.Tensor, Tensors]:
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        sr = functional_call(train_model, leaves, (lr_batch,))
        loss = torch.mean(torch.abs(sr - hr_batch))
        return loss.detach(), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    def apply(state: TrainState, grads: Tensors) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if guard_updates:
            params, ema_params, opt_state, guard, info = guarded_update(
                opt, grads, state.opt_state, state.params, state.ema_params, state.guard,
                reject_limit=reject_limit, rollback_after=rollback_after,
                ema_decay=ema_decay, reject_mult=reject_mult)
        else:
            updates, opt_state = opt.update(grads, state.opt_state)
            params = apply_updates(state.params, updates)
            ema_params = ema_update(state.ema_params, params, ema_decay)
            guard = state.guard
            info = {"grad_norm": global_norm(list(grads.values()))}
        return TrainState(step=state.step + 1, params=params, ema_params=ema_params,
                          opt_state=opt_state, guard=guard), info

    def update(state: TrainState, lr_batch: torch.Tensor, hr_batch: torch.Tensor
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        loss, grads = loss_and_grads(state.params, lr_batch, hr_batch)
        new_state, info = apply(state, grads)
        return new_state, {"loss": loss, **info}

    def step(state: TrainState, hr_uint8: torch.Tensor, up1: bool = False, up2: bool = False):
        """up1/up2: the host-drawn per-batch resize-upscale flags."""
        lr_batch, hr_batch = degrade_batch(state, hr_uint8, up1, up2)
        return update(state, lr_batch, hr_batch)

    step.degrade_batch, step.update = degrade_batch, update
    step.loss_and_grads, step.apply = loss_and_grads, apply
    return step


def make_eval_fn(model: Generator) -> Callable:
    """``eval_fn(params, lr_batch)``: the evaluation model's forward under
    ``torch.no_grad`` with ``params`` (a name -> tensor dict) loaded into it;
    a dict already loaded is not copied again."""
    loaded = {"params": None}

    def eval_fn(params: Tensors, lr_batch: torch.Tensor) -> torch.Tensor:
        if loaded["params"] is not params:
            model.load_state_dict(params)
            loaded["params"] = params
        with torch.no_grad():
            return model(lr_batch)

    return eval_fn
