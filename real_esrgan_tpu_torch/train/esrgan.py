"""Stage-2 (Real-ESRGAN) adversarial training step: the port of
real_esrgan_tpu/train/esrgan.py.

Per step, as the JAX trainer's fused step:

* the degradation of the HR crops on the device, from ``(seed + 1, step)``
  (``esrnet.degrade_for_step``);
* G-step: the training generator's unclamped output ``sr``
  (``train_forward_model(..., cfg.train_clamp)``), ``usm_sharpen(sr)``, then
  ``pixel_weight * L1(usm(sr), hr)`` + the weighted content L1 over the
  backbone's taps + ``adversarial_weight * BCE(D(sr), 1)``; G's guarded Adam
  step with its EMA;
* D-step on ``sr.detach()``: ``BCE(D(hr), 1) + BCE(D(sr), 0)``, D's guarded
  Adam step with no rollback (``rollback_after=0``, D's own params in the
  EMA's place).

Data parallel, as the stage-1 step (``train/esrnet.py``): each rank
degrades its slice of the global batch's draws; ``update`` averages G's
gradients with G's loss terms, then D's gradients with D's loss and
probabilities, over the ranks before each guard.  D's spectral state needs
no collective: each power iteration is a function of D's weights and the
previous ``u`` alone, both equal on every rank, so it stays equal.

The spectral state advances on every D forward: D(sr) in the G-step, then
D(hr) and D(sr.detach()) in the D-step, three power iterations a step, as
the reference's ``spectral_norm`` does on every train-mode forward.  The
content backbone is ``VGG19Features`` (ImageNet-normalized input) or
``TrunkFeatures`` (raw input), frozen.  No part of the step runs the RDB
kernel: the generator is the training model (``rdb_plain``).

``make_gan_train_step`` returns ``step(state, hr_uint8, up1, up2)``, with
its parts as attributes so a test can feed a fixed batch and the card can
time each: ``degrade_batch``, ``g_loss_and_grads``, ``g_apply``,
``d_loss_and_grads``, ``d_apply`` and ``update(state, lr, hr)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.func import functional_call

from real_esrgan_tpu_torch.configuration import (
    DegradationConfig, GanTrainConfig, KernelSynthesisConfig, ModelConfig, PipelineGeometry,
)
from real_esrgan_tpu_torch.models.discriminator import UNetDiscriminator
from real_esrgan_tpu_torch.models.ema import ema_init, ema_update
from real_esrgan_tpu_torch.models.rrdbnet import Generator
from real_esrgan_tpu_torch.models.vgg import ContentLoss, VGG19Features
from real_esrgan_tpu_torch.ops.usm import gaussian_kernel_1d, usm_sharpen
from real_esrgan_tpu_torch.train.esrnet import (
    build_generator, degrade_for_step, mean_over_ranks, train_forward_model,
)
from real_esrgan_tpu_torch.parallel.mesh import rank, world_size
from real_esrgan_tpu_torch.train.guard import GuardState, guard_init, guarded_update
from real_esrgan_tpu_torch.train.optim import (
    AdamState, ClippedAdam, apply_updates, global_norm,
)
from real_esrgan_tpu_torch.train.schedule import multistep_lr

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class GanTrainState:
    step: int
    g_params: Tensors
    g_ema: Tensors
    g_opt: AdamState
    d_params: Tensors
    d_stats: Tensors
    d_opt: AdamState
    g_guard: GuardState
    d_guard: GuardState


def build_models(model_cfg: ModelConfig, cfg: GanTrainConfig, device=None
                 ) -> Tuple[Generator, UNetDiscriminator, VGG19Features]:
    """The training generator (``build_generator``), the discriminator and
    the VGG19 content backbone in ``cfg``'s compute type.  G's weights are
    drawn from ``cfg.seed``, D's from ``cfg.seed + 1``, VGG's (random
    features) from 3; VGG is frozen."""
    dtype = torch.bfloat16 if cfg.use_bfloat16 else torch.float32
    generator = build_generator(model_cfg, cfg, device, training=True,
                                generator=torch.Generator().manual_seed(cfg.seed))
    discriminator = UNetDiscriminator(dtype=dtype, device=device,
                                      generator=torch.Generator().manual_seed(cfg.seed + 1))
    vgg = VGG19Features(nodes=tuple(cfg.vgg_nodes), dtype=dtype, device=device,
                        generator=torch.Generator().manual_seed(3))
    return generator, discriminator, vgg.requires_grad_(False)


def build_optimizers(cfg: GanTrainConfig, steps_per_epoch: int
                     ) -> Tuple[ClippedAdam, ClippedAdam]:
    """Adam for G and for D, MultiStepLR at ``effective_lr_milestones``
    behind the global-norm clip."""
    def adam():
        schedule = multistep_lr(cfg.lr, cfg.effective_lr_milestones, cfg.lr_gamma,
                                steps_per_epoch, warmup_steps=cfg.lr_warmup_steps)
        return ClippedAdam(schedule, b1=cfg.betas[0], b2=cfg.betas[1],
                           clip_norm=cfg.grad_clip_norm)
    return adam(), adam()


def init_gan_state(generator: Generator, discriminator: UNetDiscriminator,
                   g_tx: ClippedAdam, d_tx: ClippedAdam) -> GanTrainState:
    """Step 0 from the modules' current parameters and D's spectral state."""
    g_params = {k: v.detach().clone() for k, v in generator.named_parameters()}
    d_params = {k: v.detach().clone() for k, v in discriminator.named_parameters()}
    device = next(iter(g_params.values())).device
    return GanTrainState(
        step=0, g_params=g_params, g_ema=ema_init(g_params), g_opt=g_tx.init(g_params),
        d_params=d_params, d_stats={k: v.clone() for k, v in discriminator.stats.items()},
        d_opt=d_tx.init(d_params), g_guard=guard_init(device), d_guard=guard_init(device))


def bce_real(logits: torch.Tensor) -> torch.Tensor:
    """optax's sigmoid BCE against label 1, elementwise."""
    return -F.logsigmoid(logits)


def bce_fake(logits: torch.Tensor) -> torch.Tensor:
    """optax's sigmoid BCE against label 0, elementwise."""
    return -F.logsigmoid(-logits)


def _leaves(params: Tensors) -> Tensors:
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


def make_gan_train_step(generator: Generator, discriminator: UNetDiscriminator,
                        backbone: torch.nn.Module, g_tx: ClippedAdam, d_tx: ClippedAdam,
                        geo: PipelineGeometry, kcfg: KernelSynthesisConfig,
                        dcfg: DegradationConfig, cfg: GanTrainConfig) -> Callable:
    """Returns ``step(state, hr_uint8, up1=False, up2=False) -> (state,
    metrics)`` (see the module docstring for its parts).  ``backbone`` is
    the frozen content-loss feature extractor, its weights loaded; its
    taps are weighted by ``cfg.content_weights``.  metrics hold 0-d device
    tensors under the JAX trainer's names: ``pixel``, ``content``,
    ``adversarial``, ``g_loss``, ``d_loss``, ``d_hr_prob``, ``d_sr_prob``,
    and the guard's ``g_*`` / ``d_*`` (``grad_norm``, pre-clip)."""
    usm_kernel = gaussian_kernel_1d(dcfg.usm_radius, 0.0)
    train_generator = train_forward_model(generator, cfg.train_clamp)
    content_loss = ContentLoss(backbone, cfg.content_weights)
    rank_, world = rank(), world_size()

    def d_forward(d_params, d_stats, x):
        return functional_call(discriminator, d_params, (x, d_stats), {"update_stats": True})

    def degrade_batch(state: GanTrainState, hr_uint8: torch.Tensor, up1: bool = False,
                      up2: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        return degrade_for_step(state.step, hr_uint8, geo, kcfg, dcfg, cfg.seed, up1, up2,
                                rank_, world)

    def g_loss_and_grads(state: GanTrainState, lr_b: torch.Tensor, hr_b: torch.Tensor
                         ) -> Tuple[Tensors, Tensors]:
        """(G's gradients, aux): aux holds the loss terms, ``sr`` (detached)
        and ``d_stats`` after D(sr)."""
        leaves = _leaves(state.g_params)
        sr = functional_call(train_generator, leaves, (lr_b,))
        sr_sharp = usm_sharpen(sr, usm_kernel, dcfg.usm_weight, dcfg.usm_threshold)
        pixel = cfg.pixel_weight * torch.mean(torch.abs(sr_sharp - hr_b))
        content, _ = content_loss(sr_sharp, hr_b)
        logits, d_stats = d_forward(state.d_params, state.d_stats, sr)
        adversarial = cfg.adversarial_weight * torch.mean(bce_real(logits))
        total = pixel + content + adversarial
        grads = dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()))))
        return grads, {"sr": sr.detach(), "d_stats": d_stats, "pixel": pixel.detach(),
                       "content": content.detach(), "adversarial": adversarial.detach(),
                       "g_loss": total.detach()}

    def d_loss_and_grads(d_params: Tensors, d_stats: Tensors, sr: torch.Tensor,
                         hr_b: torch.Tensor) -> Tuple[Tensors, Tensors]:
        """(D's gradients, aux): aux holds ``d_stats`` after D(hr) and D(sr),
        ``d_loss`` and the mean probabilities."""
        leaves = _leaves(d_params)
        hr_logits, stats = d_forward(leaves, d_stats, hr_b)
        sr_logits, stats = d_forward(leaves, stats, sr)
        loss = torch.mean(bce_real(hr_logits)) + torch.mean(bce_fake(sr_logits))
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        return grads, {"d_stats": stats, "d_loss": loss.detach(),
                       "d_hr_prob": torch.mean(torch.sigmoid(hr_logits.detach())),
                       "d_sr_prob": torch.mean(torch.sigmoid(sr_logits.detach()))}

    def _apply(tx, grads, opt_state, params, ema, guard, rollback_after):
        if cfg.skip_nonfinite_updates:
            return guarded_update(tx, grads, opt_state, params, ema, guard,
                                  reject_limit=cfg.grad_reject_limit,
                                  rollback_after=rollback_after, ema_decay=cfg.ema_decay,
                                  reject_mult=cfg.grad_reject_mult)
        updates, opt_state = tx.update(grads, opt_state)
        params = apply_updates(params, updates)
        ema = ema_update(ema, params, cfg.ema_decay)
        return params, ema, opt_state, guard, {"grad_norm": global_norm(list(grads.values()))}

    def g_apply(state: GanTrainState, grads: Tensors):
        """(params, ema, opt_state, guard, info) of G's guarded step."""
        return _apply(g_tx, grads, state.g_opt, state.g_params, state.g_ema, state.g_guard,
                      cfg.rollback_after)

    def d_apply(state: GanTrainState, grads: Tensors):
        """(params, opt_state, guard, info) of D's step: reject-only, D's
        own params in the EMA's place."""
        params, _, opt_state, guard, info = _apply(d_tx, grads, state.d_opt, state.d_params,
                                                   state.d_params, state.d_guard, 0)
        return params, opt_state, guard, info

    def update(state: GanTrainState, lr_b: torch.Tensor, hr_b: torch.Tensor
               ) -> Tuple[GanTrainState, Dict[str, torch.Tensor]]:
        g_grads, g_aux = g_loss_and_grads(state, lr_b, hr_b)
        sr, d_stats = g_aux.pop("sr"), g_aux.pop("d_stats")
        g_grads, g_aux = mean_over_ranks(g_grads, g_aux)
        g_params, g_ema, g_opt, g_guard, g_info = g_apply(state, g_grads)
        d_grads, d_aux = d_loss_and_grads(state.d_params, d_stats, sr, hr_b)
        d_stats = d_aux.pop("d_stats")
        d_grads, d_aux = mean_over_ranks(d_grads, d_aux)
        d_params, d_opt, d_guard, d_info = d_apply(state, d_grads)
        new_state = GanTrainState(step=state.step + 1, g_params=g_params, g_ema=g_ema,
                                  g_opt=g_opt, d_params=d_params, d_stats=d_stats,
                                  d_opt=d_opt, g_guard=g_guard, d_guard=d_guard)
        metrics = {**g_aux, **d_aux}
        metrics.update({f"g_{k}": v for k, v in g_info.items()})
        metrics.update({f"d_{k}": v for k, v in d_info.items()})
        return new_state, metrics

    def step(state: GanTrainState, hr_uint8: torch.Tensor, up1: bool = False,
             up2: bool = False):
        """up1/up2: the host-drawn per-batch resize-upscale flags."""
        lr_b, hr_b = degrade_batch(state, hr_uint8, up1, up2)
        return update(state, lr_b, hr_b)

    step.degrade_batch, step.update = degrade_batch, update
    step.g_loss_and_grads, step.g_apply = g_loss_and_grads, g_apply
    step.d_loss_and_grads, step.d_apply = d_loss_and_grads, d_apply
    return step
