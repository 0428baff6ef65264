"""Step-level gradient rejection with EMA rollback: the port of
real_esrgan_tpu/train/guard.py (its docstring gives the failures that
motivate it).

Policy per step:

1. reject the update if the global gradient norm is non-finite, at or above
   ``reject_limit``, or at or above ``reject_mult`` times a running average
   of accepted norms (once one exists): optimizer state, parameters and EMA
   stay put;
2. after ``rollback_after`` consecutive rejections: parameters <- EMA, the
   float moments <- 0, the integer update count kept;
3. every rollback halves ``lr_scale`` (floor 1/64), which multiplies the
   accepted updates, and ``recover_after`` consecutive accepted steps double
   it back (cap 1).

``GuardState`` is six 0-d tensors on the training device and every choice is
a ``torch.where``, so a step never reads the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from real_esrgan_tpu_torch.models.ema import ema_update
from real_esrgan_tpu_torch.train.optim import AdamState, ClippedAdam, apply_updates, global_norm

GUARD_FIELDS = ("reject_streak", "rejected_total", "rollback_total", "accept_streak",
                "lr_scale", "gnorm_ref")


@dataclasses.dataclass
class GuardState:
    """Streak counters, telemetry and the adaptive update scale."""

    reject_streak: torch.Tensor     # int32, consecutive rejections
    rejected_total: torch.Tensor    # int32
    rollback_total: torch.Tensor    # int32
    accept_streak: torch.Tensor     # int32, consecutive accepted steps
    lr_scale: torch.Tensor          # float32 in [floor, 1], multiplies updates
    # running average of ACCEPTED grad norms (0: no history yet); the
    # adaptive ceiling is reject_mult times this
    gnorm_ref: torch.Tensor         # float32


def guard_init(device=None) -> GuardState:
    def zero(dtype):
        return torch.zeros((), dtype=dtype, device=device)
    return GuardState(reject_streak=zero(torch.int32), rejected_total=zero(torch.int32),
                      rollback_total=zero(torch.int32), accept_streak=zero(torch.int32),
                      lr_scale=torch.ones((), dtype=torch.float32, device=device),
                      gnorm_ref=zero(torch.float32))


def guard_to_dict(guard: GuardState) -> Dict[str, torch.Tensor]:
    """Name-keyed snapshot for checkpoints (``lr_scale`` is control state:
    a resumed run keeps its backoff)."""
    return {f: getattr(guard, f) for f in GUARD_FIELDS}


def guard_from_dict(d: Any, device=None) -> GuardState:
    """GuardState from a checkpoint dict; missing fields (older checkpoints)
    keep their fresh values, and anything but a dict gives a fresh state."""
    init = guard_init(device)
    if not isinstance(d, dict):
        return init
    return GuardState(**{
        f: torch.as_tensor(d[f], dtype=getattr(init, f).dtype).to(device) if f in d
        else getattr(init, f) for f in GUARD_FIELDS})


def tree_select(pred: torch.Tensor, on_true: Dict[str, torch.Tensor],
                on_false: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Elementwise select of two dicts of tensors on a 0-d predicate."""
    return {k: torch.where(pred, on_true[k], on_false[k]) for k in on_true}


def guarded_update(opt: ClippedAdam, grads: Dict[str, torch.Tensor], opt_state: AdamState,
                   params: Dict[str, torch.Tensor], ema: Dict[str, torch.Tensor],
                   guard: GuardState, *, reject_limit: float, rollback_after: int,
                   ema_decay: float, backoff: float = 0.5, lr_scale_floor: float = 1.0 / 64.0,
                   recover_after: int = 256, reject_mult: float = 8.0,
                   gnorm_ref_decay: float = 0.98
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], AdamState,
                              GuardState, Dict[str, torch.Tensor]]:
    """One guarded optimizer step; the arguments are those of the JAX
    ``guarded_update``.  ``opt``'s count advances only on accepted steps.
    ``rollback_after=0`` disables rollback (pass ``ema=params``); an
    8-rejection streak then still halves ``lr_scale``.

    Returns (params, ema, opt_state, guard, info): info holds the raw
    ``grad_norm``, the ``lr_scale`` this step applied, and 0/1
    ``rejected`` and ``rollback`` flags, all 0-d tensors.
    """
    keys = list(params)
    gnorm = global_norm([grads[k] for k in keys])
    ok = torch.isfinite(gnorm)
    if reject_limit:
        ok = ok & (gnorm < reject_limit)
    if reject_mult:
        ok = ok & ((guard.gnorm_ref <= 0.0) | (gnorm < reject_mult * guard.gnorm_ref))

    # zeros on a rejected step (their results are discarded below); the
    # global norm of those zeros is 0, so the clip can take it from here
    safe = {k: torch.where(ok, grads[k], torch.zeros_like(grads[k])) for k in keys}
    updates, cand_opt = opt.update(safe, opt_state, torch.where(ok, gnorm, 0.0))
    scale = torch.where(ok, guard.lr_scale, 0.0)
    updates = dict(zip(keys, torch._foreach_mul([updates[k] for k in keys], scale)))
    new_opt = AdamState(count=torch.where(ok, cand_opt.count, opt_state.count),
                        mu=tree_select(ok, cand_opt.mu, opt_state.mu),
                        nu=tree_select(ok, cand_opt.nu, opt_state.nu))

    new_params = apply_updates(params, updates)
    new_ema = tree_select(ok, ema_update(ema, new_params, ema_decay), ema)

    zero_i = torch.zeros((), dtype=torch.int32, device=gnorm.device)
    streak = torch.where(ok, zero_i, guard.reject_streak + 1)
    if rollback_after:
        roll = streak >= rollback_after
        new_params = tree_select(roll, new_ema, new_params)
        new_opt = AdamState(count=new_opt.count,
                            mu={k: torch.where(roll, 0.0, v) for k, v in new_opt.mu.items()},
                            nu={k: torch.where(roll, 0.0, v) for k, v in new_opt.nu.items()})
        trigger = roll
    else:
        roll = torch.zeros((), dtype=torch.bool, device=gnorm.device)
        trigger = streak >= 8
    streak = torch.where(trigger, zero_i, streak)

    lr_scale = guard.lr_scale
    accept_streak = torch.where(ok, guard.accept_streak + 1, zero_i)
    if backoff and backoff != 1.0:
        lr_scale = torch.where(trigger, torch.clamp(lr_scale * backoff, min=lr_scale_floor),
                               lr_scale)
        recover = accept_streak >= recover_after
        lr_scale = torch.where(recover, torch.clamp(lr_scale * 2.0, max=1.0), lr_scale)
        accept_streak = torch.where(recover, zero_i, accept_streak)

    if gnorm_ref_decay < 1.0:
        seeded = torch.where(guard.gnorm_ref > 0.0,
                             gnorm_ref_decay * guard.gnorm_ref + (1.0 - gnorm_ref_decay) * gnorm,
                             gnorm)
        gnorm_ref = torch.where(ok, seeded, guard.gnorm_ref)
    else:
        gnorm_ref = guard.gnorm_ref

    new_guard = GuardState(
        reject_streak=streak,
        rejected_total=guard.rejected_total + (~ok).to(torch.int32),
        rollback_total=guard.rollback_total + roll.to(torch.int32),
        accept_streak=accept_streak, lr_scale=lr_scale, gnorm_ref=gnorm_ref)
    info = {"grad_norm": gnorm, "lr_scale": guard.lr_scale,
            "rejected": (~ok).float(), "rollback": roll.float()}
    return new_params, new_ema, new_opt, new_guard, info
