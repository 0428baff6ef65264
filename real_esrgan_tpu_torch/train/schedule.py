"""Learning-rate schedules: the port of real_esrgan_tpu/train/schedule.py.

* ``step_lr``: StepLR(step_size, gamma), the ESRNet schedule;
* ``multistep_lr``: MultiStepLR(milestones, gamma), the ESRGAN schedule.

Both are indexed by the optimizer's update count, a 0-d int32 tensor on the
training device, and return the learning rate as a 0-d float32 tensor on
the same device: the step never reads the count on the host.  Both take
``warmup_steps``, a linear ramp 1/N .. 1 over the first N steps (0: none).
The float32 arithmetic is the JAX package's, in its order.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


def _warmup_factor(step: torch.Tensor, warmup_steps: int):
    if not warmup_steps:
        return 1.0
    return torch.clamp((step.float() + 1.0) / warmup_steps, max=1.0)


def step_lr(base_lr: float, step_size_epochs: int, gamma: float, steps_per_epoch: int,
            warmup_steps: int = 0) -> Schedule:
    def schedule(step: torch.Tensor) -> torch.Tensor:
        epoch = torch.div(step, steps_per_epoch, rounding_mode="floor")
        decays = torch.div(epoch, step_size_epochs, rounding_mode="floor").float()
        lr = base_lr * torch.pow(gamma, decays)
        return lr * _warmup_factor(step, warmup_steps)

    return schedule


def multistep_lr(base_lr: float, milestones_epochs: Sequence[int], gamma: float,
                 steps_per_epoch: int, warmup_steps: int = 0) -> Schedule:
    ordered = sorted(milestones_epochs)

    def schedule(step: torch.Tensor) -> torch.Tensor:
        epoch = torch.div(step, steps_per_epoch, rounding_mode="floor")
        milestones = torch.tensor(ordered, dtype=epoch.dtype, device=epoch.device)
        hits = (epoch >= milestones).float().sum()
        lr = base_lr * torch.pow(gamma, hits)
        return lr * _warmup_factor(step, warmup_steps)

    return schedule
