"""Exponential moving average of parameters: the port of
real_esrgan_tpu/models/ema.py.

The shadow weights are a second dict of tensors beside the parameters
(name -> tensor), updated by the trainer's step.  ``ema_update`` computes
``decay * e + (1 - decay) * p`` as the JAX package writes it, with
``1 - decay`` taken in Python floats: a ``lerp`` rounds differently.
"""

from __future__ import annotations

from typing import Dict

import torch

Tensors = Dict[str, torch.Tensor]


def ema_init(params: Tensors) -> Tensors:
    """shadow <- a copy of params (not an alias)."""
    return {k: v.detach().clone() for k, v in params.items()}


def ema_update(ema: Tensors, params: Tensors, decay: float) -> Tensors:
    """shadow <- decay * shadow + (1 - decay) * params, as new tensors."""
    keys = list(ema)
    return dict(zip(keys, torch._foreach_add(
        torch._foreach_mul([ema[k] for k in keys], decay),
        torch._foreach_mul([params[k] for k in keys], 1.0 - decay))))
