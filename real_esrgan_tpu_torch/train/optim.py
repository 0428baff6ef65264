"""Adam behind a global-norm clip: the counterpart of the JAX trainer's optax
chain ``chain(clip_by_global_norm(max_norm), adam(schedule, b1, b2))``.

Functional over dicts of tensors (``torch._foreach_*``), so the guard
(``train/guard.py``) can select whole states and zero the float moments on
a rollback while the integer update count stays: ``AdamState`` keeps the
count (0-d int32, on the device) apart from the moments.  The arithmetic is
optax's, term by term and in its order:

* clip: ``where(norm < max, g, (g / norm) * max)``, ``norm`` the global L2
  norm of the gradients;
* ``mu = (1 - b1) * g + b1 * mu``, ``nu = (1 - b2) * g * g + b2 * nu``;
* ``mu_hat = mu / (1 - b1 ** t)``, ``nu_hat = nu / (1 - b2 ** t)`` with
  ``t`` the count after this update, in float32;
* ``u = -lr(count) * mu_hat / (sqrt(nu_hat) + eps)``, the schedule read at
  the count before this update.

``torch.optim.Adam`` keeps a per-parameter ``step`` beside the moments and
cannot be selected or zeroed that way, hence this module.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from real_esrgan_tpu_torch.train.schedule import Schedule

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class AdamState:
    """The update count (0-d int32; it also indexes the schedule) and the
    float32 first and second moments, keyed as the parameters."""

    count: torch.Tensor
    mu: Tensors
    nu: Tensors

    def as_dict(self) -> Dict[str, object]:
        """The checkpoint's form: ``{"count", "mu", "nu"}``, no copies."""
        return {"count": self.count, "mu": self.mu, "nu": self.nu}


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) of every element, in float32, as a 0-d tensor.

    A square past float32's range is inf, as it is in JAX, so a huge finite
    gradient gives an infinite norm."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    return torch.sqrt(torch.sum(flat * flat))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: torch.Tensor = None) -> List[torch.Tensor]:
    """optax's clip: each gradient unchanged where the global norm is below
    ``max_norm``, else ``(g / norm) * max_norm``.  ``norm`` may be given
    when the caller has it."""
    norm = global_norm(grads) if norm is None else norm
    keep = norm < max_norm
    scaled = torch._foreach_mul(torch._foreach_div(grads, norm), max_norm)
    return [torch.where(keep, g, s) for g, s in zip(grads, scaled)]


class ClippedAdam:
    """``update`` maps gradients to updates (to be added to the parameters)
    and a new ``AdamState``; ``init`` makes the zero state."""

    def __init__(self, schedule: Schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, clip_norm: float = 0.0):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.clip_norm = clip_norm

    def init(self, params: Tensors) -> AdamState:
        device = next(iter(params.values())).device
        return AdamState(count=torch.zeros((), dtype=torch.int32, device=device),
                         mu={k: torch.zeros_like(v) for k, v in params.items()},
                         nu={k: torch.zeros_like(v) for k, v in params.items()})

    def update(self, grads: Tensors, state: AdamState,
               norm: torch.Tensor = None) -> Tuple[Tensors, AdamState]:
        """``norm``: the global norm of ``grads``, where the caller has it."""
        keys = list(state.mu)
        g = [grads[k] for k in keys]
        if self.clip_norm:
            g = clip_by_global_norm(g, self.clip_norm, norm)
        b1, b2 = self.b1, self.b2
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                torch._foreach_mul([state.mu[k] for k in keys], b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
                                torch._foreach_mul([state.nu[k] for k in keys], b2))
        count = state.count + 1
        t = count.float()
        mu_hat = torch._foreach_div(mu, 1 - torch.pow(b1, t))
        nu_hat = torch._foreach_div(nu, 1 - torch.pow(b2, t))
        denominator = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
        step_size = -1 * self.schedule(state.count)
        updates = torch._foreach_mul(torch._foreach_div(mu_hat, denominator), step_size)
        return (dict(zip(keys, updates)),
                AdamState(count=count, mu=dict(zip(keys, mu)), nu=dict(zip(keys, nu))))


def apply_updates(params: Tensors, updates: Tensors) -> Tensors:
    """params + updates, as new tensors."""
    keys = list(params)
    return dict(zip(keys, torch._foreach_add([params[k] for k in keys],
                                             [updates[k] for k in keys])))
