"""The control's precision: a float8 round trip with one scale a tensor.

The configurations state bfloat16; the nearest precision below it is float8.
``fp8`` rounds a tensor to float8 e4m3 after scaling its largest magnitude
to e4m3's largest finite value (448), as float8 inference scales a tensor,
and scales it back to float32."""

from __future__ import annotations

import torch

_E4M3_MAX = 448.0


def _round_trip(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _round_trip(x, torch.float8_e4m3fn, _E4M3_MAX)
