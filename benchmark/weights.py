"""Generator weights drawn from the run's seed, on the device, by the
benchmark itself: both the program and the reference are handed these
tensors, so neither side's own initialisation enters a comparison.

The draws follow the published initialisation of RRDBNet (Real-ESRGAN's
``default_init_weights``): every conv of a dense block kaiming-normal (fan
in) scaled by 0.1 with a zero bias; every other conv PyTorch's default
uniform(+-1/sqrt(fan_in)) for weight and bias.  All normals come from one
``torch.randn`` call and all uniforms from one ``torch.rand`` call of a
``torch.Generator`` on the device, in float32, the type the parameters are
held in (the compute type is the configuration's ``dtype``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Shape = Tuple[int, ...]


def generator_convs(cfg: dict) -> List[Tuple[str, Shape, bool]]:
    """(name, OIHW weight shape, is a dense-block conv) of every 3x3 conv,
    named as the program's state dict names them."""
    c, g = cfg["num_feat"], cfg["num_grow_ch"]
    unshuffle = {1: 4, 2: 2, 4: 1}[cfg["scale"]]
    convs = [("conv1", (c, cfg["num_in_ch"] * unshuffle ** 2, 3, 3), False)]
    for i in range(cfg["num_block"]):
        for j in range(1, 4):
            for k in range(1, 6):
                convs.append((f"trunk.{i}.rdb{j}.conv{k}",
                              (g if k < 5 else c, c + (k - 1) * g, 3, 3), True))
    convs += [(name, (c, c, 3, 3), False)
              for name in ("conv2", "upsampling1.0", "upsampling2.0", "conv3.0")]
    convs.append(("conv4", (cfg["num_out_ch"], c, 3, 3), False))
    return convs


def generator_params(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded float32 parameters of ``cfg``'s generator on ``device``."""
    convs = generator_convs(cfg)
    n_normal = sum(math.prod(s) for _, s, dense in convs if dense)
    n_uniform = sum(math.prod(s) + s[0] for _, s, dense in convs if not dense)
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device) * 2 - 1
    params, i_n, i_u = {}, 0, 0
    for name, shape, dense in convs:
        n, fan_in = math.prod(shape), math.prod(shape[1:])
        if dense:
            params[f"{name}.weight"] = normal[i_n:i_n + n].view(shape) * (
                math.sqrt(2.0 / fan_in) * 0.1)
            params[f"{name}.bias"] = torch.zeros(shape[0], device=device)
            i_n += n
        else:
            bound = 1.0 / math.sqrt(fan_in)
            params[f"{name}.weight"] = uniform[i_u:i_u + n].view(shape) * bound
            params[f"{name}.bias"] = uniform[i_u + n:i_u + n + shape[0]] * bound
            i_u += n + shape[0]
    return params
