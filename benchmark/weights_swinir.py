"""SwinIR weights drawn from the run's seed, on the device, by the benchmark
itself: both the program and the reference are handed these tensors, so
neither side's own initialisation enters a comparison.

The draws follow SwinIR's published initialisation (``_init_weights``):
every linear trunc-normal(0.02) (cut at +-2, which at 0.02 cuts nothing)
with a zero bias, every LayerNorm weight 1 and bias 0, every conv PyTorch's
default uniform(+-1/sqrt(fan_in)) for weight and bias.  One departure: the
relative-position bias tables are drawn N(0, 1), not trunc-normal(0.02), so
that the bias shapes the softmax as a trained table does and an indexing
error shows in ``correct``.  All normals come from one ``torch.randn`` call
and all uniforms from one ``torch.rand`` call of a ``torch.Generator`` on the
device, in float32, the type the parameters are held in.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Shape = Tuple[int, ...]


def swinir_params_shapes(cfg: dict) -> List[Tuple[str, Shape, str]]:
    """(name, shape, draw) of every parameter, named as SwinIR's state dict
    names them; draw is ``linear``, ``table``, ``conv``, ``conv_bias`` (of
    the conv before it), ``zeros`` or ``ones``."""
    c, f, ws = cfg["embed_dim"], cfg["num_feat"], cfg["window_size"]
    hidden = int(c * cfg["mlp_ratio"])
    out: List[Tuple[str, Shape, str]] = []

    def conv(name, cin, cout, k):
        out.extend([(f"{name}.weight", (cout, cin, k, k), "conv"),
                    (f"{name}.bias", (cout,), "conv_bias")])

    def linear(name, cin, cout):
        out.extend([(f"{name}.weight", (cout, cin), "linear"), (f"{name}.bias", (cout,), "zeros")])

    def norm(name):
        out.extend([(f"{name}.weight", (c,), "ones"), (f"{name}.bias", (c,), "zeros")])

    def three_conv(name):
        conv(f"{name}.0", c, c // 4, 3)
        conv(f"{name}.2", c // 4, c // 4, 1)
        conv(f"{name}.4", c // 4, c, 3)

    conv("conv_first", cfg["in_chans"], c, 3)
    norm("patch_embed.norm")
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        for j in range(depth):
            block = f"layers.{i}.residual_group.blocks.{j}"
            norm(f"{block}.norm1")
            out.append((f"{block}.attn.relative_position_bias_table",
                        ((2 * ws - 1) ** 2, heads), "table"))
            linear(f"{block}.attn.qkv", c, 3 * c)
            linear(f"{block}.attn.proj", c, c)
            norm(f"{block}.norm2")
            linear(f"{block}.mlp.fc1", c, hidden)
            linear(f"{block}.mlp.fc2", hidden, c)
        three_conv(f"layers.{i}.conv")
    norm("norm")
    three_conv("conv_after_body")
    conv("conv_before_upsample.0", c, f, 3)
    for name in ("conv_up1", "conv_up2", "conv_hr"):
        conv(name, f, f, 3)
    conv("conv_last", f, cfg["in_chans"], 3)
    return out


def swinir_params(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded float32 parameters of ``cfg``'s SwinIR on ``device``."""
    shapes = swinir_params_shapes(cfg)
    n_normal = sum(math.prod(s) for _, s, draw in shapes if draw in ("linear", "table"))
    n_uniform = sum(math.prod(s) for _, s, draw in shapes if draw.startswith("conv"))
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device) * 2 - 1
    params, i_n, i_u, fan_in = {}, 0, 0, 1
    for name, shape, draw in shapes:
        n = math.prod(shape)
        if draw in ("linear", "table"):
            x = normal[i_n:i_n + n].view(shape)
            params[name] = (x * 0.02).clamp(-2.0, 2.0) if draw == "linear" else x
            i_n += n
        elif draw.startswith("conv"):
            if draw == "conv":
                fan_in = math.prod(shape[1:])
            params[name] = uniform[i_u:i_u + n].view(shape) / math.sqrt(fan_in)
            i_u += n
        else:
            params[name] = torch.full(shape, 1.0 if draw == "ones" else 0.0, device=device)
    return params
