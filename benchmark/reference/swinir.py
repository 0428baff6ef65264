"""Plain PyTorch reference of SwinIR with the ``nearest+conv`` x4 tail
(Liang et al., arXiv:2108.10257; ``network_swinir.py`` of
JingyunLiang/SwinIR), NHWC in and out, values in [0, 1].

It follows SwinIR's own module code and imports nothing of the program:
``check_image_size``'s reflect pad to multiples of the window; ``(x - mean)
* img_range``; ``conv_first``; ``patch_embed`` (flatten, LayerNorm); the
RSTBs, each a ``BasicLayer`` of ``SwinTransformerBlock``s (LayerNorm,
``torch.roll`` by -shift, ``window_partition``, ``WindowAttention`` with its
bias gathered from the table by ``relative_position_index`` and the shifted
blocks' ``calculate_mask`` added, both materialised, ``window_reverse``, the
roll undone, the residual, LayerNorm, MLP with exact GELU, the residual),
then ``patch_unembed``, the ``3conv`` module, ``patch_embed`` (no norm) and
the RSTB's input added back; the final LayerNorm, ``conv_after_body`` and
``conv_first``'s output added back; ``conv_before_upsample`` with
LeakyReLU(0.01), two nearest x2 upsamplings each followed by a conv and
LeakyReLU(0.2), ``conv_hr`` with LeakyReLU(0.2), ``conv_last``, ``/ img_range
+ mean`` and the crop to 4H x 4W.  A block's shift is ``window_size // 2`` in
every odd block, 0 where ``img_size`` is no larger than the window.

Departures from SwinIR's code: the output is clamped to [0, 1] (the
published test script clamps when it saves); an input is padded by
reflection inside the forward (SwinIR's ``check_image_size``), where the
test script pads it first by flip-concatenation; a side too short to
reflect is padded by repeating its edge; in a lower precision
(``forward_in_blocks``'s ``dtype``) the image's normalisation and its
inverse stay in float32, so that the network's own roundings, and not the
last one of an output near the mean, make the bfloat16 composition's gap.

Parameter names are SwinIR's state dict names.  ``quant``, where given, is
applied to every linear's and conv's input and weight: the control passes a
float8 round trip there.  Call ``plain_float32()`` first on a GPU, so that
no product falls into TF32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]
MEAN = (0.4488, 0.4371, 0.4040)


def plain_float32() -> None:
    """float32 products in float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _conv(p, name: str, x: torch.Tensor, quant: Quant) -> torch.Tensor:
    w = p[f"{name}.weight"]
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.conv2d(x, w, p[f"{name}.bias"], padding=w.shape[-1] // 2)


def _linear(p, name: str, x: torch.Tensor, quant: Quant) -> torch.Tensor:
    w = p[f"{name}.weight"]
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.linear(x, w, p[f"{name}.bias"])


def _layer_norm(p, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    b = int(windows.shape[0] / (h * w / ws / ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def relative_position_index(ws: int) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid([torch.arange(ws), torch.arange(ws)], indexing="ij"))
    coords_flatten = torch.flatten(coords, 1)
    relative_coords = coords_flatten[:, :, None] - coords_flatten[:, None, :]
    relative_coords = relative_coords.permute(1, 2, 0).contiguous()
    relative_coords[:, :, 0] += ws - 1
    relative_coords[:, :, 1] += ws - 1
    relative_coords[:, :, 0] *= 2 * ws - 1
    return relative_coords.sum(-1)


def calculate_mask(h: int, w: int, ws: int, shift: int) -> torch.Tensor:
    img_mask = torch.zeros((1, h, w, 1))
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for wsl in slices:
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mask_windows = window_partition(img_mask, ws).view(-1, ws * ws)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, float(-100.0)).masked_fill(attn_mask == 0,
                                                                           float(0.0))


def window_attention(p, name: str, x: torch.Tensor, heads: int, ws: int,
                     mask: Optional[torch.Tensor], quant: Quant) -> torch.Tensor:
    b_, n, c = x.shape
    qkv = _linear(p, f"{name}.qkv", x, quant).reshape(b_, n, 3, heads, c // heads)
    qkv = qkv.permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    q = q * (c // heads) ** -0.5
    attn = q @ k.transpose(-2, -1)
    table = p[f"{name}.relative_position_bias_table"]
    bias = table[relative_position_index(ws).to(table.device).view(-1)].view(n, n, -1)
    attn = attn + bias.permute(2, 0, 1).contiguous().unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(b_ // nw, nw, heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    x = (attn @ v).transpose(1, 2).reshape(b_, n, c)
    return _linear(p, f"{name}.proj", x, quant)


def swin_block(p, name: str, x: torch.Tensor, size, heads: int, ws: int, shift: int,
               eps: float, quant: Quant) -> torch.Tensor:
    h, w = size
    b, _, c = x.shape
    shortcut = x
    x = _layer_norm(p, f"{name}.norm1", x, eps).view(b, h, w, c)
    if shift > 0:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    x_windows = window_partition(x, ws).view(-1, ws * ws, c)
    mask = calculate_mask(h, w, ws, shift).to(x.device, x.dtype) if shift > 0 else None
    attn_windows = window_attention(p, f"{name}.attn", x_windows, heads, ws, mask, quant)
    x = window_reverse(attn_windows.view(-1, ws, ws, c), ws, h, w)
    if shift > 0:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    x = shortcut + x.view(b, h * w, c)
    y = _layer_norm(p, f"{name}.norm2", x, eps)
    y = _linear(p, f"{name}.mlp.fc2", F.gelu(_linear(p, f"{name}.mlp.fc1", y, quant)), quant)
    return x + y


def three_conv(p, name: str, x: torch.Tensor, quant: Quant) -> torch.Tensor:
    x = F.leaky_relu(_conv(p, f"{name}.0", x, quant), 0.2)
    x = F.leaky_relu(_conv(p, f"{name}.2", x, quant), 0.2)
    return _conv(p, f"{name}.4", x, quant)


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict, quant: Quant = None
            ) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] -> (B, 4H, 4W, 3) float32 in [0, 1]; the
    network runs in the parameters' dtype, the image's normalisation and
    its inverse in float32."""
    ws, eps, r = cfg["window_size"], cfg["layer_norm_eps"], cfg["img_range"]
    shift = 0 if cfg["img_size"] <= ws else ws // 2
    img = x.permute(0, 3, 1, 2)
    h_old, w_old = img.shape[2:]
    ph, pw = (-h_old) % ws, (-w_old) % ws
    if ph or pw:
        img = F.pad(img, (0, pw, 0, ph), mode="reflect" if ph < h_old and pw < w_old
                    else "replicate")
    mean = torch.tensor(cfg["rgb_mean"], device=img.device).view(1, 3, 1, 1)
    img = ((img.float() - mean) * r).to(p["conv_first.weight"].dtype)
    feat = _conv(p, "conv_first", img, quant)
    b, c, h, w = feat.shape
    t = _layer_norm(p, "patch_embed.norm", feat.flatten(2).transpose(1, 2), eps)
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        res = t
        for j in range(depth):
            t = swin_block(p, f"layers.{i}.residual_group.blocks.{j}", t, (h, w), heads, ws,
                           0 if j % 2 == 0 else shift, eps, quant)
        t = three_conv(p, f"layers.{i}.conv", t.transpose(1, 2).view(b, c, h, w), quant)
        t = t.flatten(2).transpose(1, 2) + res
    t = _layer_norm(p, "norm", t, eps).transpose(1, 2).view(b, c, h, w)
    out = three_conv(p, "conv_after_body", t, quant) + feat
    out = F.leaky_relu(_conv(p, "conv_before_upsample.0", out, quant), 0.01)
    for name in ("conv_up1", "conv_up2"):
        out = F.interpolate(out, scale_factor=2, mode="nearest")
        out = F.leaky_relu(_conv(p, name, out, quant), 0.2)
    out = _conv(p, "conv_last", F.leaky_relu(_conv(p, "conv_hr", out, quant), 0.2), quant)
    out = out.float() / r + mean
    s = cfg["upscale"]
    return out[:, :, :h_old * s, :w_old * s].permute(0, 2, 3, 1).clamp(0.0, 1.0)


@torch.no_grad()
def forward_in_blocks(p, x: torch.Tensor, cfg: dict, block: int, quant: Quant = None,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``forward`` of ``x`` a ``block`` of images at a time, so that the
    reference (its scores materialised: 0.54 GB a block of four 256^2 images
    in float32) fits beside what the run keeps; ``dtype`` is the type of the
    weights and of the network's activations (each product accumulates in
    float32 and rounds its output to it), from the normalised image to
    ``conv_last``'s output; the output is float32."""
    p = {k: v.to(dtype) for k, v in p.items()}
    return torch.cat([forward(p, x[i:i + block], cfg, quant)
                      for i in range(0, len(x), block)])
