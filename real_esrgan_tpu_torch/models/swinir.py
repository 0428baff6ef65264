"""SwinIR (Liang et al., "SwinIR: Image Restoration Using Swin Transformer",
arXiv:2108.10257) for real-world x4 super-resolution, in PyTorch.

The defaults are SwinIR-L of the published ``real_sr`` task
(``main_test_swinir.py::define_model`` with ``--large_model``): 240
features, 9 residual Swin transformer blocks (RSTBs) of 6 Swin blocks each, 8
heads of 30, windows of 8 x 8 shifted by 4 in every odd block, MLP ratio 2,
the ``3conv`` residual connection and the ``nearest+conv`` x4 tail.  The
public layout is NHWC float in [0, 1], as ``Generator``'s: the model pads
its input to multiples of the window by reflection (SwinIR's
``check_image_size``), crops the output back to 4H x 4W, and clamps it.

Inside, the token stream of the Swin blocks is a contiguous (B, H, W, C)
tensor, so the linears run on it as they are and the convolutions see it as
an NCHW tensor in ``channels_last`` memory, with no copy between the two.
Parameters are float32 and named as SwinIR's state dict names them
(``conv_first``, ``patch_embed.norm``, ``layers.{i}.residual_group.blocks.{j}
.{norm1, attn.qkv, attn.proj, attn.relative_position_bias_table, norm2,
mlp.fc1, mlp.fc2}``, ``layers.{i}.conv.{0,2,4}``, ``norm``,
``conv_after_body.{0,2,4}``, ``conv_before_upsample.0``, ``conv_up1``,
``conv_up2``, ``conv_hr``, ``conv_last``), so the release weights load as they
are (``train/checkpoint.py::load_generator_params``).  ``dtype`` is the
compute type; LayerNorm's statistics and the softmax are taken in float32,
GELU is the exact (erf) form.

Window attention (``attn.core``, a submodule around the call alone) runs
the hand-written kernel ``ops/window_attn.py::window_attn``, and every
LayerNorm (``norm1`` and ``norm2`` of each Swin block, ``patch_embed.norm``,
``norm``) the hand-written kernel ``ops/layer_norm.py::layer_norm``, on a
CUDA device where autograd records nothing: 54 and 110 launches a SwinIR-L
forward.  Otherwise both run their plain versions.  The tail
after ``conv_before_upsample`` is RRDBNet's: both nearest x2 upconvs are
folded into low-resolution convs (``rrdbnet._subpixel_upconv``), and their
and ``conv_hr``'s bias, LeakyReLU(0.2) and shuffle are one pass of the tail
kernel on the card.  ``conv_before_upsample``'s LeakyReLU keeps PyTorch's
default slope, 0.01, and runs as a plain op.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from real_esrgan_tpu_torch.models.rrdbnet import (
    Conv3x3, _fused_epilogue, _subpixel_upconv, torch_conv_bias_init, torch_conv_kernel_init,
)
from real_esrgan_tpu_torch.ops.fused_rdb import lrelu
from real_esrgan_tpu_torch.ops.layer_norm import layer_norm, layer_norm_plain
from real_esrgan_tpu_torch.ops.tail_epilogue import bias_lrelu
from real_esrgan_tpu_torch.ops.window_attn import WINDOW, window_attn, window_attn_plain

RGB_MEAN = (0.4488, 0.4371, 0.4040)
LN_EPS = 1e-5
MLP_RATIO = 2
# every odd block's shift: half the 8 x 8 window, as SwinIR sets it wherever its
# training size (img_size 64) exceeds the window
SHIFT = WINDOW // 2


class Linear(nn.Module):
    """``nn.Linear``'s parameters, applied in the input's dtype."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.Module):
    """LayerNorm over the last dim, its statistics in float32 (as PyTorch's
    kernels take them for a bfloat16 input), its output in the input's dtype,
    the weight and bias rounded to it.  On a CUDA tensor where autograd
    records nothing it runs the hand-written kernel
    ``ops/layer_norm.py::layer_norm`` (it has no backward), else
    ``layer_norm_plain`` (``F.layer_norm``)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self.weight.to(x.dtype), self.bias.to(x.dtype)
        records = torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                               or bias.requires_grad)
        if x.is_cuda and not records:
            return layer_norm(x.contiguous(), weight, bias, LN_EPS)
        return layer_norm_plain(x, weight, bias, LN_EPS)


class Conv(nn.Module):
    """A 'same' k x k convolution with its bias, in the input's dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel, kernel,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        padding=self.weight.shape[-1] // 2)


def three_conv(dim: int, device=None) -> nn.Sequential:
    """SwinIR's ``resi_connection='3conv'``: 3x3 dim -> dim/4, LeakyReLU(0.2),
    1x1 dim/4 -> dim/4, LeakyReLU(0.2), 3x3 dim/4 -> dim."""
    return nn.Sequential(Conv(dim, dim // 4, 3, device), nn.LeakyReLU(0.2),
                         Conv(dim // 4, dim // 4, 1, device), nn.LeakyReLU(0.2),
                         Conv(dim // 4, dim, 3, device))


class WindowAttentionCore(nn.Module):
    """The window attention call alone, so that hooks on it time it: the
    kernel on a CUDA tensor where autograd records nothing (it has no
    backward), else ``window_attn_plain``."""

    def __init__(self, heads: int):
        super().__init__()
        self.heads = heads

    def forward(self, qkv: torch.Tensor, table: torch.Tensor, shift: int) -> torch.Tensor:
        records = torch.is_grad_enabled() and (qkv.requires_grad or table.requires_grad)
        if qkv.is_cuda and not records:
            return window_attn(qkv, table, self.heads, shift)
        return window_attn_plain(qkv, table, self.heads, shift)


class WindowAttention(nn.Module):
    """qkv projection, shifted-window attention, output projection, on a
    (B, H, W, C) token stream whose sides are multiples of the window."""

    def __init__(self, dim: int, heads: int, device=None):
        super().__init__()
        self.qkv = Linear(dim, 3 * dim, device)
        self.proj = Linear(dim, dim, device)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * WINDOW - 1) ** 2, heads, device=device))
        self.core = WindowAttentionCore(heads)

    def forward(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        return self.proj(self.core(self.qkv(x), self.relative_position_bias_table, shift))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, device)
        self.fc2 = Linear(hidden, dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """x + attn(LN1(x)), then x + MLP(LN2(x)) (SwinIR's ``SwinTransformerBlock``)."""

    def __init__(self, dim: int, heads: int, shift: int, device=None):
        super().__init__()
        self.shift = shift
        self.norm1 = LayerNorm(dim, device)
        self.attn = WindowAttention(dim, heads, device)
        self.norm2 = LayerNorm(dim, device)
        self.mlp = Mlp(dim, MLP_RATIO * dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), self.shift)
        return x + self.mlp(self.norm2(x))


class BasicLayer(nn.Module):
    def __init__(self, blocks: Sequence[SwinBlock]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x


class RSTB(nn.Module):
    """Residual Swin transformer block: the Swin blocks, the ``3conv``
    module on the tokens as an image, and the block's input added back."""

    def __init__(self, dim: int, depth: int, heads: int, device=None):
        super().__init__()
        self.residual_group = BasicLayer(SwinBlock(dim, heads, SHIFT if j % 2 else 0, device)
                                         for j in range(depth))
        self.conv = three_conv(dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.residual_group(x).permute(0, 3, 1, 2)  # NCHW in channels_last memory
        return self.conv(y).permute(0, 2, 3, 1) + x


class PatchEmbed(nn.Module):
    """SwinIR's top-level ``patch_embed``: the tokens' LayerNorm."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.norm = LayerNorm(dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)


class SwinIR(nn.Module):
    """SwinIR with the ``nearest+conv`` x4 tail, NHWC RGB in and out, values
    in [0, 1] (see the module's docstring); the defaults are SwinIR-L's
    widths, and the window, the MLP ratio and the shift are its.  Weights are drawn from
    ``generator`` (a ``torch.Generator``; seed 0 when None) with SwinIR's
    initialisation: linears trunc-normal(0.02) with zero biases, LayerNorms
    one and zero, the bias tables trunc-normal(0.02), convolutions PyTorch's
    default."""

    def __init__(self, upscale_factor: int = 4, embed_dim: int = 240,
                 depths: Sequence[int] = (6,) * 9, num_heads: Sequence[int] = (8,) * 9,
                 num_feat: int = 64, dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if upscale_factor != 4:
            raise ValueError(f"the nearest+conv tail upscales x4, not x{upscale_factor}")
        self.upscale_factor, self.dtype = 4, dtype
        self.conv_first = Conv(3, embed_dim, 3, device)
        self.patch_embed = PatchEmbed(embed_dim, device)
        self.layers = nn.ModuleList(RSTB(embed_dim, depth, heads, device)
                                    for depth, heads in zip(depths, num_heads))
        self.norm = LayerNorm(embed_dim, device)
        self.conv_after_body = three_conv(embed_dim, device)
        self.conv_before_upsample = nn.Sequential(Conv(embed_dim, num_feat, 3, device),
                                                  nn.LeakyReLU())  # slope 0.01
        self.conv_up1 = Conv3x3(num_feat, num_feat, device)
        self.conv_up2 = Conv3x3(num_feat, num_feat, device)
        self.conv_hr = Conv3x3(num_feat, num_feat, device)
        self.conv_last = Conv3x3(num_feat, 3, device)
        self.register_buffer("mean", torch.tensor(RGB_MEAN, device=device), persistent=False)
        init_swinir(self, generator if generator is not None
                    else torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        img = pad_to_window(x.permute(0, 3, 1, 2))
        img = (img - self.mean[:, None, None]).to(self.dtype)
        feat = self.conv_first(img.contiguous(memory_format=torch.channels_last))
        t = self.patch_embed(feat.permute(0, 2, 3, 1))  # (B, H, W, C) tokens
        for layer in self.layers:
            t = layer(t)
        out = self.conv_after_body(self.norm(t).permute(0, 3, 1, 2)) + feat
        out = self.conv_before_upsample(out)
        for up in (self.conv_up1, self.conv_up2):
            out = _subpixel_upconv(out, up.weight, up.bias)
        hr = self.conv_hr
        if _fused_epilogue(out, hr.weight, hr.bias):
            out = bias_lrelu(hr.convolve(out), hr.bias, shuffle=False)
        else:
            out = lrelu(hr(out))
        out = self.conv_last(out).float().permute(0, 2, 3, 1) + self.mean
        return out[:, :4 * h, :4 * w].clamp(0.0, 1.0)


def pad_to_window(img: torch.Tensor) -> torch.Tensor:
    """An NCHW image padded at the bottom and right to multiples of the
    window: by reflection, or by repeating the edge where a side is too
    short to reflect."""
    h, w = img.shape[-2:]
    ph, pw = (-h) % WINDOW, (-w) % WINDOW
    if not ph and not pw:
        return img
    return F.pad(img, (0, pw, 0, ph), mode="reflect" if ph < h and pw < w else "replicate")


@torch.no_grad()
def init_swinir(model: nn.Module, generator: torch.Generator) -> None:
    """SwinIR's ``_init_weights`` on every linear and LayerNorm, trunc-normal
    (0.02, cut at +-2) on the bias tables, PyTorch's default on the convs."""
    def trunc_normal(shape):
        return (torch.randn(shape, generator=generator) * 0.02).clamp(-2.0, 2.0)

    for name, module in model.named_modules():
        if isinstance(module, Linear):
            module.weight.copy_(trunc_normal(module.weight.shape))
            module.bias.zero_()
        elif isinstance(module, LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, WindowAttention):
            table = module.relative_position_bias_table
            table.copy_(trunc_normal(table.shape))
        elif isinstance(module, (Conv, Conv3x3)):
            shape = module.weight.shape
            module.weight.copy_(torch_conv_kernel_init(shape, generator))
            fan_in = shape[1] * shape[2] * shape[3]
            module.bias.copy_(torch_conv_bias_init(module.bias.shape, fan_in, generator))
