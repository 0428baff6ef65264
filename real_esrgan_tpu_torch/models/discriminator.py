"""Spectral-norm U-Net discriminator in PyTorch: the port of
real_esrgan_tpu/models/discriminator.py.

The same op graph as the JAX ``UNetDiscriminator``: a 3 -> c conv, three
stride-2 4x4 down convs (c -> 2c -> 4c -> 8c), three bilinear-x2 upsamples,
each followed by a 3x3 conv and a skip addition, two 3x3 heads and a 1-channel
conv, all spectral-normalized but the first and the last.  The public layout
is NHWC, the logits are a float32 (B, H, W, 1) map.  Parameters are float32
OIHW under the JAX module names (``conv1``, ``down1-3``, ``up1-3``,
``conv2``, ``conv3``, ``conv4``); ``dtype`` is the compute type.

Spectral normalization is flax's (``SpectralNorm._spectral_normalize``),
not ``torch.nn.utils.spectral_norm``: a kernel is viewed as a matrix with
one column an output channel, each call runs one power iteration from the
stored ``u`` (shape (1, cout)), ``sigma = v W u^T`` with ``u`` and ``v``
held constant for autograd, and the kernel is divided by ``sigma`` where it
is not 0.  The products are elementwise multiplies and sums, so no TF32
flag can round them.  The state, ``u`` and ``sigma`` of each layer, is a
plain dict of tensors (``"down1.u"``, ``"down1.sigma"``, ...), passed in
and returned by ``forward`` as the JAX module's ``batch_stats`` are; it
changes only with ``update_stats=True``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from real_esrgan_tpu_torch.models.rrdbnet import (
    Conv3x3, torch_conv_bias_init, torch_conv_kernel_init,
)
from real_esrgan_tpu_torch.ops.fused_rdb import lrelu

Tensors = Dict[str, torch.Tensor]

# (name, in and out channels as multiples of c, kernel, stride), in call order
SN_LAYERS = (("down1", 1, 2, 4, 2), ("down2", 2, 4, 4, 2), ("down3", 4, 8, 4, 2),
             ("up1", 8, 4, 3, 1), ("up2", 4, 2, 3, 1), ("up3", 2, 1, 3, 1),
             ("conv2", 1, 1, 3, 1), ("conv3", 1, 1, 3, 1))
SN_EPS = 1e-12


def _l2_normalize(x: torch.Tensor, eps: float = SN_EPS) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + eps)


def spectral_normalize(weight: torch.Tensor, u: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(weight / sigma, the new u, sigma) after one power iteration from ``u``.

    ``weight`` is OIHW; flax views its HWIO kernel as a (kh*kw*cin, cout)
    matrix, whose rows are this one's columns in another order, which
    changes neither ``u`` nor ``sigma``."""
    cout = weight.shape[0]
    mat = weight.reshape(cout, -1)
    with torch.no_grad():
        m = mat.detach()
        v = _l2_normalize((u.reshape(cout, 1) * m).sum(0))
        u_new = _l2_normalize((m * v).sum(1))
    sigma = ((mat * v).sum(1) * u_new).sum()
    return weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma)), \
        u_new.reshape(1, cout), sigma.detach()


def upsample_bilinear_2x(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear on NCHW, ``align_corners=False``: the JAX module's
    ``jax.image.resize(..., "bilinear", antialias=False)``.  At the border
    JAX drops the tap outside the image and renormalises, which leaves the
    edge pixel alone; PyTorch clamps the index to the edge: the same value."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


class SNConv(nn.Module):
    """A bias-free conv, padding 1, whose kernel is spectral-normalized at
    every call."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, device=None):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel, device=device))

    def forward(self, x: torch.Tensor, u: torch.Tensor):
        w, u_new, sigma = spectral_normalize(self.weight, u)
        return F.conv2d(x, w.to(x.dtype), stride=self.stride, padding=1), u_new, sigma


class UNetDiscriminator(nn.Module):
    """``forward(x, stats, update_stats=False) -> (logits, stats)``: NHWC
    images in, float32 (B, H, W, 1) logits and the spectral state out.
    Weights and the first state (``self.stats``, u drawn from a normal, sigma
    1) come from ``generator`` (seed 0 when None)."""

    def __init__(self, channels: int = 64, dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = channels
        self.channels, self.dtype = c, dtype
        self.conv1 = Conv3x3(3, c, device)
        for name, cin, cout, kernel, stride in SN_LAYERS:
            setattr(self, name, SNConv(cin * c, cout * c, kernel, stride, device))
        self.conv4 = Conv3x3(c, 1, device)
        self.stats = self.reset_parameters(generator if generator is not None
                                           else torch.Generator().manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> Tensors:
        """PyTorch's default conv init (the JAX module's); returns a fresh
        spectral state."""
        for conv in (self.conv1, self.conv4):
            shape = conv.weight.shape
            conv.weight.copy_(torch_conv_kernel_init(shape, generator))
            conv.bias.copy_(torch_conv_bias_init(conv.bias.shape, 9 * shape[1], generator))
        stats = {}
        for name, *_ in SN_LAYERS:
            layer = getattr(self, name)
            layer.weight.copy_(torch_conv_kernel_init(layer.weight.shape, generator))
            cout, device = layer.weight.shape[0], layer.weight.device
            stats[f"{name}.u"] = torch.randn(1, cout, generator=generator).to(device)
            stats[f"{name}.sigma"] = torch.ones((), device=device)
        return stats

    def forward(self, x: torch.Tensor, stats: Tensors, update_stats: bool = False
                ) -> Tuple[torch.Tensor, Tensors]:
        new_stats = dict(stats)

        def sn(name, h):
            y, u, sigma = getattr(self, name)(h, stats[f"{name}.u"])
            if update_stats:
                new_stats[f"{name}.u"], new_stats[f"{name}.sigma"] = u, sigma
            return lrelu(y)

        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        out1 = self.conv1(x)
        down1 = sn("down1", out1)
        down2 = sn("down2", down1)
        down3 = sn("down3", down2)
        up1 = sn("up1", upsample_bilinear_2x(down3)) + down2
        up2 = sn("up2", upsample_bilinear_2x(up1)) + down1
        up3 = sn("up3", upsample_bilinear_2x(up2)) + out1
        out = sn("conv3", sn("conv2", up3))
        out = self.conv4(out).float().permute(0, 2, 3, 1)
        return out, (new_stats if update_stats else stats)
