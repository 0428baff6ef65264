"""RRDB generator (Real-ESRGAN) in PyTorch: the port of
real_esrgan_tpu/models/rrdbnet.py.

Same op graph as the JAX ``Generator``: optional pixel-unshuffle front end,
3->64 conv, RRDB trunk, trunk conv plus global residual, two subpixel x2
upconvs, two output convs, clamp to [0, 1].  The public layout is NHWC float
in [0, 1].  Inside, activations are NCHW tensors in ``channels_last`` memory,
physically NHWC, so the fused RDB kernel reads and writes them with no copy.

Parameter names follow the reference state_dict (``conv1``,
``trunk.{i}.rdb{j}.conv{k}``, ``conv2``, ``upsampling{1,2}.0``, ``conv3.0``,
``conv4``), so reference ``.pth.tar`` weights load as they are.  Parameters
are float32; ``dtype`` is the compute type, and every rounding to it happens
where the JAX module rounds.

For training, ``Generator(plain_rdb=True)`` runs each RDB as ``rdb_plain``
(the packed math on stock, differentiable convolutions: the RDB kernel has
no backward), ``remat=True`` recomputes each RRDB in the backward pass
(``torch.utils.checkpoint``, the counterpart of flax's ``nn.remat``), and
``clamp``/``st_clamp`` choose the output the loss sees.

``TrunkFeatures`` taps the early trunk of a (frozen, trained) generator as
the stage-2 content loss's feature space where no VGG19 weights exist.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from real_esrgan_tpu_torch.ops.fused_rdb import (
    box_rdb_weights, fused_rdb, lrelu, pack_rdb_weights, rdb_plain, scalar_like,
    split_rdb_weights,
)


class _StClamp(torch.autograd.Function):
    """clamp(0, 1) with a straight-through gradient: the clamped value, and
    the incoming gradient passed on unchanged (``_st_clamp`` of the JAX
    generator, whose custom VJP returns ``g``).  A hard clamp's zero gradient
    outside [0, 1] can leave a saturated network with no gradient at all."""

    @staticmethod
    def forward(ctx, x):
        return x.clamp(0.0, 1.0)

    @staticmethod
    def backward(ctx, grad):
        return grad


def st_clamp(x: torch.Tensor) -> torch.Tensor:
    return _StClamp.apply(x)


def torch_conv_kernel_init(shape, generator: torch.Generator) -> torch.Tensor:
    """PyTorch's default Conv2d init, kaiming_uniform(a=sqrt(5)), on OIHW."""
    bound = math.sqrt(1.0 / (shape[1] * shape[2] * shape[3]))
    return (torch.rand(shape, generator=generator) * 2 - 1) * bound


def torch_conv_bias_init(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan_in)
    return (torch.rand(shape, generator=generator) * 2 - 1) * bound


def rdb_kernel_init(shape, generator: torch.Generator) -> torch.Tensor:
    """Reference RDB init: kaiming_normal (fan_in mode) * 0.1, on OIHW."""
    std = math.sqrt(2.0 / (shape[1] * shape[2] * shape[3]))
    return torch.randn(shape, generator=generator) * std * 0.1


def pixel_unshuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """NHWC space-to-depth, channel index c * r^2 + dy * r + dx."""
    if factor == 1:
        return x
    b, h, w, c = x.shape
    r = factor
    x = x.reshape(b, h // r, r, w // r, r, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // r, w // r, c * r * r)


@torch.no_grad()
def init_generator_convs(model: nn.Module, generator: torch.Generator) -> None:
    """JAX init: RDB convs kaiming_normal * 0.1 with zero bias; every other
    conv PyTorch's default uniform init."""
    for name, conv in model.named_modules():
        if not isinstance(conv, Conv3x3):
            continue
        shape = conv.weight.shape
        if ".rdb" in name:
            conv.weight.copy_(rdb_kernel_init(shape, generator))
            conv.bias.zero_()
        else:
            conv.weight.copy_(torch_conv_kernel_init(shape, generator))
            conv.bias.copy_(torch_conv_bias_init(conv.bias.shape, 9 * shape[1], generator))


class Conv3x3(nn.Module):
    """3x3 'same' conv holding float32 OIHW ``weight`` and ``bias``.

    As flax's ``nn.Conv`` does, it convolves in the input's dtype and adds
    the bias afterwards, rounded to that dtype."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 3, device=device))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight.to(x.dtype), padding=1)
        return y + self.bias.to(x.dtype)[:, None, None]


# Tap-transfer matrices of the subpixel upconv: row r of the low-res kernel
# collects the high-res taps dy whose upsampled source row (2i + a + dy) // 2
# equals i + r - 1, for output sub-position a in {0, 1}.
_SUBPIX_T = (
    ((1., 0., 0.), (0., 1., 1.), (0., 0., 0.)),  # a = 0
    ((0., 0., 0.), (1., 1., 0.), (0., 0., 1.)),  # a = 1
)


def _subpixel_upconv(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """nearest-x2-upsample -> 3x3 conv -> LeakyReLU, as one low-res conv with
    a folded (4*Cout, Cin, 3, 3) kernel (output order (a, b, o)) and a pixel
    shuffle, exactly as the JAX ``_subpixel_upconv`` computes it."""
    cout = weight.shape[0]
    hwio = weight.permute(2, 3, 1, 0)
    t = [torch.tensor(m, dtype=weight.dtype, device=weight.device) for m in _SUBPIX_T]
    w4 = torch.cat([torch.einsum("ru,uvio,cv->rcio", ta, hwio, tb)
                    for ta in t for tb in t], dim=-1)
    y = F.conv2d(x, w4.permute(3, 2, 0, 1).to(x.dtype), padding=1)
    y = lrelu(y + bias.repeat(4).to(x.dtype)[:, None, None])
    n, _, h, w = y.shape
    y = y.reshape(n, 2, 2, cout, h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(n, cout, 2 * h, 2 * w).contiguous(memory_format=torch.channels_last)


class ResidualDenseBlock(nn.Module):
    """5-conv dense block with a 0.2-scaled residual, on NCHW channels_last.

    ``packed=True`` runs the fused kernel (``ops.fused_rdb``: on a GPU the
    CUDA kernel on the tensor cores, bfloat16 by TMA and wgmma from weight
    boxes laid out once a pack, float32 by mma.sync as three bfloat16
    products of weights split once a pack; on the CPU its plain version);
    with ``plain=True`` as well it runs that plain version, ``rdb_plain``,
    on every device: the same packed math on stock convolutions, which
    autograd differentiates (the kernel has no backward), for training.
    ``packed=False`` runs the five concat convs as written in the
    reference."""

    def __init__(self, channels: int = 64, growth: int = 32, packed: bool = True,
                 device=None, plain: bool = False):
        super().__init__()
        self.channels, self.growth, self.packed, self.plain = channels, growth, packed, plain
        for k in range(5):
            out = growth if k < 4 else channels
            setattr(self, f"conv{k + 1}", Conv3x3(channels + k * growth, out, device))
        self._packed_key, self._packed, self._split, self._boxes = None, None, None, None

    def convs(self):
        return [getattr(self, f"conv{k}") for k in range(1, 6)]

    def packed_weights(self, dtype: torch.dtype):
        """``pack_rdb_weights`` of the five convs in ``dtype``.  Packed once and
        reused while every parameter keeps its storage and its version counter
        (``load_state_dict``, ``.to`` and in-place updates all change one).
        With autograd on, it packs anew on every call and keeps nothing, so
        gradients reach the parameters."""
        convs = self.convs()
        params = [t for c in convs for t in (c.weight, c.bias)]
        pack = lambda: pack_rdb_weights([c.weight for c in convs],  # noqa: E731
                                        [c.bias for c in convs],
                                        self.channels, self.growth, dtype)
        if torch.is_grad_enabled():
            return pack()
        key = (dtype,) + tuple((p.device, p.data_ptr(), p._version) for p in params)
        if key != self._packed_key:
            self._packed_key, self._packed, self._split, self._boxes = key, pack(), None, None
        return self._packed

    def split_weights(self, packed):
        """``split_rdb_weights`` of ``packed``, a float32 pack from
        ``packed_weights``, which the float32 kernel reads.  The split of the
        block's cached pack is made once and kept beside it; a new pack
        (another dtype, changed parameters) drops both together, so the split
        never outlives the weights it came from.  Any other pack is split
        anew."""
        if packed is not self._packed:
            return split_rdb_weights(packed)
        if self._split is None:
            self._split = split_rdb_weights(packed)
        return self._split

    def box_weights(self, packed):
        """``box_rdb_weights`` of ``packed``, a bfloat16 pack from
        ``packed_weights``, which the bfloat16 kernel reads: kept beside the
        block's cached pack and dropped with it, as ``split_weights``.  Any
        other pack is laid out anew."""
        if packed is not self._packed:
            return box_rdb_weights(packed)
        if self._boxes is None:
            self._boxes = box_rdb_weights(packed)
        return self._boxes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.packed and self.plain:
            out = rdb_plain(x.permute(0, 2, 3, 1), self.packed_weights(x.dtype))
            return out.permute(0, 3, 1, 2)
        if self.packed:
            packed = self.packed_weights(x.dtype)
            split = self.split_weights(packed) if x.is_cuda and x.dtype == torch.float32 else None
            boxes = self.box_weights(packed) if x.is_cuda and x.dtype == torch.bfloat16 else None
            y = fused_rdb(x.permute(0, 2, 3, 1).contiguous(), packed, split, boxes)
            return y.permute(0, 3, 1, 2)
        o1 = lrelu(self.conv1(x))
        o2 = lrelu(self.conv2(torch.cat([x, o1], 1)))
        o3 = lrelu(self.conv3(torch.cat([x, o1, o2], 1)))
        o4 = lrelu(self.conv4(torch.cat([x, o1, o2, o3], 1)))
        o5 = self.conv5(torch.cat([x, o1, o2, o3, o4], 1))
        return o5 * scalar_like(0.2, o5) + x


class RRDB(nn.Module):
    """Residual-in-residual dense block."""

    def __init__(self, channels: int = 64, growth: int = 32, packed: bool = True,
                 device=None, plain: bool = False):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(channels, growth, packed, device, plain)
        self.rdb2 = ResidualDenseBlock(channels, growth, packed, device, plain)
        self.rdb3 = ResidualDenseBlock(channels, growth, packed, device, plain)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.rdb3(self.rdb2(self.rdb1(x)))
        return out * scalar_like(0.2, out) + x


class TrunkFeatures(nn.Module):
    """Perceptual feature taps of a frozen stage-1 generator trunk: the port
    of the JAX ``TrunkFeatures``.

    Tap 0 is the conv1 output, tap t >= 1 the output of RRDB t-1; the
    parameter names are the generator's (``conv1``, ``trunk.{i}``), so
    ``trunk_feature_params`` takes them from a generator state_dict.  The
    input is NHWC in [0, 1], not ImageNet-normalized (``imagenet_input``);
    at x4 the trunk runs at the input's resolution, so the taps stay
    shallow.  The RRDBs run the plain packed math (``rdb_plain``): the
    content loss needs gradients through them, and the RDB kernel has none.
    ``forward`` returns the taps as float32 NCHW tensors."""

    imagenet_input = False

    def __init__(self, taps: Sequence[int] = (0, 1, 2), upscale_factor: int = 4,
                 channels: int = 64, growth: int = 32, dtype: torch.dtype = torch.float32,
                 in_channels: int = 3, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.taps, self.dtype = tuple(taps), dtype
        self.unshuffle = {1: 4, 2: 2}.get(upscale_factor, 1)
        self.conv1 = Conv3x3(in_channels * self.unshuffle ** 2, channels, device)
        self.trunk = nn.ModuleList(RRDB(channels, growth, True, device, plain=True)
                                   for _ in range(max(self.taps)))
        init_generator_convs(self, generator if generator is not None
                             else torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor):
        out = pixel_unshuffle(x, self.unshuffle).to(self.dtype)
        out = self.conv1(out.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
        feats = [out.float()] if 0 in self.taps else []
        for i, rrdb in enumerate(self.trunk):
            out = rrdb(out)
            if i + 1 in self.taps:
                feats.append(out.float())
        return feats


def trunk_feature_params(generator_params: Dict[str, torch.Tensor],
                         taps: Sequence[int]) -> Dict[str, torch.Tensor]:
    """The ``TrunkFeatures`` state_dict taken from a generator state_dict."""
    prefixes = ["conv1."] + [f"trunk.{i}." for i in range(max(taps))]
    missing = [p[:-1] for p in prefixes if not any(k.startswith(p) for k in generator_params)]
    if missing:
        raise KeyError(f"generator params lack trunk layers {missing}")
    return {k: v for k, v in generator_params.items() if any(k.startswith(p) for p in prefixes)}


class Generator(nn.Module):
    """Real-ESRGAN generator, NHWC in and out, values in [0, 1].

    ``clamp=False`` returns the raw pre-clamp output; with ``clamp`` the
    output is clamped to [0, 1], with a straight-through gradient when
    ``st_clamp`` (the JAX default) and the hard clamp's otherwise.
    ``plain_rdb`` runs the RDBs as ``rdb_plain`` (see ``ResidualDenseBlock``)
    and ``remat`` recomputes each RRDB in the backward pass; both are for
    training, and the trainer sets them when it builds its model.  Weights
    are drawn from ``generator`` (a ``torch.Generator``; seed 0 when None)
    with the JAX package's init functions."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 upscale_factor: int = 4, num_rrdb: int = 23, channels: int = 64,
                 growth: int = 32, dtype: torch.dtype = torch.float32,
                 packed: bool = True, clamp: bool = True, device=None,
                 generator: Optional[torch.Generator] = None, st_clamp: bool = True,
                 plain_rdb: bool = False, remat: bool = False):
        super().__init__()
        if upscale_factor not in (1, 2, 4):
            raise ValueError(f"upscale_factor must be 1, 2 or 4, not {upscale_factor}")
        self.upscale_factor = upscale_factor
        self.unshuffle = {1: 4, 2: 2}.get(upscale_factor, 1)
        self.dtype = dtype
        self.clamp, self.st_clamp, self.remat = clamp, st_clamp, remat
        self.conv1 = Conv3x3(in_channels * self.unshuffle ** 2, channels, device)
        self.trunk = nn.ModuleList(RRDB(channels, growth, packed, device, plain_rdb)
                                   for _ in range(num_rrdb))
        self.conv2 = Conv3x3(channels, channels, device)
        self.upsampling1 = nn.Sequential(Conv3x3(channels, channels, device))
        self.upsampling2 = nn.Sequential(Conv3x3(channels, channels, device))
        self.conv3 = nn.Sequential(Conv3x3(channels, channels, device))
        self.conv4 = Conv3x3(channels, out_channels, device)
        init_generator_convs(self, generator if generator is not None
                             else torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = pixel_unshuffle(x, self.unshuffle).to(self.dtype)
        out = out.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        out1 = self.conv1(out)
        out = out1
        for rrdb in self.trunk:
            if self.remat and torch.is_grad_enabled():
                out = checkpoint(rrdb, out, use_reentrant=False)
            else:
                out = rrdb(out)
        out = out1 + self.conv2(out)
        for up in (self.upsampling1, self.upsampling2):
            out = _subpixel_upconv(out, up[0].weight, up[0].bias)
        out = lrelu(self.conv3(out))
        out = self.conv4(out).float().permute(0, 2, 3, 1)
        if not self.clamp:
            return out
        return st_clamp(out) if self.st_clamp else out.clamp(0.0, 1.0)
