"""Plain PyTorch reference of the RRDBNet generator of Real-ESRGAN (Wang et
al., arXiv:2107.10833; ``RRDBNet`` of xinntao/Real-ESRGAN and BasicSR), NHWC
in and out, values in [0, 1].

It is written from the published architecture and imports nothing of the
program: pixel-unshuffle for x2 and x1, ``conv_first``, ``num_block`` RRDBs of
three dense blocks (five 3x3 convs on the concatenation of the block input
and every earlier output, LeakyReLU(0.2) on the first four, the last scaled
by 0.2 and added to the input), the trunk conv plus the global residual, two
nearest x2 upsamplings each followed by a 3x3 conv and LeakyReLU, the
high-resolution conv with LeakyReLU, the last conv and the clamp.  Parameter
names are the program's state dict names (``conv1``, ``trunk.{i}.rdb{j}``,
``conv2``, ``upsampling{1,2}.0``, ``conv3.0``, ``conv4``).

``quant``, where given, is applied to every conv's input and weight: the
control (``calibrate.py``) passes a float8 round trip there.  Call
``plain_float32()`` first on a GPU, so that no product falls into TF32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def plain_float32() -> None:
    """float32 products in float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _conv(p: Dict[str, torch.Tensor], name: str, x: torch.Tensor, quant: Quant) -> torch.Tensor:
    w = p[f"{name}.weight"]
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.conv2d(x, w, p[f"{name}.bias"], padding=1)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def dense_block(p, prefix: str, x: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    feats = [x]
    for k in range(1, 6):
        y = _conv(p, f"{prefix}.conv{k}", torch.cat(feats, 1), quant)
        if k == 5:
            return y * 0.2 + x
        feats.append(_lrelu(y))


def rrdb(p, prefix: str, x: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    out = x
    for j in range(1, 4):
        out = dense_block(p, f"{prefix}.rdb{j}", out, quant)
    return out * 0.2 + x


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict, quant: Quant = None
            ) -> torch.Tensor:
    """(B, H, W, C) float32 in [0, 1] -> (B, sH, sW, C) float32 in [0, 1]."""
    r = {1: 4, 2: 2, 4: 1}[cfg["scale"]]
    h = x.permute(0, 3, 1, 2)
    if r > 1:
        h = F.pixel_unshuffle(h, r)
    fea = _conv(p, "conv1", h, quant)
    body = fea
    for i in range(cfg["num_block"]):
        body = rrdb(p, f"trunk.{i}", body, quant)
    fea = fea + _conv(p, "conv2", body, quant)
    for name in ("upsampling1.0", "upsampling2.0"):
        fea = _lrelu(_conv(p, name, F.interpolate(fea, scale_factor=2, mode="nearest"), quant))
    out = _conv(p, "conv4", _lrelu(_conv(p, "conv3.0", fea, quant)), quant)
    return out.permute(0, 2, 3, 1).clamp(0.0, 1.0)


@torch.no_grad()
def forward_in_blocks(p, x: torch.Tensor, cfg: dict, block: int, quant: Quant = None,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``forward`` of ``x`` a ``block`` of images at a time, so that the
    reference fits beside what the run keeps; ``dtype`` is the type of the
    weights and activations (each conv accumulates in float32 and rounds its
    output to it); the output is float32."""
    p = {k: v.to(dtype) for k, v in p.items()}
    return torch.cat([forward(p, x[i:i + block].to(dtype), cfg, quant).float()
                      for i in range(0, len(x), block)])
