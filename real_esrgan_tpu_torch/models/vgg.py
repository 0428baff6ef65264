"""VGG19 feature extractor and the perceptual content loss in PyTorch: the
port of real_esrgan_tpu/models/vgg.py.

VGG19 (configuration "E") defined by hand, NHWC in: 3x3 convs with bias and
ReLU, 2x2/2 max pools, run only to the deepest requested tap.  The default
taps are the reference's ``features.{2,7,16,25,34}``, the outputs of
conv1_2, conv2_2, conv3_4, conv4_4 and conv5_4, taken after the ReLU
(``post_activation=True``: the reference's in-place ReLU feeds its loss the
activated tensors); ``post_activation=False`` taps the conv outputs.
Parameters are float32 OIHW under the conv names (``conv1_1.weight``, ...);
``TORCHVISION_INDEX`` maps a torchvision ``vgg19`` state_dict's
``features.N`` onto them (``models/convert.py::vgg_state_from_torchvision``).
Without such a file the features are random (``--allow-random-vgg``).
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from real_esrgan_tpu_torch.models.rrdbnet import Conv3x3

# VGG19 configuration "E": (name, out_channels); "M" = 2x2/2 max pool
VGG19_LAYOUT: Tuple = (
    ("conv1_1", 64), ("conv1_2", 64), "M",
    ("conv2_1", 128), ("conv2_2", 128), "M",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256), "M",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512), "M",
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), ("conv5_4", 512), "M",
)

# torchvision features.N index -> conv name
TORCHVISION_INDEX = {
    0: "conv1_1", 2: "conv1_2", 5: "conv2_1", 7: "conv2_2",
    10: "conv3_1", 12: "conv3_2", 14: "conv3_3", 16: "conv3_4",
    19: "conv4_1", 21: "conv4_2", 23: "conv4_3", 25: "conv4_4",
    28: "conv5_1", 30: "conv5_2", 32: "conv5_3", 34: "conv5_4",
}

DEFAULT_NODES = ("conv1_2", "conv2_2", "conv3_4", "conv4_4", "conv5_4")

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_CONV_ORDER = [s[0] for s in VGG19_LAYOUT if s != "M"]


def layer_depth(name: str) -> int:
    return _CONV_ORDER.index(name)


@functools.lru_cache(maxsize=8)
def _imagenet_stats(dtype: torch.dtype, device: torch.device):
    """The mean and std on ``device``, copied there once: a copy from the
    host waits for the device's queue."""
    return (torch.tensor(IMAGENET_MEAN, dtype=dtype, device=device),
            torch.tensor(IMAGENET_STD, dtype=dtype, device=device))


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """NHWC images in [0, 1] to ImageNet statistics."""
    mean, std = _imagenet_stats(x.dtype, x.device)
    return (x - mean) / std


class VGG19Features(nn.Module):
    """``forward(x)``: NHWC images (ImageNet-normalized) -> the tapped
    features, float32 NCHW, in the order of ``nodes``.  Holds the convs up to
    the deepest tap only.  Random weights (flax's default init: truncated
    lecun normal, zero bias) come from ``generator`` (seed 0 when None)."""

    def __init__(self, nodes: Sequence[str] = DEFAULT_NODES, dtype: torch.dtype = torch.float32,
                 post_activation: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.nodes, self.dtype, self.post_activation = tuple(nodes), dtype, post_activation
        deepest = max(layer_depth(n) for n in self.nodes)
        self.layout, cin = [], 3
        for spec in VGG19_LAYOUT:
            self.layout.append(spec)
            if spec == "M":
                continue
            name, cout = spec
            setattr(self, name, Conv3x3(cin, cout, device))
            cin = cout
            if layer_depth(name) >= deepest:
                break
        self.reset_parameters(generator if generator is not None
                              else torch.Generator().manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for spec in self.layout:
            if spec == "M":
                continue
            conv = getattr(self, spec[0])
            shape = conv.weight.shape
            std = math.sqrt(1.0 / (shape[1] * shape[2] * shape[3])) / 0.87962566103423978
            w = torch.empty(shape)
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
            conv.weight.copy_(w * std)
            conv.bias.zero_()

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        taps = {}
        for spec in self.layout:
            if spec == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            name = spec[0]
            pre = getattr(self, name)(x)
            x = torch.relu(pre)
            if name in self.nodes:
                taps[name] = (x if self.post_activation else pre).float()
        return [taps[n] for n in self.nodes]


class ContentLoss:
    """Weighted multi-tap L1 perceptual loss over a frozen feature extractor:
    ``loss(sr, hr) -> (total, per-tap losses)`` on NHWC images in [0, 1],
    ``sum(weights * taps)`` as the JAX trainer sums it.  ``VGG19Features``
    takes ImageNet-normalized input; a backbone whose ``imagenet_input`` is
    False (``TrunkFeatures``) takes the images as they are.  The HR features
    need no gradient and keep no graph."""

    def __init__(self, module: torch.nn.Module,
                 weights: Sequence[float] = (0.1, 0.1, 1.0, 1.0, 1.0)):
        self.module, self.weights = module, tuple(weights)
        self.norm = normalize_imagenet if getattr(module, "imagenet_input", True) \
            else (lambda x: x)
        self._on_device = {}

    def __call__(self, sr: torch.Tensor, hr: torch.Tensor):
        sr_f = self.module(self.norm(sr))
        with torch.no_grad():
            hr_f = self.module(self.norm(hr))
        taps = torch.stack([torch.mean(torch.abs(a - b)) for a, b in zip(sr_f, hr_f)])
        if taps.device not in self._on_device:  # a copy from the host waits for the device
            self._on_device[taps.device] = torch.tensor(self.weights, device=taps.device)
        return torch.sum(self._on_device[taps.device] * taps), taps
