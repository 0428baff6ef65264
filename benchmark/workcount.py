"""Closed-form work of the RRDBNet generator at a configuration's widths:
the yardstick of every FLOP- and byte-based metric.  It counts the model's
convolutions as written in the published architecture (two operations a
multiply-add; biases, activations and residual adds are not counted), so no
change to how the program computes a layer moves it.

At 64 features, growth 32 and x4 a dense block costs 479,232 FLOP a
low-resolution pixel and the whole forward 35,853,696 (23 RRDBs) or
11,412,864 (6 RRDBs): 2.2409e12 and 7.1331e11 FLOP an output megapixel.
"""

from __future__ import annotations

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def conv3x3_flop(cin: int, cout: int) -> int:
    """FLOP of one 3x3 conv a pixel of its output."""
    return 2 * 9 * cin * cout


def dense_block_flop(cfg: dict) -> int:
    """FLOP of one dense block (five convs on the growing concatenation) a
    pixel of the trunk's resolution."""
    c, g = cfg["num_feat"], cfg["num_grow_ch"]
    return sum(conv3x3_flop(c + k * g, g if k < 4 else c) for k in range(5))


def dense_block_weight_elems(cfg: dict) -> int:
    """Weight elements of one dense block (half its FLOP a pixel)."""
    return dense_block_flop(cfg) // 2


def trunk_pixels(cfg: dict, lr_pixels: int) -> int:
    """Pixels at the trunk's resolution for ``lr_pixels`` input pixels: the
    x2 and x1 models pixel-unshuffle their input first."""
    r = {1: 4, 2: 2, 4: 1}[cfg["scale"]]
    return lr_pixels // (r * r)


def forward_flop_per_lr_pixel(cfg: dict) -> float:
    """Model FLOP of one forward a pixel of the input."""
    c = cfg["num_feat"]
    r = {1: 4, 2: 2, 4: 1}[cfg["scale"]]
    trunk = 1.0 / (r * r)  # trunk pixels an input pixel
    flop = trunk * conv3x3_flop(cfg["num_in_ch"] * r * r, c)
    flop += trunk * 3 * cfg["num_block"] * dense_block_flop(cfg)
    flop += trunk * conv3x3_flop(c, c)                     # trunk conv
    flop += 4 * trunk * conv3x3_flop(c, c)                 # first upsampling conv at x2
    flop += 16 * trunk * conv3x3_flop(c, c)                # second upsampling conv at x4
    flop += 16 * trunk * conv3x3_flop(c, c)                # high-resolution conv
    flop += 16 * trunk * conv3x3_flop(c, cfg["num_out_ch"])  # last conv
    return flop


def forward_flop(cfg: dict, batch: int, height: int, width: int) -> float:
    """Model FLOP of one forward of a (batch, height, width) input."""
    return forward_flop_per_lr_pixel(cfg) * batch * height * width


def flop_per_output_mp(cfg: dict) -> float:
    return forward_flop_per_lr_pixel(cfg) * 1e6 / cfg["scale"] ** 2


def dense_block_least_seconds(cfg: dict, trunk_px: int, peaks: dict) -> float:
    """The least time one dense block can take on a chip of ``peaks`` at
    ``trunk_px`` pixels: the larger of its operations over the peak rate of
    its dtype and its bytes over the memory bandwidth, counting the input
    and the output once each and the weights once (bias in float32)."""
    dtype = cfg["dtype"]
    act = DTYPE_BYTES[dtype]
    c = cfg["num_feat"]
    flop = dense_block_flop(cfg) * trunk_px
    nbytes = 2 * trunk_px * c * act + dense_block_weight_elems(cfg) * act + 5 * c * 4
    return max(flop / peaks["flops"][dtype], nbytes / peaks["bytes_per_s"])
