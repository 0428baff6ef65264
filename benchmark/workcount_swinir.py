"""Closed-form work of SwinIR with the ``nearest+conv`` x4 tail at a
configuration's widths: the yardstick of the SwinIR cell's FLOP- and
byte-based metrics.  It counts the linears, convolutions and the window
attention's two products as the published architecture writes them (two
operations a multiply-add; biases, normalisation, activations, softmax and
residual adds are not counted), so no change to how the program computes a
layer moves it.

At SwinIR-L's widths (240 features, 9 x 6 Swin blocks, 8 heads of 30, window
8, MLP 480, 3conv, 64 tail features) a Swin block costs 983,040 FLOP a
low-resolution pixel (921,600 in its linears, 61,440 in attention) and the
whole forward 61,339,104: 3.8337e12 FLOP an output megapixel.  Window
attention moves 1,920 bytes a token in bf16 (q, k and v read once, the
output written once).
"""

from __future__ import annotations

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def conv_flop(cin: int, cout: int, k: int = 3) -> int:
    """FLOP of one k x k conv a pixel of its output."""
    return 2 * k * k * cin * cout


def swin_linear_flop(cfg: dict) -> int:
    """FLOP of a Swin block's qkv, proj, fc1 and fc2 a token."""
    c = cfg["embed_dim"]
    hidden = int(c * cfg["mlp_ratio"])
    return 2 * c * 3 * c + 2 * c * c + 2 * 2 * c * hidden


def window_attn_flop_per_token(cfg: dict) -> int:
    """FLOP of q k^T and p v a token, over all heads: each query meets the
    window's window^2 keys in every head dim."""
    return 2 * 2 * cfg["window_size"] ** 2 * cfg["embed_dim"]


def swin_block_flop(cfg: dict) -> int:
    return swin_linear_flop(cfg) + window_attn_flop_per_token(cfg)


def three_conv_flop(cfg: dict) -> int:
    c = cfg["embed_dim"]
    return conv_flop(c, c // 4) + conv_flop(c // 4, c // 4, 1) + conv_flop(c // 4, c)


def forward_flop_per_lr_pixel(cfg: dict) -> float:
    """Model FLOP of one forward a pixel of the input (the padded input where
    a side is not a multiple of the window)."""
    c, f, ch = cfg["embed_dim"], cfg["num_feat"], cfg["in_chans"]
    flop = conv_flop(ch, c)                                          # conv_first
    flop += sum(cfg["depths"]) * swin_block_flop(cfg)
    flop += (len(cfg["depths"]) + 1) * three_conv_flop(cfg)         # RSTBs', conv_after_body
    flop += conv_flop(c, f)                                          # conv_before_upsample
    flop += 4 * conv_flop(f, f) + 16 * conv_flop(f, f)               # conv_up1 at x2, up2 at x4
    flop += 16 * conv_flop(f, f) + 16 * conv_flop(f, ch)             # conv_hr, conv_last
    return flop


def forward_flop(cfg: dict, batch: int, height: int, width: int) -> float:
    """Model FLOP of one forward of a (batch, height, width) input, its
    sides multiples of the window."""
    return forward_flop_per_lr_pixel(cfg) * batch * height * width


def flop_per_output_mp(cfg: dict) -> float:
    return forward_flop_per_lr_pixel(cfg) * 1e6 / cfg["upscale"] ** 2


def window_attn_bytes(cfg: dict, tokens: int) -> int:
    """Bytes one window-attention call must move: q, k and v read once and
    the output written once (the bias table's few kilobytes not counted)."""
    return 4 * cfg["embed_dim"] * DTYPE_BYTES[cfg["dtype"]] * tokens


def window_attn_least_seconds(cfg: dict, tokens: int, peaks: dict) -> float:
    """The least time one window-attention call over ``tokens`` tokens can
    take on a chip of ``peaks``: the larger of its FLOP over the dtype's peak
    and its bytes over the memory bandwidth."""
    flop = window_attn_flop_per_token(cfg) * tokens
    return max(flop / peaks["flops"][cfg["dtype"]],
               window_attn_bytes(cfg, tokens) / peaks["bytes_per_s"])
