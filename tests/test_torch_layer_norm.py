"""SwinIR's LayerNorm (``ops/layer_norm.py``, ``csrc/layer_norm.cu``,
``models/swinir.py::LayerNorm``).

On the CPU: ``layer_norm_plain`` equals ``F.layer_norm`` in float32 and
bfloat16 at 240 and 60 channels for 0, 1 and an odd number of rows;
``layer_norm`` takes it there and launches nothing; the wrapper refuses what
the kernel does not take; the vector width follows the row and the pointers;
the module keeps SwinIR's state-dict names and runs the plain version on the
CPU, with and without autograd.

Marked ``cuda`` (each skips without a CUDA device; this file imports no
JAX, so on the card ``python -m pytest --noconftest -m cuda
tests/test_torch_layer_norm.py``): the kernel against ``layer_norm_plain``
at the batch cell's shape (16, 256, 256, 240), a few rows, 60 channels and
a row count that leaves the last warp part-empty, in float32 within 1e-5
and in bf16 within one bf16 ulp of each output beyond that; a tensor 2 bytes off a
16-byte boundary takes 2-byte copies and still matches; under autograd the
wrapper raises.  The SwinIR-L forward's 110 launches are counted in
``tests/test_torch_swinir.py``.
"""

import pytest
import torch
import torch.nn.functional as F

from _torch_card import cuda  # noqa: F401  (a fixture)
from real_esrgan_tpu_torch.models.swinir import LN_EPS, LayerNorm, SwinIR
from real_esrgan_tpu_torch.ops import layer_norm as ln

DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["f32", "bf16"]


def _inputs(shape, dtype, device="cpu", seed=0):
    """x drawn as a Swin block's residual stream is, N(0.3, 1.5^2) a channel
    with a per-row offset; weight N(1, 0.2^2) and bias N(0, 0.1^2), all in
    ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device=device) * 1.5 + 0.3
    x = x + torch.randn((*shape[:-1], 1), generator=gen, device=device)
    weight = 1.0 + 0.2 * torch.randn(c, generator=gen, device=device)
    bias = 0.1 * torch.randn(c, generator=gen, device=device)
    return x.to(dtype), weight.to(dtype), bias.to(dtype)


@pytest.mark.parametrize("rows", [0, 1, 37], ids=["rows0", "rows1", "rows37"])
@pytest.mark.parametrize("channels", [240, 60])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_plain_equals_f_layer_norm(dtype, channels, rows):
    x, weight, bias = _inputs((rows, channels), dtype)
    expected = F.layer_norm(x, (channels,), weight, bias, LN_EPS)
    out = ln.layer_norm_plain(x, weight, bias, LN_EPS)
    assert out.dtype == dtype and out.shape == (rows, channels)
    assert torch.equal(out, expected)


def test_layer_norm_on_the_cpu_is_the_plain_version_and_launches_nothing():
    x, weight, bias = _inputs((2, 8, 8, 60), torch.bfloat16)
    before = ln.layer_norm.launches
    assert torch.equal(ln.layer_norm(x, weight, bias, LN_EPS),
                       ln.layer_norm_plain(x, weight, bias, LN_EPS))
    assert ln.layer_norm.launches == before


REFUSALS = {
    "float16": (lambda x, w, b: (x.half(), w.half(), b.half()), TypeError, "float32 or bfloat16"),
    "weight_dtype": (lambda x, w, b: (x, w.float(), b), TypeError, "x's dtype"),
    "weight_width": (lambda x, w, b: (x, w[:59], b), ValueError, r"\(60,\)"),
    "weight_2d": (lambda x, w, b: (x, w[None], b), ValueError, r"\(60,\)"),
    "non_contiguous_rows": (lambda x, w, b: (torch.cat([x, x], 1)[:, :60], w, b), ValueError,
                            "contiguous"),
    "non_contiguous_channels": (lambda x, w, b: (x.t().contiguous().t(), w, b), ValueError,
                                "contiguous"),
    "weight_elsewhere": (lambda x, w, b: (x, w.to("meta"), b), ValueError, "weight on meta"),
    "too_wide": (lambda x, w, b: (x.repeat(1, 5), w.repeat(5), b.repeat(5)), ValueError,
                 "1 to 256 channels"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_layer_norm_refuses_what_the_kernel_does_not_take(case):
    change, error, match = REFUSALS[case]
    x, weight, bias = change(*_inputs((6, 60), torch.bfloat16))
    with pytest.raises(error, match=match):
        ln.layer_norm(x, weight, bias, LN_EPS)


@pytest.mark.parametrize("dtype,channels,offset,expected", [
    (torch.bfloat16, 240, 0, 16), (torch.bfloat16, 60, 0, 8), (torch.bfloat16, 62, 0, 4),
    (torch.bfloat16, 240, 1, 2), (torch.float32, 240, 0, 16), (torch.float32, 60, 0, 16),
    (torch.float32, 240, 1, 4), (torch.float32, 240, 2, 8)])
def test_vector_bytes_follow_the_row_and_the_pointers(dtype, channels, offset, expected):
    base = torch.empty(4 * channels + offset, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    x = base[offset:].view(4, channels)
    weight = torch.empty(channels, dtype=dtype)
    assert ln.vector_bytes(x, weight, weight) == expected


def test_layer_norm_keeps_swinir_state_dict_names():
    assert list(LayerNorm(60).state_dict()) == ["weight", "bias"]
    names = set(SwinIR(embed_dim=60, depths=(2,), num_heads=(2,), num_feat=16).state_dict())
    for name in ("patch_embed.norm", "layers.0.residual_group.blocks.0.norm1",
                 "layers.0.residual_group.blocks.1.norm2", "norm"):
        assert {f"{name}.weight", f"{name}.bias"} <= names


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_the_module_on_the_cpu_runs_the_plain_version(dtype):
    module = LayerNorm(60)
    with torch.no_grad():
        module.weight.copy_(torch.linspace(0.5, 1.5, 60))
        module.bias.copy_(torch.linspace(-0.1, 0.1, 60))
    x = _inputs((3, 5, 60), dtype)[0]
    expected = F.layer_norm(x, (60,), module.weight.to(dtype), module.bias.to(dtype), LN_EPS)
    before = ln.layer_norm.launches
    with torch.no_grad():
        assert torch.equal(module(x), expected)
    out = module(x.requires_grad_(True))
    out.float().sum().backward()
    assert torch.equal(out.detach(), expected) and x.grad is not None
    assert ln.layer_norm.launches == before


# ------------------------------------------------------------------ card ---

F32_BOUND = 1e-5


def _check_close(out, ref, dtype):
    """float32: within 1e-5 (outputs of magnitude up to ~6; the two take
    their sums in another order).  bf16: within one bf16 ulp of each output
    beyond that float32 bound, since both round their float32 result once
    and a result near zero, where gamma (x - mean) rstd and beta cancel,
    has ulps far below the float32 results' difference."""
    assert out.shape == ref.shape and out.dtype == ref.dtype == dtype
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= F32_BOUND
    else:
        # one ulp of a bf16 value in [2^(e-1), 2^e) is 2^(e-8)
        ulp = torch.ldexp(torch.ones_like(diff), torch.frexp(ref.float()).exponent - 8)
        assert bool((diff <= ulp + F32_BOUND).all()), float((diff - ulp).max())


# the batch cell's shape, a few rows, 60 channels, and 1,517 rows: an odd
# count, so the last warp's second row is empty and the grid's last block
# part-filled
KERNEL_SHAPES = [(16, 256, 256, 240), (3, 240), (5, 7, 60), (1, 37, 41, 240)]
KERNEL_IDS = ["cell", "few_rows", "c60", "odd_rows"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", KERNEL_SHAPES, ids=KERNEL_IDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_the_kernel_matches_plain(cuda, dtype, shape):
    x, weight, bias = _inputs(shape, dtype, cuda, seed=len(shape))
    before = ln.layer_norm.launches
    out = ln.layer_norm(x, weight, bias, LN_EPS)
    ref = ln.layer_norm_plain(x, weight, bias, LN_EPS)
    torch.cuda.synchronize()
    assert ln.layer_norm.launches == before + 1
    _check_close(out, ref, dtype)


@pytest.mark.cuda
def test_the_kernel_off_a_16_byte_boundary_matches_plain(cuda):
    x, weight, bias = _inputs((4, 32, 32, 240), torch.bfloat16, cuda)
    base = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    shifted = base[1:].view(x.shape)  # 2 bytes off: 2-byte copies
    shifted.copy_(x)
    assert ln.vector_bytes(shifted, weight, bias) == 2
    out = ln.layer_norm(shifted, weight, bias, LN_EPS)
    _check_close(out, ln.layer_norm_plain(x, weight, bias, LN_EPS), torch.bfloat16)


@pytest.mark.cuda
def test_the_kernel_refuses_autograd(cuda):
    x, weight, bias = _inputs((4, 240), torch.float32, cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        ln.layer_norm(x.requires_grad_(True), weight, bias, LN_EPS)
