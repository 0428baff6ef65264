"""The generator tail's epilogue (``ops/tail_epilogue.py``): bias, LeakyReLU
and the x2 pixel shuffle after each folded upconv and after ``conv3``.

On the CPU: ``bias_lrelu_plain`` equals the model's composition as it was
written before the kernel, bit for bit (negative zeros and bfloat16 ties
included), ``bias_lrelu`` takes it there and launches nothing, the wrapper
refuses what the kernel does not take, and the CPU generator keeps its
``conv3`` module call.

Marked ``cuda`` (each skips without a CUDA device; this file imports no
JAX, so on the card ``python -m pytest --noconftest -m cuda
tests/test_torch_tail_epilogue.py``): the kernel equals the plain version
bit for bit at the batch cell's shapes, at batch 1 with odd sides, on the
one-element path, and at a tile batch of 8 x 528^2, whose 2.28e9 elements
need 64-bit offsets; a generator forward under ``no_grad`` (the kernel)
equals the same module's under autograd (the plain ops) bit for bit, with
3 launches a forward under ``no_grad`` and none under autograd; and
``tools.nan_probe.capture_outputs`` still records ``conv3``'s output there.
"""

import pytest
import torch

from _torch_card import cuda  # noqa: F401  (a fixture)
from real_esrgan_tpu_torch.models import Generator
from real_esrgan_tpu_torch.ops import tail_epilogue
from real_esrgan_tpu_torch.ops.tail_epilogue import MAX_ROW_ELEMENTS, bias_lrelu, bias_lrelu_plain

DTYPES = [torch.bfloat16, torch.float32]
DTYPE_IDS = ["bf16", "f32"]
# y values the sums and the slope's product round at: signed zeros, 1 and
# 1 + 2^-7 (with a bias of 2^-8 their sums lie exactly halfway between two
# bfloat16 values), and neighbours of both signs
SPECIAL_Y = [-0.0, 0.0, 1.0, -1.0, 1.0 + 2 ** -7, -(1.0 + 2 ** -7), 3.0 * 2 ** -9,
             -3.0 * 2 ** -9, 255.0, -255.0]
# biases of the first channels: the tie-maker 2^-8 of both signs, signed
# zeros, and bfloat16 neighbours just above and below it
SPECIAL_BIAS = [2 ** -8, -2 ** -8, 0.0, -0.0, 2 ** -8 + 2 ** -15, 2 ** -8 - 2 ** -16]


def _inputs(n, c, h, w, shuffle, dtype, device, seed=0):
    """A channels_last y (n, G c, h, w) drawn from N(0, 2^2) with
    ``SPECIAL_Y`` spread through it, and a float32 bias of c from N(0,
    0.1^2) led by ``SPECIAL_BIAS``."""
    groups = 4 if shuffle else 1
    gen = torch.Generator(device=device).manual_seed(seed)
    y = torch.empty((n, h, w, groups * c), dtype=dtype, device=device).normal_(0.0, 2.0,
                                                                              generator=gen)
    flat = y.view(-1)
    for i, v in enumerate(SPECIAL_Y):
        flat[i::97] = v
    bias = torch.empty(c, device=device).normal_(0.0, 0.1, generator=gen)
    k = min(c, len(SPECIAL_BIAS))
    bias[:k] = torch.tensor(SPECIAL_BIAS[:k], device=device)
    return y.permute(0, 3, 1, 2), bias


def _composition_as_it_was(y, bias, shuffle):
    """The model's tail ops as ``models/rrdbnet.py`` wrote them before the
    kernel: ``Conv3x3``'s bias add and ``lrelu`` for conv3;
    ``_subpixel_upconv``'s bias add, ``lrelu``, reshape, permute and copy
    back to channels_last for an upconv."""
    def lrelu(x):
        return torch.where(x >= 0, x, x * torch.full((), 0.2, dtype=x.dtype, device=x.device))

    if not shuffle:
        return lrelu(y + bias.to(y.dtype)[:, None, None])
    cout = bias.shape[0]
    y = lrelu(y + bias.repeat(4).to(y.dtype)[:, None, None])
    n, _, h, w = y.shape
    y = y.reshape(n, 2, 2, cout, h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(n, cout, 2 * h, 2 * w).contiguous(memory_format=torch.channels_last)


def _assert_same_bits(ours, ref):
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    assert ours.stride() == ref.stride()
    bits = torch.int16 if ref.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(ours.view(bits), ref.view(bits))


@pytest.mark.parametrize("c", [64, 16])
@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffle", "in_place"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_plain_equals_the_composition_as_it_was(dtype, shuffle, c):
    y, bias = _inputs(2, c, 6, 10, shuffle, dtype, "cpu")
    out = bias_lrelu_plain(y, bias, shuffle)
    _assert_same_bits(out, _composition_as_it_was(y, bias, shuffle))
    assert out.is_contiguous(memory_format=torch.channels_last)
    # the specials reached the output: a tie rounded to even, a negative zero kept
    if dtype == torch.bfloat16 and not shuffle:
        ties = y[:, 0] == 1.0  # + 2^-8 is halfway between 1 and 1 + 2^-7
        assert ties.any() and out[:, 0][ties].eq(1.0).all()
    assert (torch.signbit(out) & (out == 0)).any()


def test_bias_lrelu_on_the_cpu_is_the_plain_version_and_launches_nothing():
    y, bias = _inputs(1, 16, 5, 7, True, torch.bfloat16, "cpu")
    before = bias_lrelu.launches
    out = bias_lrelu(y, bias, shuffle=True)
    _assert_same_bits(out, bias_lrelu_plain(y, bias, True))
    assert bias_lrelu.launches == before


@pytest.mark.parametrize("case,error,match", [
    ("half", TypeError, "float32 or bfloat16"),
    ("bf16_bias", TypeError, "float32 bias"),
    ("channels", ValueError, "takes y"),
    ("nchw", ValueError, "channels_last"),
    ("row", ValueError, "rows of W x channels"),
    ("meta", ValueError, "runs on cpu or cuda"),
])
def test_bias_lrelu_refuses_what_the_kernel_does_not_take(case, error, match):
    y, bias = _inputs(1, 8, 4, 6, True, torch.float32, "cpu")
    shuffle = True
    if case == "half":
        y = y.half()
    elif case == "bf16_bias":
        bias = bias.bfloat16()
    elif case == "channels":
        bias = bias[:6]
    elif case == "nchw":
        y = y.contiguous()
    elif case == "row":
        y = torch.empty((1, 4, 1, MAX_ROW_ELEMENTS // 4), device="meta").to(
            memory_format=torch.channels_last)
        bias, shuffle = torch.empty(4, device="meta"), False
    else:
        y, bias = y.to("meta"), bias.to("meta")
    with pytest.raises(error, match=match):
        bias_lrelu(y, bias, shuffle)


def test_the_generator_on_the_cpu_runs_conv3_as_a_module_and_no_kernel():
    model = Generator(num_rrdb=1, channels=16, growth=8).eval()
    seen = []
    model.conv3.register_forward_hook(lambda *_: seen.append(True))
    before = bias_lrelu.launches
    with torch.no_grad():
        model(torch.rand(1, 8, 12, 3))
    assert seen == [True] and bias_lrelu.launches == before


# (n, c, h, w, shuffle): the batch cell's three launches (upconv1, upconv2,
# conv3 of 16 x 256^2 in), batch 1 with odd sides, channel runs of 16, 12
# and 6 (12 x 2 and 6 x 4 bytes take the one-element path)
KERNEL_SHAPES = [
    (16, 64, 256, 256, True), (16, 64, 512, 512, True), (16, 64, 1024, 1024, False),
    (1, 64, 37, 53, True), (1, 64, 37, 53, False), (3, 16, 9, 31, True), (2, 12, 7, 5, True),
    (2, 6, 11, 3, False),
]
KERNEL_IDS = ["upconv1", "upconv2", "conv3", "odd_shuffle", "odd_in_place", "c16", "c12", "c6"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", KERNEL_SHAPES, ids=KERNEL_IDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_the_kernel_equals_plain_bit_for_bit(cuda, dtype, shape):
    n, c, h, w, shuffle = shape
    y, bias = _inputs(n, c, h, w, shuffle, dtype, cuda, seed=n + c + h)
    ref = bias_lrelu_plain(y, bias, shuffle)
    before = bias_lrelu.launches
    out = bias_lrelu(y.clone(memory_format=torch.channels_last), bias, shuffle)
    torch.cuda.synchronize()
    assert bias_lrelu.launches == before + 1
    _assert_same_bits(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_the_kernel_off_a_16_byte_boundary_equals_plain(cuda, dtype):
    """An input one element into its storage takes the one-element path."""
    y, bias = _inputs(2, 64, 9, 14, True, dtype, cuda)
    base = torch.empty(y.numel() + 1, dtype=dtype, device=cuda)
    shifted = base[1:].view(2, 9, 14, 256).permute(0, 3, 1, 2)
    shifted.copy_(y)
    assert not tail_epilogue.vectorised(shifted, shifted, 64)
    _assert_same_bits(bias_lrelu(shifted, bias, True), bias_lrelu_plain(y, bias, True))


@pytest.mark.cuda
@pytest.mark.parametrize("shuffle", [True, False], ids=["upconv2", "conv3"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_the_kernel_past_int32_offsets_equals_plain(cuda, dtype, shuffle):
    """A tile batch of 8 x 528^2: upconv2's (8, 256, 1056^2) and conv3's
    (8, 64, 2112^2) hold 2.28e9 elements each, past int32.  The plain
    version runs an image at a time to bound the memory."""
    side = 1056 if shuffle else 2112
    y, bias = _inputs(8, 64, side, side, shuffle, dtype, cuda, seed=5)
    assert y.numel() > 2 ** 31
    out = bias_lrelu(y.clone(memory_format=torch.channels_last), bias, shuffle)
    for i in range(8):
        _assert_same_bits(out[i:i + 1], bias_lrelu_plain(y[i:i + 1], bias, shuffle))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_a_generator_forward_launches_three_and_keeps_the_bits_of_autograd(cuda, dtype):
    """The trainers' model (``plain_rdb``): under ``no_grad`` the tail runs
    the kernel, under autograd with parameters requiring grad the plain
    ops; the outputs are equal bit for bit."""
    model = Generator(num_rrdb=1, dtype=dtype, plain_rdb=True, device=cuda)
    x = torch.rand(2, 24, 40, 3, generator=torch.Generator().manual_seed(1)).to(cuda)
    before = bias_lrelu.launches
    with torch.no_grad():
        fused = model(x)
        model(x)
    assert bias_lrelu.launches == before + 6
    assert all(p.requires_grad for p in model.parameters())
    with torch.enable_grad():
        plain = model(x)
    assert plain.requires_grad and bias_lrelu.launches == before + 6
    _assert_same_bits(fused, plain.detach())


@pytest.mark.cuda
def test_a_batch_of_one_from_numpy_takes_the_kernel(cuda):
    """``SRPipeline.upscale`` and the trainer's validation make a batch of
    one with NumPy's ``[None]``, whose batch stride is 0, so the first
    upconv's conv returns NCHW: the model hands the kernel channels_last and
    keeps the plain ops' bits.  The kernel has no backward: an input or a
    bias that requires grad raises with autograd on and launches once under
    ``no_grad``."""
    import numpy as np

    model = Generator(num_rrdb=1, dtype=torch.bfloat16, plain_rdb=True, device=cuda)
    image = np.random.default_rng(3).random((20, 28, 3)).astype(np.float32)
    x = torch.from_numpy(np.ascontiguousarray(image[None])).to(cuda)
    assert x.stride()[0] == 0
    before = bias_lrelu.launches
    with torch.no_grad():
        fused = model(x)
    assert bias_lrelu.launches == before + 3
    with torch.enable_grad():
        _assert_same_bits(fused, model(x).detach())
    y, bias = _inputs(1, 16, 4, 6, True, torch.float32, cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        bias_lrelu(y.clone().requires_grad_(), bias, True)
    before = bias_lrelu.launches
    with torch.no_grad():
        bias_lrelu(y.clone().requires_grad_(), bias, True)
    assert bias_lrelu.launches == before + 1
    with pytest.raises(RuntimeError, match="no backward"):
        bias_lrelu(y, bias.requires_grad_(), True)


@pytest.mark.cuda
def test_capture_outputs_on_the_card_records_every_module_the_cpu_does(cuda):
    """``tools.nan_probe.capture_outputs`` records every submodule's output,
    ``conv3`` and ``conv3.0`` included, on the card as on the CPU, where
    under ``no_grad`` the tail kernel would take ``conv3``'s place; and it
    launches no tail kernel."""
    from real_esrgan_tpu_torch.tools.nan_probe import capture_outputs

    model = Generator(num_rrdb=1, dtype=torch.bfloat16, plain_rdb=True, device=cuda)
    params = {k: v.detach() for k, v in model.named_parameters()}
    x = torch.rand(2, 16, 20, 3, generator=torch.Generator().manual_seed(2))
    before = bias_lrelu.launches
    out, outputs = capture_outputs(model, params, x.to(cuda))
    assert bias_lrelu.launches == before
    assert {"conv3", "conv3.0"} <= outputs.keys()
    cpu_model = Generator(num_rrdb=1, dtype=torch.bfloat16, plain_rdb=True)
    _, cpu_outputs = capture_outputs(cpu_model, {k: v.cpu() for k, v in params.items()}, x)
    assert list(outputs) == list(cpu_outputs)
    assert not out.requires_grad and not any(o.requires_grad for o in outputs.values())
