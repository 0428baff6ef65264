"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: each test skips without a CUDA device.  This file imports no
JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Bounds: f32 1e-4 (summation order only, TF32 off); bf16 atol/rtol 2e-2 (one
rounding to bf16 after an f32 sum taken in another order); the conv's copy
modes are exact.  The RDB kernel's bf16 shapes (output tile T=16) take ragged
edges, images narrower or shorter than a tile, a block whose last fragment is
clamped, and a batch of three.
"""

import os

import pytest
import torch

from real_esrgan_tpu_torch.models import Generator
from real_esrgan_tpu_torch.ops.conv3x3 import (
    built_conv3x3_plan, conv3x3, conv3x3_plain, conv3x3_plan,
)
from real_esrgan_tpu_torch.ops.fused_rdb import fused_rdb, pack_rdb_weights, rdb_plain
from real_esrgan_tpu_torch.ops.mm_probe import (
    built_mm_grid_plan, mm_grid, mm_grid_plain, mm_grid_plan, mm_resident, mm_resident_plain,
)
from real_esrgan_tpu_torch.train.checkpoint import load_generator_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RDB_TOLERANCE = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-2, 2e-2)}

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _packed(dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    kernels = [torch.randn(32 if k < 4 else 64, 64 + 32 * k, 3, 3, generator=g)
               * (2.0 / (9 * (64 + 32 * k))) ** 0.5 for k in range(5)]
    biases = [torch.randn(32 if k < 4 else 64, generator=g) * 0.1 for k in range(5)]
    return [t.to(device) for t in pack_rdb_weights(kernels, biases, 64, 32, dtype)]


@pytest.mark.parametrize("shape", [(1, 48, 64, 64), (2, 67, 93, 64), (1, 5, 3, 64),
                                   (3, 17, 40, 64), (1, 40, 7, 64), (1, 16, 16, 64)],
                         ids=["aligned", "ragged", "smaller_than_a_tile", "three_ragged",
                              "narrower_than_a_tile", "one_tile"])
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-4, 0.0),
                                             (torch.bfloat16, 2e-2, 2e-2)], ids=["f32", "bf16"])
def test_fused_rdb_kernel_matches_plain(cuda, shape, dtype, atol, rtol):
    packed = _packed(dtype, cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randn(shape, generator=g, device=cuda) * 0.5).to(dtype)
    before = fused_rdb.launches
    out = fused_rdb(x, packed)
    torch.cuda.synchronize()
    assert fused_rdb.launches == before + 1
    torch.testing.assert_close(out.float(), rdb_plain(x, packed).float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_rdb_kernel_matches_plain_with_trained_weights(cuda, dtype):
    state = load_generator_params(os.path.join(ROOT, "assets", "inenv10_esrnet_ema.npz"))
    convs = [(state[f"trunk.11.rdb2.conv{k}.weight"], state[f"trunk.11.rdb2.conv{k}.bias"])
             for k in range(1, 6)]
    packed = [t.to(cuda) for t in pack_rdb_weights([w for w, _ in convs], [b for _, b in convs],
                                                   64, 32, dtype)]
    g = torch.Generator(device=cuda).manual_seed(4)
    x = (torch.randn((2, 67, 93, 64), generator=g, device=cuda) * 0.5).to(dtype)
    atol, rtol = RDB_TOLERANCE[dtype]
    torch.testing.assert_close(fused_rdb(x, packed).float(), rdb_plain(x, packed).float(),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_rdb_counts_each_launch(cuda, dtype):
    packed = _packed(dtype, cuda)
    x = torch.zeros(2, 20, 24, 64, device=cuda, dtype=dtype)
    before = fused_rdb.launches
    fused_rdb(x, packed)
    fused_rdb(x, packed)
    torch.cuda.synchronize()
    assert fused_rdb.launches == before + 2
    rdb_plain(x, packed)
    assert fused_rdb.launches == before + 2


def test_fused_rdb_rejects_what_the_kernel_does_not_take(cuda):
    packed = _packed(torch.float32, cuda)
    x = torch.zeros(1, 16, 16, 64, device=cuda)
    with pytest.raises(ValueError):
        fused_rdb(x.transpose(1, 2), packed)  # not contiguous NHWC
    with pytest.raises(ValueError):
        fused_rdb(torch.zeros(1, 16, 16, 32, device=cuda), packed)
    with pytest.raises(ValueError):
        fused_rdb(x.bfloat16(), packed)  # weights in another dtype
    with pytest.raises(TypeError):
        fused_rdb(x.half(), packed)
    shifted = torch.empty(packed[1].numel() + 1, device=cuda)[1:].view(packed[1].shape)
    shifted.copy_(packed[1])
    with pytest.raises(ValueError, match="16-byte boundary"):
        fused_rdb(x, [packed[0], shifted] + packed[2:])  # weight off a 16-byte boundary


def test_fused_rdb_raises_under_autograd(cuda):
    """The kernel has no backward: with autograd on, an input or a packed
    tensor that requires grad raises, and a Generator(packed=True) forward
    with grad on (its packed weights require grad) raises too, instead of
    giving the trunk's parameters no gradient."""
    packed = _packed(torch.float32, cuda)
    x = torch.zeros(1, 16, 16, 64, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_rdb(x.clone().requires_grad_(), packed)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_rdb(x, [packed[0].clone().requires_grad_()] + packed[1:])
    model = Generator(num_rrdb=1, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        model(torch.rand(1, 16, 16, 3, device=cuda))
    with torch.no_grad():
        assert fused_rdb(x.clone().requires_grad_(), packed).shape == x.shape
        assert model(torch.rand(1, 16, 16, 3, device=cuda)).shape == (1, 64, 64, 3)


CONV_SHAPES = [((8, 256, 256, 64), 192, 32), ((2, 16, 32, 32), 96, 8), ((1, 64, 48, 64), 64, 16),
               ((2, 64, 48, 32), 96, 16)]
CONV_IDS = ["tool_default", "small", "three_col_tiles", "cin32_w48"]


def _conv_operands(cuda, shape, cout):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.rand(shape, generator=g, device=cuda).to(torch.bfloat16)
    w = torch.randn(3, 3, shape[-1], cout, generator=g, device=cuda) * 0.05
    return x, w


@pytest.mark.parametrize("shape,cout,tile", CONV_SHAPES, ids=CONV_IDS)
def test_conv3x3_full_matches_plain(cuda, shape, cout, tile):
    x, w = _conv_operands(cuda, shape, cout)
    before = conv3x3.launches
    out = conv3x3(x, w, tile=tile)
    torch.cuda.synchronize()
    assert conv3x3.launches == before + 1
    torch.testing.assert_close(out.float(), conv3x3_plain(x, w).float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("mode", ["patch", "dma"])
@pytest.mark.parametrize("shape,cout,tile", CONV_SHAPES, ids=CONV_IDS)
def test_conv3x3_patch_and_dma_equal_plain(cuda, shape, cout, tile, mode):
    x, w = _conv_operands(cuda, shape, cout)
    out = conv3x3(x, w, tile=tile, mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(out, conv3x3_plain(x, w, mode))


@pytest.mark.parametrize("shape,cout,tile", CONV_SHAPES, ids=CONV_IDS)
def test_conv3x3_launches_at_its_plan(cuda, shape, cout, tile):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for count in (sms, 132):
        assert built_conv3x3_plan(*shape, cout, tile, count) == \
            conv3x3_plan(*shape, cout, tile, count)


def conv_one_hot_probe(shape, cout, tap, device):
    """An exact probe of conv3x3's window and weight layouts, (x, w): x
    coded by position (7 * flat index mod 61: integers bf16 holds exactly,
    a chunk of 8 channels or a pixel apart always differ) and w zero but
    for tap ``tap`` = (dy, dx), where output channel o takes input channel
    o % Cin scaled by 2^(o // Cin).  The output is then x shifted by the
    tap, exactly; a wrong swizzle, halo, tap or weight row shows as a
    permutation of the codes."""
    b, h, width, cin = shape
    x = (torch.arange(b * h * width * cin, device=device) * 7 % 61).reshape(shape)
    w = torch.zeros(3, 3, cin, cout, device=device)
    o = torch.arange(cout, device=device)
    w[tap // 3, tap % 3, o % cin, o] = 2.0 ** (o // cin).float()
    return x.to(torch.bfloat16), w


CONV_PROBE_SHAPES = [((1, 64, 48, 64), 64, 16), ((2, 16, 32, 32), 96, 8),
                     ((1, 16, 32, 64), 192, 8)]


@pytest.mark.parametrize("tap", range(9), ids=[f"tap{dy}{dx}" for dy in range(3) for dx in range(3)])
@pytest.mark.parametrize("shape,cout,tile", CONV_PROBE_SHAPES,
                         ids=["64to64", "cin32_to96", "64to192_two_slices"])
def test_conv3x3_one_hot_probes_are_exact(cuda, shape, cout, tile, tap):
    x, w = conv_one_hot_probe(shape, cout, tap, cuda)
    out = conv3x3(x, w, tile=tile)
    torch.cuda.synchronize()
    assert torch.equal(out, conv3x3_plain(x, w))


def test_conv3x3_dots_has_the_output_shape(cuda):
    x, w = _conv_operands(cuda, (2, 16, 32, 32), 96)
    out = conv3x3(x, w, tile=8, mode="dots")  # values undefined: the window is not staged
    torch.cuda.synchronize()
    assert out.shape == (2, 16, 32, 96) and out.dtype == torch.bfloat16


# between them these take every width the kernels are built for
MM_SHAPES = [(8192, 192, 192), (8192, 576, 192), (128, 96, 160), (256, 512, 512), (128, 64, 64)]


def _mm_operands(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(3)
    a = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
    b = (torch.randn(k, n, generator=g, device=cuda) * 0.05).to(torch.bfloat16)
    return a, b


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
def test_mm_grid_matches_plain(cuda, m, k, n):
    a, b = _mm_operands(cuda, m, k, n)
    before = mm_grid.launches
    out = mm_grid(a, b)
    torch.cuda.synchronize()
    assert mm_grid.launches == before + 1
    torch.testing.assert_close(out.float(), mm_grid_plain(a, b).float(), atol=2e-2, rtol=2e-2)


# mm_grid's edges: ragged k (a chunk of 32 past one of 64) with m = 64, one
# chunk shorter than a box (k = 16), n = 32 (a 64-wide block half past n),
# n = 160 (192-wide), n = 320 (two 256-wide column blocks, the second past n)
MM_GRID_RAGGED = [(64, 96, 192), (64, 16, 64), (128, 64, 32), (128, 96, 160), (128, 128, 320)]


@pytest.mark.parametrize("m,k,n", MM_GRID_RAGGED)
def test_mm_grid_ragged_matches_plain(cuda, m, k, n):
    a, b = _mm_operands(cuda, m, k, n)
    out = mm_grid(a, b)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), mm_grid_plain(a, b).float(), atol=2e-2, rtol=2e-2)


def one_hot_probes(device):
    """Two exact probes of mm_grid's operand layouts, (name, a, b): a = I with
    b coded by position (arange mod 251: integers bf16 holds exactly), so
    c = b; and b = three 64-column identities scaled by 1, 2, 4 with a coded
    by position, so c's column block j is 2^j a.  A wrong swizzle, LBO or SBO
    shows as a permutation of the codes, not as noise."""
    code = lambda r, c: (torch.arange(r * c, device=device) % 251).reshape(r, c)  # noqa: E731
    eye = torch.eye(64, device=device)
    scaled = torch.cat([eye * 2.0 ** j for j in range(3)], dim=1)
    return [("a_identity", eye, code(64, 192)), ("b_identity", code(128, 64), scaled)]


@pytest.mark.parametrize("probe", [0, 1], ids=["a_identity", "b_identity"])
def test_mm_grid_one_hot_probes_are_exact(cuda, probe):
    _, a, b = one_hot_probes(cuda)[probe]
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    out = mm_grid(a, b)
    torch.cuda.synchronize()
    assert torch.equal(out, mm_grid_plain(a, b))


@pytest.mark.parametrize("m,k,n", MM_SHAPES + MM_GRID_RAGGED)
def test_mm_grid_launches_at_its_plan(cuda, m, k, n):
    assert built_mm_grid_plan(m, k, n) == mm_grid_plan(m, k, n)


@pytest.mark.parametrize("reps", [1, 32])
@pytest.mark.parametrize("m,k,n", MM_SHAPES)
def test_mm_resident_matches_plain(cuda, m, k, n, reps):
    a, b = _mm_operands(cuda, m, k, n)
    before = mm_resident.launches
    out = mm_resident(a, b, reps=reps)
    torch.cuda.synchronize()
    assert mm_resident.launches == before + 1
    torch.testing.assert_close(out.float(), mm_resident_plain(a, b, reps).float(),
                               atol=2e-2, rtol=2e-2)


def test_conv_and_mm_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x, w = _conv_operands(cuda, (1, 16, 32, 32), 96)
    for bad_x, bad_w, tile, error in [
            (x.float(), w, 8, TypeError), (x, w.half(), 8, TypeError),
            (x, w, 12, ValueError), (x[:, :12], w, 8, ValueError),   # tile % 8, H % tile
            (x[:, :, :24].contiguous(), w, 8, ValueError),           # W % 16
            (x.transpose(1, 2), w, 8, ValueError),                   # not contiguous
            (x, w[..., :48].contiguous(), 8, ValueError),            # Cout % 32
            (x, w.cpu(), 8, ValueError)]:
        with pytest.raises(error):
            conv3x3(bad_x, bad_w, tile=tile)
    with pytest.raises(ValueError, match="patch"):
        conv3x3(x, torch.zeros(3, 3, 32, 128, device=cuda), tile=8, mode="patch")
    a, b = _mm_operands(cuda, 128, 96, 160)
    for fn in (mm_grid, mm_resident):
        with pytest.raises(TypeError):
            fn(a.float(), b.float())
        with pytest.raises(ValueError):
            fn(a[:100], b)                 # m % 64
        with pytest.raises(ValueError):
            fn(a.t().contiguous().t(), b)  # not row-major
        with pytest.raises(ValueError):
            fn(a, b[:, :150].contiguous())  # n % 32
    with pytest.raises(ValueError, match="acc32"):
        mm_grid(a, b, acc32=False)
    with pytest.raises(ValueError, match="shared memory"):
        mm_resident(torch.zeros(64, 4096, device=cuda, dtype=torch.bfloat16),
                    torch.zeros(4096, 32, device=cuda, dtype=torch.bfloat16))
