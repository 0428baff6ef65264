"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: each test skips without a CUDA device.  This file imports no
JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Bounds: f32 1e-4 (TF32 off; the RDB kernel's three bf16 products of split
operands and the order of its sums); bf16 atol/rtol 2e-2 (one rounding to
bf16 after an f32 sum taken in another order); the conv's copy modes are
exact.  The RDB kernel's shapes (output tile T=16 in bf16, T=8 in f32) take
ragged edges, images narrower or shorter than a tile, a block whose last
fragment or unit is clamped, and a batch of three; both dtypes also inputs
at the trunk's magnitude (|x| up to 60), where f32's split has the least
room and bf16's rounding the largest absolute steps.
"""

import math
import os

import pytest
import torch

from real_esrgan_tpu_torch.models import Generator
from real_esrgan_tpu_torch.models.rrdbnet import ResidualDenseBlock
from real_esrgan_tpu_torch.ops.conv3x3 import (
    built_conv3x3_plan, conv3x3, conv3x3_plain, conv3x3_plan,
)
from real_esrgan_tpu_torch.ops.fused_rdb import (
    BUILT_PLAN_KEYS, box_rdb_weights, built_rdb_plan, fused_rdb, pack_rdb_weights, rdb_plain,
    rdb_plan, split_bf16, split_rdb_weights,
)
from real_esrgan_tpu_torch.ops.mm_probe import (
    built_mm_grid_plan, built_mm_resident_plan, mm_grid, mm_grid_plain, mm_grid_plan, mm_resident,
    mm_resident_plain, mm_resident_plan,
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


def _trained_packed(dtype, device, name="trunk.11.rdb2"):
    state = load_generator_params(os.path.join(ROOT, "assets", "inenv10_esrnet_ema.npz"))
    convs = [(state[f"{name}.conv{k}.weight"], state[f"{name}.conv{k}.bias"]) for k in range(1, 6)]
    return [t.to(device) for t in pack_rdb_weights([w for w, _ in convs], [b for _, b in convs],
                                                   64, 32, dtype)]


def _trunk_input(shape, device, seed, peak=60.0):
    """N(0, 1) scaled so that its largest magnitude is ``peak``: the trunk's
    activations reach |x| = 57 in the full-depth generator on the test image."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device)
    return x * (peak / x.abs().max())


@pytest.mark.parametrize("name", ["trunk.0.rdb1", "trunk.11.rdb2", "trunk.22.rdb3"])
def test_fused_rdb_f32_matches_plain_at_trunk_magnitude(cuda, name):
    packed = _trained_packed(torch.float32, cuda, name)
    x = _trunk_input((2, 67, 93, 64), cuda, seed=6)
    out = fused_rdb(x, packed, split_rdb_weights(packed))
    torch.testing.assert_close(out, rdb_plain(x, packed), atol=1e-4, rtol=0)


# against the f32 kernel's tile of 8: smaller than a tile, three ragged
# images, widths and heights that are not multiples of 8, one tile exactly
@pytest.mark.parametrize("shape", [(1, 5, 3, 64), (3, 17, 40, 64), (1, 9, 13, 64), (2, 24, 21, 64),
                                   (1, 7, 33, 64), (1, 8, 8, 64)],
                         ids=["smaller_than_a_tile", "three_ragged", "9x13", "24x21", "7x33",
                              "one_tile"])
def test_fused_rdb_f32_ragged_against_its_tile(cuda, shape):
    assert rdb_plan(torch.float32)["tile"] == 8
    packed = _trained_packed(torch.float32, cuda)
    x = _trunk_input(shape, cuda, seed=7)
    before = fused_rdb.launches
    out = fused_rdb(x, packed, split_rdb_weights(packed))
    torch.cuda.synchronize()
    assert fused_rdb.launches == before + 1 and torch.isfinite(out).all()
    torch.testing.assert_close(out, rdb_plain(x, packed), atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_rdb_launches_at_its_plan(cuda, dtype):
    plan = rdb_plan(dtype)
    assert built_rdb_plan(dtype) == {key: plan[key] for key in BUILT_PLAN_KEYS}


# against the bf16 kernel's tile of 16: smaller than a tile, three ragged
# images, the golden crop's 67 x 93, widths that are not multiples of 16
@pytest.mark.parametrize("shape", [(1, 5, 3, 64), (3, 17, 40, 64), (1, 67, 93, 64), (1, 16, 24, 64),
                                   (2, 33, 50, 64), (1, 20, 7, 64), (1, 31, 130, 64)],
                         ids=["smaller_than_a_tile", "three_ragged", "67x93", "16x24", "33x50",
                              "20x7", "31x130"])
def test_fused_rdb_bf16_ragged_against_its_tile(cuda, shape):
    assert rdb_plan(torch.bfloat16)["tile"] == 16
    packed = _trained_packed(torch.bfloat16, cuda)
    g = torch.Generator(device=cuda).manual_seed(10)
    x = (torch.randn(shape, generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    before = fused_rdb.launches
    out = fused_rdb(x, packed, boxes=box_rdb_weights(packed))
    torch.cuda.synchronize()
    assert fused_rdb.launches == before + 1 and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), rdb_plain(x, packed).float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("name", ["trunk.0.rdb1", "trunk.11.rdb2", "trunk.22.rdb3"])
def test_fused_rdb_bf16_matches_plain_at_trunk_magnitude(cuda, name):
    packed = _trained_packed(torch.bfloat16, cuda, name)
    x = _trunk_input((2, 67, 93, 64), cuda, seed=11).to(torch.bfloat16)
    out = fused_rdb(x, packed, boxes=box_rdb_weights(packed))
    torch.testing.assert_close(out.float(), rdb_plain(x, packed).float(), atol=2e-2, rtol=2e-2)


def test_fused_rdb_bf16_counts_each_launch_with_its_boxes(cuda):
    packed = _trained_packed(torch.bfloat16, cuda)
    boxes = box_rdb_weights(packed)
    x = torch.zeros(1, 20, 24, 64, device=cuda, dtype=torch.bfloat16)
    before = fused_rdb.launches
    for _ in range(3):
        fused_rdb(x, packed, boxes=boxes)
    torch.cuda.synchronize()
    assert fused_rdb.launches == before + 3
    with pytest.raises(ValueError, match="only the bfloat16"):
        fused_rdb(x.float(), _trained_packed(torch.float32, cuda), boxes=boxes)
    with pytest.raises(ValueError, match="box_rdb_weights"):
        fused_rdb(x, packed, boxes=boxes[:-8])
    assert fused_rdb.launches == before + 3


def test_box_rdb_weights_on_the_card_equals_the_cpu(cuda):
    packed = _trained_packed(torch.bfloat16, "cpu")
    assert torch.equal(box_rdb_weights([t.to(cuda) for t in packed]).cpu(), box_rdb_weights(packed))


def test_fused_rdb_boxes_follow_load_state_dict(cuda):
    """The block's weight boxes are laid out from its current weights: after
    load_state_dict the bf16 kernel computes the new weights' RDB."""
    state = load_generator_params(os.path.join(ROOT, "assets", "inenv10_esrnet_ema.npz"))
    block = ResidualDenseBlock(64, 32, device=cuda).eval()
    x = _trunk_input((1, 30, 44, 64), cuda, seed=12).to(torch.bfloat16).permute(0, 3, 1, 2)
    seen = []
    for name in ("trunk.0.rdb1", "trunk.22.rdb3"):
        block.load_state_dict({k[len(name) + 1:]: v for k, v in state.items()
                               if k.startswith(name + ".")})
        with torch.no_grad():
            out = block(x)
            out_again = block(x)
            seen.append(block.box_weights(block.packed_weights(torch.bfloat16)))
        packed = _trained_packed(torch.bfloat16, cuda, name)
        assert torch.equal(seen[-1], box_rdb_weights(packed))
        ref = rdb_plain(x.permute(0, 2, 3, 1).contiguous(), packed)
        torch.testing.assert_close(out.permute(0, 2, 3, 1).float(), ref.float(), atol=2e-2,
                                   rtol=2e-2)
        assert torch.equal(out, out_again)
    assert seen[0] is not seen[1]


def test_split_bf16_on_the_card_equals_the_cpu(cuda):
    g = torch.Generator().manual_seed(8)
    t = torch.randn(1 << 16, generator=g) * torch.exp2(torch.randint(-30, 30, (1 << 16,), generator=g))
    for cpu_part, card_part in zip(split_bf16(t), split_bf16(t.to(cuda))):
        assert torch.equal(card_part.cpu(), cpu_part)
    packed = _trained_packed(torch.float32, "cpu")
    on_card = split_rdb_weights([w.to(cuda) for w in packed])
    for cpu_part, card_part in zip(split_rdb_weights(packed), on_card):
        assert all(torch.equal(c.cpu(), p) for p, c in zip(cpu_part, card_part))


def test_fused_rdb_split_follows_load_state_dict(cuda):
    """The block's split is cut from its current weights: after
    load_state_dict the f32 kernel computes the new weights' RDB."""
    state = load_generator_params(os.path.join(ROOT, "assets", "inenv10_esrnet_ema.npz"))
    block = ResidualDenseBlock(64, 32, device=cuda).eval()
    x = _trunk_input((1, 30, 44, 64), cuda, seed=9).permute(0, 3, 1, 2)
    for name in ("trunk.0.rdb1", "trunk.22.rdb3"):
        block.load_state_dict({k[len(name) + 1:]: v for k, v in state.items()
                               if k.startswith(name + ".")})
        with torch.no_grad():
            out = block(x)
            out_again = block(x)
        ref = rdb_plain(x.permute(0, 2, 3, 1).contiguous(), _trained_packed(torch.float32, cuda, name))
        torch.testing.assert_close(out.permute(0, 2, 3, 1), ref, atol=1e-4, rtol=0)
        assert torch.equal(out, out_again)


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


# mm_resident's shapes beyond MM_SHAPES: the experiment tool's others and
# chip_smoke.py's ragged ones (k = 96 and 64, padded to whole boxes; n = 32,
# 160, a block past n)
MM_RESIDENT_RAGGED = [(8192, 96, 160), (8192, 512, 512), (2048, 192, 192), (64, 96, 192),
                      (128, 64, 32), (256, 96, 160)]


@pytest.mark.parametrize("reps", [1, 32])
@pytest.mark.parametrize("m,k,n", MM_RESIDENT_RAGGED)
def test_mm_resident_ragged_matches_plain(cuda, m, k, n, reps):
    a, b = _mm_operands(cuda, m, k, n)
    out = mm_resident(a, b, reps=reps)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), mm_resident_plain(a, b, reps).float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("m,k,n", MM_SHAPES + MM_RESIDENT_RAGGED)
def test_mm_resident_launches_at_its_plan(cuda, m, k, n):
    assert built_mm_resident_plan(m, k, n) == mm_resident_plan(m, k, n)


def resident_probes(device, k):
    """Two exact probes of mm_resident's operand layouts and k split, (name,
    a, b): a = I (k x k) with b (k x 192) coded by position, so c = reps b;
    and b (k x k) diagonal, 1, 2, 4 by 64-column box, with a (128 x k)
    coded, so c's column c is 2^(c // 64 % 3) reps a's.  Each output is one
    product (the other warpgroup adds exact zeros), and 32 equal bf16
    products sum exactly in f32: a wrong fragment, swizzle, descriptor or
    reduction shows as a permutation of the codes."""
    code = lambda r, c: (torch.arange(r * c, device=device) % 251).reshape(r, c)  # noqa: E731
    scale = 2.0 ** (torch.arange(k, device=device) // 64 % 3)
    return [("a_identity", torch.eye(k, device=device), code(k, 192)),
            ("b_identity", code(128, k), torch.diag(scale))]


@pytest.mark.parametrize("reps", [1, 32])
@pytest.mark.parametrize("k", [64, 192, 512, 576])
@pytest.mark.parametrize("probe", [0, 1], ids=["a_identity", "b_identity"])
def test_mm_resident_one_hot_probes_are_exact(cuda, probe, k, reps):
    _, a, b = resident_probes(cuda, k)[probe]
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    out = mm_resident(a, b, reps=reps)
    torch.cuda.synchronize()
    assert torch.equal(out, mm_resident_plain(a, b, reps))


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


# ------------------------------------------------ the degradation on the card
# No kernel of the port's own: stock PyTorch ops, held to the port's CPU on the
# same draws and to the committed JAX golden, with PyTorch's default TF32
# flags (cuDNN TF32 on), which a missing guard would let through.

DEGRADE_GOLDEN = os.path.join(ROOT, "tests", "data", "jax_degrade_b2_hr128.npz")


@pytest.fixture()
def default_tf32():
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _lr_agreement(ours, ref):
    ours, ref = ours.cpu().double(), ref.cpu().double()
    equal = (torch.round(ours * 255) == torch.round(ref * 255)).double().mean().item()
    mse = ((ours - ref) ** 2).mean().item()
    return equal, (float("inf") if mse == 0 else 10 * math.log10(1 / mse))


@pytest.mark.parametrize("up1,up2", [(False, False), (True, True)])
def test_degrade_on_the_card_equals_the_cpu_on_the_same_draws(cuda, default_tf32, up1, up2):
    from real_esrgan_tpu_torch import configuration as cfg
    from real_esrgan_tpu_torch.ops.degradation import apply_degradation, draw_degradation

    geo, kcfg, dcfg = cfg.PipelineGeometry(160, 128, 4), cfg.KernelSynthesisConfig(), \
        cfg.DegradationConfig()
    gen = torch.Generator().manual_seed(7)
    hr = (torch.rand(4, 160, 160, 3, generator=gen) * 255).to(torch.uint8)
    draws = draw_degradation(gen, 4, geo, kcfg, dcfg, up1, up2, augment=True)
    lr_cpu, hr_cpu = apply_degradation(hr, draws, geo, kcfg, dcfg, up1, up2)
    lr, hr_card = apply_degradation(hr.to(cuda), draws.to(cuda), geo, kcfg, dcfg, up1, up2)
    assert torch.equal(hr_card.cpu(), hr_cpu)
    equal, psnr = _lr_agreement(lr, lr_cpu)
    assert equal >= 0.99 and psnr >= 50.0, (equal, psnr)


def test_degrade_on_the_card_matches_the_jax_golden(cuda, default_tf32):
    import numpy as np

    from real_esrgan_tpu_torch import configuration as cfg
    from real_esrgan_tpu_torch.ops.degradation import apply_degradation, draws_from_arrays

    with np.load(DEGRADE_GOLDEN) as g:
        draws = draws_from_arrays({k[6:]: g[k] for k in g.files if k.startswith("draws.")})
        hr_in, lr_ref, hr_ref = (torch.from_numpy(g[k]) for k in ("hr_uint8", "lr", "hr"))
    lr, hr = apply_degradation(hr_in.to(cuda), draws.to(cuda), cfg.PipelineGeometry(128, 64, 4),
                               cfg.KernelSynthesisConfig(), cfg.DegradationConfig(), True, True)
    assert torch.equal(hr.cpu(), hr_ref)
    equal, psnr = _lr_agreement(lr, lr_ref)
    assert equal >= 0.99 and psnr >= 50.0, (equal, psnr)


def test_make_degraded_eval_runs_on_cuda_and_raises_without_it(tmp_path):
    """Without --cpu the CLI runs on the card where there is one, and raises
    where there is none."""
    import numpy as np

    from real_esrgan_tpu_torch.scripts import make_degraded_eval
    from real_esrgan_tpu_torch.utils.imgio import read_png, save_image_rgb

    gt = tmp_path / "gt"
    gt.mkdir()
    save_image_rgb(str(gt / "a.png"), np.random.default_rng(0).random((128, 64, 3)))
    args = ["--gt-dir", str(gt), "--output-dir", str(tmp_path / "out"), "--hr-size", "64",
            "--crop-size", "32", "--batch-size", "4"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_degraded_eval.main(args)
        return
    make_degraded_eval.main(args)
    names = sorted(os.listdir(tmp_path / "out" / "LRx4"))
    assert names == ["a_000.png", "a_001.png"]
    assert read_png(str(tmp_path / "out" / "LRx4" / names[0])).shape == (8, 8, 3)


def test_make_degraded_eval_on_the_card_equals_the_cpu(cuda, tmp_path):
    """The eval set does not depend on the device: --seed 0 on the card and
    with --cpu write identical HR files and at least 99% equal 8-bit LR
    values (the card equals the CPU on the same draws; 1% leaves room for a
    rounding that lands the other way and nothing else)."""
    import numpy as np

    from real_esrgan_tpu_torch.scripts import make_degraded_eval
    from real_esrgan_tpu_torch.utils.imgio import read_png, save_image_rgb

    gt = tmp_path / "gt"
    gt.mkdir()
    save_image_rgb(str(gt / "a.png"), np.random.default_rng(1).random((320, 480, 3)))
    args = ["--gt-dir", str(gt), "--seed", "0", "--hr-size", "160", "--crop-size", "128",
            "--batch-size", "4"]
    make_degraded_eval.main(args + ["--output-dir", str(tmp_path / "card")])
    make_degraded_eval.main(args + ["--output-dir", str(tmp_path / "cpu"), "--cpu"])
    names = sorted(os.listdir(tmp_path / "card" / "GTmod4"))
    assert len(names) == 6 and names == sorted(os.listdir(tmp_path / "cpu" / "GTmod4"))
    equal, total = 0, 0
    for name in names:
        assert (tmp_path / "card" / "GTmod4" / name).read_bytes() == \
            (tmp_path / "cpu" / "GTmod4" / name).read_bytes()
        a = read_png(str(tmp_path / "card" / "LRx4" / name))
        b = read_png(str(tmp_path / "cpu" / "LRx4" / name))
        equal, total = equal + int((a == b).sum()), total + a.size
    assert equal / total >= 0.99, equal / total


def test_one_bf16_training_step_on_the_card_launches_no_rdb_kernel(cuda):
    """A full step (degradation, bf16 forward and backward with remat, the
    guarded Adam step) at 64 channels: finite loss, and the training forward
    never reaches the RDB kernel, which has no backward."""
    from real_esrgan_tpu_torch.configuration import (
        DegradationConfig, KernelSynthesisConfig, ModelConfig, PipelineGeometry, TrainConfig,
    )
    from real_esrgan_tpu_torch.train import esrnet

    cfg = TrainConfig(use_bfloat16=True, remat_rrdb=True)
    model = esrnet.build_generator(ModelConfig(num_rrdb=2), cfg, cuda)
    opt = esrnet.build_optimizer(cfg, 10)
    step = esrnet.make_train_step(model, opt, PipelineGeometry(160, 128, 4),
                                  KernelSynthesisConfig(), DegradationConfig(), cfg.ema_decay)
    state = esrnet.init_state(model, opt)
    hr = (torch.rand(2, 160, 160, 3, device=cuda) * 255).to(torch.uint8)
    before = fused_rdb.launches
    state, metrics = step(state, hr, True, True)
    torch.cuda.synchronize()
    assert fused_rdb.launches == before
    assert bool(torch.isfinite(metrics["loss"])) and float(metrics["rejected"]) == 0.0
    assert state.step == 1 and int(state.opt_state.count) == 1


def test_validation_on_the_card_launches_the_rdb_kernel_69_times_an_image(cuda):
    """The trainer's validation pass, in bf16 under no_grad on the full-depth
    evaluation model, with the committed trained weights as the EMA: 69 RDB
    kernel launches an image, and a finite NIQE."""
    import numpy as np

    from real_esrgan_tpu_torch.configuration import ModelConfig, TrainConfig
    from real_esrgan_tpu_torch.metrics.niqe import NIQE
    from real_esrgan_tpu_torch.train import esrnet
    from real_esrgan_tpu_torch.train_realesrnet import validate

    ema = {k: v.to(cuda) for k, v in load_generator_params(
        os.path.join(ROOT, "assets", "inenv10_esrnet_ema.npz")).items()}
    eval_model = esrnet.build_generator(ModelConfig(), TrainConfig(), cuda, training=False)
    rng = np.random.default_rng(0)
    images = [{"lr": rng.random((64, 64, 3)).astype(np.float32)},
              {"lr": rng.random((50, 70, 3)).astype(np.float32)}]
    before = fused_rdb.launches
    score = validate(esrnet.make_eval_fn(eval_model), ema, images,
                     NIQE(crop_border=4, device=cuda), "Valid", 0, cuda)
    assert fused_rdb.launches - before == 69 * len(images)
    assert math.isfinite(score)


# ---- the stage-2 trainer: card against CPU --------------------------------

def _gan_update(device, batch, seed=5):
    """One f32 G+D update (G 2 RRDBs at 64 channels, D at 64, VGG to conv2_2)
    on ``device`` from weights drawn on the CPU: the metrics and D's state."""
    from real_esrgan_tpu_torch.configuration import DegradationConfig, GanTrainConfig, ModelConfig
    from real_esrgan_tpu_torch.train import esrgan

    cfg = GanTrainConfig(use_bfloat16=False, remat_rrdb=False, seed=seed,
                         vgg_nodes=("conv1_2", "conv2_2"), content_weights=(0.1, 1.0))
    generator, discriminator, vgg = esrgan.build_models(ModelConfig(num_rrdb=2), cfg, device)
    g_tx, d_tx = esrgan.build_optimizers(cfg, 10)
    step = esrgan.make_gan_train_step(generator, discriminator, vgg, g_tx, d_tx, None, None,
                                      DegradationConfig(), cfg)
    state = esrgan.init_gan_state(generator, discriminator, g_tx, d_tx)
    state, metrics = step.update(state, *(t.to(device) for t in batch))
    return {k: float(v) for k, v in metrics.items()}, {k: v.cpu() for k, v in
                                                       state.d_stats.items()}


def test_one_f32_gan_update_on_the_card_equals_the_cpu(cuda):
    """Loss terms, probabilities, both grad norms and D's sigmas within 1e-4
    relative (TF32 off: the sums' order is all that differs)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(6)
    batch = (torch.rand(2, 32, 32, 3, generator=g), torch.rand(2, 128, 128, 3, generator=g))
    card, card_stats = _gan_update(cuda, batch)
    cpu, cpu_stats = _gan_update(torch.device("cpu"), batch)
    for k in ("pixel", "content", "adversarial", "g_loss", "d_loss", "d_hr_prob", "d_sr_prob",
              "g_grad_norm", "d_grad_norm"):
        assert abs(card[k] - cpu[k]) <= 1e-4 * abs(cpu[k]), (k, card[k], cpu[k])
    for k in cpu_stats:
        if k.endswith("sigma"):
            assert abs(float(card_stats[k] - cpu_stats[k])) <= 1e-4 * float(cpu_stats[k]), k


def test_the_spectral_norm_on_the_card_ignores_tf32(cuda):
    """D's power iteration is elementwise products and sums: with both TF32
    flags on, u and sigma on the card stay within 1e-5 of the CPU's over
    three calls (a TF32 product would move sigma by about 1e-3)."""
    from real_esrgan_tpu_torch.models.discriminator import SN_LAYERS, UNetDiscriminator

    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        d_cpu = UNetDiscriminator(generator=torch.Generator().manual_seed(2))
        d_card = UNetDiscriminator(device=cuda)
        d_card.load_state_dict(d_cpu.state_dict())
        stats_cpu = d_cpu.stats
        stats_card = {k: v.to(cuda) for k, v in stats_cpu.items()}
        x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(3))
        with torch.no_grad():
            for _ in range(3):
                _, stats_cpu = d_cpu(x, stats_cpu, update_stats=True)
                _, stats_card = d_card(x.to(cuda), stats_card, update_stats=True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    for name, *_ in SN_LAYERS:
        sigma, ref = float(stats_card[f"{name}.sigma"]), float(stats_cpu[f"{name}.sigma"])
        assert abs(sigma - ref) <= 1e-5 * ref, name
        assert float((stats_card[f"{name}.u"].cpu() - stats_cpu[f"{name}.u"]).abs().max()) <= 1e-5


def test_one_bf16_gan_step_on_the_card_launches_no_rdb_kernel(cuda):
    """A full G+D step (degradation, bf16, remat, the trunk content backbone)
    at 64 channels: finite losses, no RDB kernel launch (the training model
    and the trunk backbone run the plain RDB)."""
    from real_esrgan_tpu_torch.configuration import (
        DegradationConfig, GanTrainConfig, KernelSynthesisConfig, ModelConfig, PipelineGeometry,
    )
    from real_esrgan_tpu_torch.models.rrdbnet import TrunkFeatures, trunk_feature_params
    from real_esrgan_tpu_torch.train import esrgan

    cfg = GanTrainConfig(content_weights=(1.0, 1.0, 1.0))
    generator, discriminator, _ = esrgan.build_models(ModelConfig(num_rrdb=2), cfg, cuda)
    trunk = TrunkFeatures((0, 1, 2), dtype=torch.bfloat16, device=cuda).requires_grad_(False)
    trunk.load_state_dict(trunk_feature_params(generator.state_dict(), (0, 1, 2)))
    g_tx, d_tx = esrgan.build_optimizers(cfg, 10)
    step = esrgan.make_gan_train_step(generator, discriminator, trunk, g_tx, d_tx,
                                      PipelineGeometry(160, 128, 4), KernelSynthesisConfig(),
                                      DegradationConfig(), cfg)
    state = esrgan.init_gan_state(generator, discriminator, g_tx, d_tx)
    hr = (torch.rand(2, 160, 160, 3, device=cuda) * 255).to(torch.uint8)
    before = fused_rdb.launches
    state, metrics = step(state, hr, True, True)
    torch.cuda.synchronize()
    assert fused_rdb.launches == before
    assert all(math.isfinite(float(v)) for v in metrics.values())
    assert state.step == 1 and int(state.g_opt.count) == int(state.d_opt.count) == 1


def test_device_pool_gathers_on_the_card_what_it_gathers_on_the_cpu(cuda):
    """The pool lies on the card, each batch is gathered there, and only the
    int64 index vectors cross to it; the batches equal the CPU pool's."""
    import numpy as np

    from real_esrgan_tpu_torch.data.device_pool import DevicePoolLoader

    pool = np.random.default_rng(5).integers(0, 256, (13, 40, 40, 3), dtype=np.uint8)
    card, host = (DevicePoolLoader(pool, 4, seed=2, device=d) for d in (cuda, "cpu"))
    assert card.pool.device.type == "cuda"
    for _ in range(2):
        for a, b in zip(card, host):
            assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    assert card.index_bytes == 2 * 3 * 4 * 8


def test_side_stream_prefetcher_delivers_the_bytes_it_was_given(cuda):
    """Host batches reach the card through the side stream, byte for byte,
    while the consuming stream is busy; a batch on the card passes through."""
    import numpy as np

    from real_esrgan_tpu_torch.data.prefetcher import DevicePrefetcher

    rng = np.random.default_rng(9)
    host = [rng.integers(0, 256, (8, 400, 400, 3), dtype=np.uint8) for _ in range(6)]
    busy = torch.randn(4096, 4096, device=cuda)
    pf = DevicePrefetcher(host, cuda)
    got, sums = [], []
    for batch in pf:
        for _ in range(4):
            busy = busy @ busy * 1e-4  # keeps the consuming stream busy during the copies
        sums.append(batch.to(torch.int64).sum())  # read on the consuming stream
        got.append(batch)
    assert len(got) == 6 and pf.h2d_bytes == sum(h.nbytes for h in host)
    for batch, total, want in zip(got, sums, host):
        assert batch.device.type == "cuda" and np.array_equal(batch.cpu().numpy(), want)
        assert int(total) == int(want.sum(dtype=np.int64))
    on_card = [torch.full((2, 3), i, dtype=torch.uint8, device=cuda) for i in range(3)]
    through = DevicePrefetcher(on_card, cuda)
    assert all(a is b for a, b in zip(through, on_card)) and through.h2d_bytes == 0


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def test_a_one_rank_nccl_group_runs_its_collective_and_changes_no_step(cuda, monkeypatch):
    """A one-rank NCCL group joined from JAX's launch names: a forced
    ``all_reduce_mean`` runs through NCCL and returns its input's bits, and
    three stage-1 steps (``dp_check``'s small preset) are the same bits as
    with no group (cuDNN held deterministic for both)."""
    import torch.distributed as dist

    from real_esrgan_tpu_torch.parallel import mesh
    from real_esrgan_tpu_torch.tools import dp_check

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    plain = dp_check.run_cases(["esrnet_step"], "small", cuda, "")["esrnet_step"]
    for name, value in (("COORDINATOR_ADDRESS", f"localhost:{dp_check.free_port()}"),
                        ("NUM_PROCESSES", "1"), ("PROCESS_ID", "0")):
        monkeypatch.setenv(name, value)
    with mesh.process_group() as up:
        assert up and dist.get_backend() == "nccl" and mesh.world_size() == 1
        grads = {"w": torch.randn(1000, device=cuda), "b": torch.randn(3, 3, device=cuda)}
        out = mesh.all_reduce_mean(grads, force=True)
        assert all(out[k] is not grads[k] and torch.equal(out[k], grads[k]) for k in grads)
        group = dp_check.run_cases(["esrnet_step"], "small", mesh.local_device(),
                                   "")["esrnet_step"]
    assert group["metrics"] == plain["metrics"]
    for key in ("params", "ema"):
        assert all(torch.equal(group[key][k], plain[key][k]) for k in plain[key]), key


def test_two_ranks_sharing_the_card_over_gloo_equal_one_process(cuda, tmp_path):
    """Two ranks on one card (gloo, CUDA tensors): ``dp_check``'s small
    stage-1 and G+D steps against the same steps in this process on the
    whole batch: losses and grad norms within 1e-4 relative (the card
    against the CPU's bound, TF32 off), the ranks' state the same bits."""
    from real_esrgan_tpu_torch.tools import dp_check

    cases = ["esrnet_step", "gan_step"]
    runs = dp_check.launch_local(
        ["-m", "real_esrgan_tpu_torch.tools.dp_check", "--preset", "small", "--backend", "gloo",
         "--cases", ",".join(cases), "--out", str(tmp_path)], 2, 300.0)
    for r, (rc, out) in enumerate(runs):
        assert rc == 0 and f"DP_CHECK_OK rank={r}" in out, out[-3000:]
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=True) for r in range(2)]
    single = dp_check.run_cases(cases, "small", cuda, str(tmp_path))
    for case in cases:
        for m, ref in zip(ranks[0][case]["metrics"], single[case]["metrics"]):
            for key in ("loss", "grad_norm", "g_loss", "d_loss", "g_grad_norm", "d_grad_norm"):
                if key in ref:
                    assert _rel(m[key], ref[key]) <= 1e-4, (case, key)
        for key in ("params", "ema", "d_params", "d_stats"):
            if key in ranks[0][case]:
                a, b = ranks[0][case][key], ranks[1][case][key]
                assert all(torch.equal(a[k], b[k]) for k in a), (case, key)


def test_the_stage1_cli_as_two_ranks_on_the_card_resumes_on_both(cuda, tmp_path):
    """The tiny stage-1 CLI (tests/_torch_mp_worker.py) as two ranks on the
    card, each in its own working directory: one epoch, then --resume auto;
    both ranks print the resumed epoch."""
    from real_esrgan_tpu_torch.tools.dp_check import launch_local

    worker = os.path.join(ROOT, "tests", "_torch_mp_worker.py")
    cwds = [tmp_path / f"rank{r}" for r in range(2)]
    for cwd in cwds:
        cwd.mkdir()
    runs = launch_local([worker, "synthetic", "card"], 2, 300.0, cwds=[str(c) for c in cwds])
    for r, (rc, out) in enumerate(runs):
        assert rc == 0 and f"MP_WORKER_OK rank={r}" in out, out[-3000:]
        assert "Training on cuda:0" in out and "at epoch 1." in out
    assert not (cwds[1] / "results").exists()


def test_two_replicas_on_one_card_tile_as_one_device(cuda):
    """``SRPipeline(devices=[cuda:0, cuda:0])`` at the serving geometry
    (528/8/8, a 512 x 2048 image: one batch of 4 tiles, two chunks of 2):
    f32 the same bits as one device, bf16 within 40 dB of it; the RDB kernel
    launched once an RDB a chunk; a replica's forward never waits on the
    host (CUDA's sync debug mode raises if it does).  (At other tile sizes cuDNN may pick
    another algorithm for the chunk's batch size: parallel/tiling.py.)"""
    import numpy as np

    from real_esrgan_tpu_torch.serve import SRPipeline

    image = np.random.default_rng(3).random((512, 2048, 3)).astype(np.float32)
    for bf16 in (False, True):
        one = SRPipeline(num_rrdb=2, bfloat16=bf16, device=cuda)
        two = SRPipeline(num_rrdb=2, bfloat16=bf16, devices=[cuda, cuda])
        ref = one.upscale(image)
        before = fused_rdb.launches
        out = two.upscale(image)
        assert fused_rdb.launches - before == 6 * 2
        # a forward that waited on the host would keep the devices from overlapping
        tiles = torch.from_numpy(np.ascontiguousarray(image[:528, :528])).to(cuda)[None]
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.no_grad():
                two.models[1](tiles)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if bf16:
            mse = float(np.mean((out.astype(np.float64) - ref) ** 2))
            assert 10 * math.log10(1.0 / max(mse, 1e-20)) >= 40.0
        else:
            assert np.array_equal(out, ref)


def test_http_round_trip_on_the_card(cuda):
    """The port's HTTP front end on the card (2 RRDBs, bf16, warmup 64): the
    PNG is ``SRPipeline.upscale``'s output quantised as the server does, bit
    for bit; the request launched the RDB kernel once an RDB; ``/healthz``
    says cuda."""
    import json
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np

    from real_esrgan_tpu_torch.scripts import serve_http
    from real_esrgan_tpu_torch.tools.dp_check import free_port
    from real_esrgan_tpu_torch.utils.imgio import decode_png, encode_png

    handler = serve_http.build_app(num_rrdb=2, bfloat16=True, warmup_size=64)
    server = ThreadingHTTPServer(("127.0.0.1", free_port()), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        image = (np.random.default_rng(5).random((48, 64, 3)) * 255).astype(np.uint8)
        before = fused_rdb.launches
        req = urllib.request.Request(url + "/upscale", data=encode_png(image), method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            got = decode_png(resp.read())
        assert fused_rdb.launches - before == 6
        with torch.no_grad():
            sr = handler.pipeline_ref.upscale(image.astype(np.float32) / 255.0)
        assert np.array_equal(got, serve_http.quantize(sr))
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            assert json.loads(resp.read()) == {"status": "ok", "device": "cuda", "served": 1}
    finally:
        server.shutdown()
        server.server_close()


def test_bench_inference_and_tiled_modes_on_the_card(cuda, monkeypatch):
    """The bench's inference and tiled measures at 2 RRDBs on the card: K1
    launched on both paths, a FLOP count over every tile batch, an mfu at
    most 1.05 of the H100's bf16 peak."""
    from real_esrgan_tpu_torch import bench
    from real_esrgan_tpu_torch.configuration import ModelConfig

    monkeypatch.setattr(bench, "MODEL", ModelConfig(num_rrdb=2))
    card = bench.card_name(cuda)
    m = bench.measure(2, 64, 2, cuda)
    assert m.extra["fused_rdb_launches"] == 6 * (1 + 3 * 2)  # warmup, then 3 passes of 2
    line = bench._line("inference", "x", m, "MP/s", cuda, card)
    assert m.value > 0 and 0 < line["mfu"] <= 1.05
    # 512 at 272/8: core 256, 2 x 2 tiles, one batch of 4
    t = bench.measure_tiled(1, cuda, in_size=512, tile=272, tile_batch=4, overlap=8)
    assert t.extra["fused_rdb_launches"] == 6 * (1 + 3)
    assert t.extra["tile_batches"] == 1
    assert t.extra["flops_per_call"] == t.extra["flops_per_tile_batch"]
    line = bench._line("tiled", "x", t, "MP/s", cuda, card)
    assert t.value > 0 and 0 < line["mfu"] <= 1.05
