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
