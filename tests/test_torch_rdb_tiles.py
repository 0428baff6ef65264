"""The tile schedule of the fused RDB kernels (csrc/fused_rdb.cu), on the CPU.

``tile_model`` computes an RDB block by block as the kernels do: an output
tile of side T, the x window with its 5-pixel halo, the five stage regions
(sides T + 8 .. T), each stage an implicit GEMM over fragments of 16 region
pixels whose tail reads a clamped pixel and stores nothing, taps as offsets
into the source's buffer, weight slices of one tap row x 32 input channels,
and every intermediate zero outside the image.  bfloat16: one f32 sum per
(source, consumer) conv rounded to bf16.  float32: the kernel's three bf16
products, every operand split by ``split_bf16`` (activations after their
LeakyReLU), hi*hi and hi*lo + lo*hi in two partial sums a weight slice,
both added to the f32 total, and the residual read as f32 x.  It is the executable spec of the region, mask and
split arithmetic the CUDA kernels implement, held against ``rdb_plain``:
f32 within 1e-5 on N(0, 0.5^2) inputs and within 1e-4 (the f32 path's bound)
at the trunk's magnitude (|x| up to 60, where the full-depth generator's
activations reach 57), bf16 within atol/rtol 2e-2 (the bound of
tests/test_torch_rdb.py).  The block plan and the shared-memory layout come
from ``rdb_plan``, which the wrapper holds the built kernels to on the card.
"""

import functools
import math
import os

import numpy as np
import pytest
import torch

from real_esrgan_tpu_torch.ops.fused_rdb import (
    HALO, _check, fused_rdb, lrelu, pack_rdb_weights, rdb_plain, rdb_plan, scalar_like, split_bf16,
    split_rdb_weights,
)
from real_esrgan_tpu_torch.train.checkpoint import load_generator_params

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, G = 64, 32
GROUP = 32  # input channels of one weight slice
BANK_GROUPS = 8  # 16-byte bank groups of one 128-byte shared-memory line
SMEM_LIMIT = 232_448  # dynamic shared memory one block may have on sm_90


@functools.lru_cache(maxsize=None)
def trained_packed(name: str, dtype: torch.dtype):
    state = load_generator_params(os.path.join(ROOT, "assets", "inenv10_esrnet_ema.npz"))
    convs = [(state[f"{name}.conv{k}.weight"], state[f"{name}.conv{k}.bias"]) for k in range(1, 6)]
    return pack_rdb_weights([w for w, _ in convs], [b for _, b in convs], C, G, dtype)


def normal_input(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * 0.5).to(dtype)


def trunk_scale(x: torch.Tensor, peak: float = 60.0) -> torch.Tensor:
    """``x`` scaled so that its largest magnitude is ``peak``: the trunk's
    activations reach |x| = 57 in the full-depth generator on the test image."""
    return x * (peak / x.abs().max())


def bf16_parts(v: torch.Tensor, products: int):
    """The bf16 operands the tensor cores multiply, as f32: ``v`` itself
    (one product) or its ``split_bf16`` hi and lo parts (three products)."""
    if products == 1:
        return [v]
    return [part.float() for part in split_bf16(v)]


# the (A part, B part) of each product: hi*hi, hi*lo, lo*hi
PRODUCT_PARTS = {1: [(0, 0)], 3: [(0, 0), (0, 1), (1, 0)]}


def tile_model(x: torch.Tensor, packed, residual: str = "f32") -> torch.Tensor:
    """``fused_rdb`` computed tile by tile as csrc/fused_rdb.cu schedules it.
    ``residual="split"`` adds x_hi + x_lo in place of f32 x: not what the
    kernel does, and why it does not."""
    *weights, bias = packed
    dtype = x.dtype
    plan = rdb_plan(dtype)
    t, products = plan["tile"], plan["products"]
    sides = [t + 2 * (HALO - k) for k in range(6)]  # x, o1..o4, the output tile
    rnd = lambda v: v.to(dtype).float()  # noqa: E731
    point2 = rnd(scalar_like(0.2, x))  # LeakyReLU's slope and the residual scale
    w_parts = [bf16_parts(w.float(), products) for w in weights]
    b_, h, w, _ = x.shape
    # zero outside the image, and room for a ragged last tile
    xp = torch.nn.functional.pad(x.float(), (0, 0, HALO, HALO + t, HALO, HALO + t))
    out = torch.empty_like(x)
    for b in range(b_):
        for ty0 in range(0, h, t):
            for tx0 in range(0, w, t):
                bufs = [xp[b, ty0:ty0 + sides[0], tx0:tx0 + sides[0]].reshape(-1, C)]
                parts = [bf16_parts(bufs[0], products)]
                for k in range(1, 6):
                    side, n = sides[k], G if k < 5 else C
                    pixels = side * side
                    m = torch.arange(math.ceil(pixels / 16) * 16).clamp(max=pixels - 1)
                    r, c = m // side, m % side
                    total = torch.zeros(len(m), n)
                    for s in range(k):
                        shift, cin = k - s - 1, bufs[s].shape[1]
                        acc = torch.zeros(len(m), n)
                        for group in range(cin // GROUP):
                            chans = slice(group * GROUP, (group + 1) * GROUP)
                            for dy in range(3):  # one weight slice
                                # float32: hi*hi and the cross products in two
                                # partial sums, added to the total each slice
                                partial = [torch.zeros(len(m), n), torch.zeros(len(m), n)]
                                for dx in range(3):
                                    px = (r + shift + dy) * sides[s] + c + shift + dx
                                    cols = slice((k - 1 - s) * G, (k - 1 - s) * G + n)
                                    for i, j in PRODUCT_PARTS[products]:
                                        wt = w_parts[s][j][3 * dy + dx, chans, cols]
                                        partial[(i, j) != (0, 0)] += parts[s][i][px, chans] @ wt
                                if products == 1:
                                    acc += partial[0]
                                else:
                                    total += partial[0] + partial[1]
                        if products == 1:  # one rounding a source, then the sum in bf16
                            total = rnd(acc) if s == 0 else rnd(total + rnd(acc))
                    v = rnd(total + rnd(bias[k - 1, :n]))
                    gy, gx = ty0 - (HALO - k) + r, tx0 - (HALO - k) + c
                    if k < 5:
                        inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
                        v = torch.where(v >= 0, v, rnd(v * point2))
                        bufs.append(torch.where(inside[:, None], v, 0.0)[:pixels])
                        parts.append(bf16_parts(bufs[k], products))
                    else:
                        x_res = bufs[0] if residual == "f32" else sum(parts[0])
                        xc = x_res[(r + HALO) * sides[0] + c + HALO]
                        y = rnd(rnd(v * point2) + xc)[:pixels].reshape(t, t, C)
                        hh, ww = min(t, h - ty0), min(t, w - tx0)
                        out[b, ty0:ty0 + hh, tx0:tx0 + ww] = y[:hh, :ww].to(dtype)
    return out


def split_model(x: torch.Tensor, packed) -> torch.Tensor:
    """The float32 kernel's arithmetic on the whole image at once, for a
    whole generator: ``rdb_plain`` with each conv taken as three bf16
    products of ``split_bf16`` parts, summed in f32, and f32 x as the
    residual.  The order of the sums is not the kernel's."""
    *weights, bias = packed
    xc = x.permute(0, 3, 1, 2)

    def conv(t, w):
        a_hi, a_lo = bf16_parts(t, 3)
        w_hi, w_lo = bf16_parts(w.reshape(3, 3, w.shape[1], w.shape[2]).permute(3, 2, 0, 1), 3)
        return sum(torch.nn.functional.conv2d(a, b, padding=1)
                   for a, b in ((a_hi, w_hi), (a_hi, w_lo), (a_lo, w_hi)))

    sources, terms = [xc], []
    for k in range(5):
        terms.append(conv(sources[k], weights[k]))
        width = G if k < 4 else C
        acc = sum(terms[s][:, (k - s) * G:(k - s) * G + width] for s in range(k + 1))
        acc = acc + bias[k, :width][:, None, None]
        if k < 4:
            sources.append(lrelu(acc))
    return (acc * scalar_like(0.2, acc) + xc).permute(0, 2, 3, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plan_fits_shared_memory_and_sums_its_buffers(dtype):
    plan = rdb_plan(dtype)
    t, size = plan["tile"], torch.finfo(dtype).bits // 8
    assert plan["smem_bytes"] == sum(plan["buffers"].values()) <= SMEM_LIMIT
    assert plan["buffers"]["x"] == (t + 2 * HALO) ** 2 * C * size
    for k in range(1, 5):
        assert plan["buffers"][f"o{k}"] == (t + 2 * (HALO - k)) ** 2 * G * size
    # every buffer is bf16 planes: float32 keeps a hi and a lo plane, the
    # bytes of f32, and the ring holds both parts of each weight slice
    planes = {torch.float32: 2, torch.bfloat16: 1}[dtype]
    assert plan["planes"] == planes == size // 2
    assert plan["products"] == {torch.float32: 3, torch.bfloat16: 1}[dtype]
    assert plan["buffers"]["weight_ring"] == plan["ring_slots"] * plan["slot_bytes"]
    if dtype == torch.float32:  # two slots of a slice: 3 taps x 32 channels x 64 columns
        assert plan["buffers"]["weight_ring"] == 2 * 3 * GROUP * C * 2 * planes
        assert plan["slots_per_tile"] == 60
    else:  # seven slots of a box of 32 columns x 64 k, the mbarriers, room to align
        assert plan["buffers"]["weight_ring"] == 7 * 32 * 64 * 2
        assert plan["buffers"]["mbarriers"] == (2 * 7 + 1) * 8
        assert plan["buffers"]["align"] == 1024 and plan["slots_per_tile"] == 124
    assert plan["smem_bytes"] == {torch.float32: 221_184, torch.bfloat16: 230_520}[dtype]
    with pytest.raises(TypeError):
        rdb_plan(torch.float16)


@pytest.mark.parametrize("stage", range(1, 6))
def test_fragments_cover_each_stage_region_once(stage):
    """The bfloat16 kernel's fragments are units of 64 region pixels, one
    wgmma m64 tile each, every unit all of the stage's columns: warpgroup g
    of two takes units g, g + 2, ..., the same count each, so that a unit
    past the stage's count is a dummy.  Every real unit is taken by exactly
    one warpgroup, every region pixel lies in exactly one unit, and the
    tail and the dummy are clamped."""
    plan = rdb_plan(torch.bfloat16)
    st, groups = plan["stages"][stage - 1], plan["consumer_warpgroups"]
    assert st["side"] == plan["tile"] + 2 * (HALO - stage) and st["pixels"] == st["side"] ** 2
    assert st["columns"] == (G if stage < 5 else C) == G * st["halves"]
    taken = [g + groups * u for g in range(groups) for u in range(st["units_per_warpgroup"])]
    real = sorted(t for t in taken if t < st["units"])
    assert real == list(range(st["units"])) and len(taken) - len(real) == st["dummy_units"] <= 1
    assert (st["units"] - 1) * 64 < st["pixels"] <= st["units"] * 64
    rows = torch.arange(len(taken) * 64)
    assert rows.clamp(max=st["pixels"] - 1).max() == st["pixels"] - 1


@pytest.mark.parametrize("stage", range(1, 6))
def test_f32_fragments_cover_each_stage_region_once(stage):
    """The same schedule at the float32 kernel's tile of 8: regions of 16^2
    .. 8^2 pixels, at most two fragments a warp."""
    plan = rdb_plan(torch.float32)
    assert plan["tile"] == 8 and max(st["units_per_warp"] for st in plan["stages"]) == 2
    check_stage_cover(plan, stage)


def check_stage_cover(plan: dict, stage: int) -> None:
    st, warps = plan["stages"][stage - 1], plan["warps"]
    assert st["side"] == plan["tile"] + 2 * (HALO - stage) and st["pixels"] == st["side"] ** 2
    assert st["columns"] == (G if stage < 5 else C) == G * st["warp_groups"]
    per_group = warps // st["warp_groups"]
    assert per_group * st["warp_groups"] == warps
    taken = {w: [(w % per_group + per_group * u, w // per_group)
                 for u in range(st["units_per_warp"])
                 if w % per_group + per_group * u < st["fragments"]] for w in range(warps)}
    assert sorted(t for units in taken.values() for t in units) == \
        [(f, h) for f in range(st["fragments"]) for h in range(st["warp_groups"])]
    assert st["units_per_warp"] == max(len(units) for units in taken.values())
    rows = torch.arange(st["fragments"] * 16)
    assert (rows < st["pixels"]).sum() == st["pixels"] > (st["fragments"] - 1) * 16
    assert rows.clamp(max=st["pixels"] - 1).max() == st["pixels"] - 1


@pytest.mark.parametrize("shape", [(1, 32, 48, C), (2, 20, 28, C), (1, 5, 3, C)],
                         ids=["aligned", "ragged", "smaller_than_a_tile"])
def test_tile_model_matches_plain_f32(shape):
    packed = trained_packed("trunk.11.rdb2", torch.float32)
    x = normal_input(shape, torch.float32)
    torch.testing.assert_close(tile_model(x, packed), rdb_plain(x, packed), atol=1e-5, rtol=0)


def test_tile_model_matches_plain_bf16_three_ragged_images():
    packed = trained_packed("trunk.11.rdb2", torch.bfloat16)
    x = normal_input((3, 17, 40, C), torch.bfloat16, seed=1)
    torch.testing.assert_close(tile_model(x, packed).float(), rdb_plain(x, packed).float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("shape", [(1, 32, 48, C), (2, 20, 28, C), (1, 5, 3, C)],
                         ids=["aligned", "ragged", "smaller_than_a_tile"])
def test_split_tile_model_matches_plain_at_trunk_magnitude(shape):
    """The three-product arithmetic holds the f32 bound of 1e-4 where the
    trunk's activations are largest, with trained weights."""
    packed = trained_packed("trunk.11.rdb2", torch.float32)
    x = trunk_scale(normal_input(shape, torch.float32, seed=2))
    torch.testing.assert_close(tile_model(x, packed), rdb_plain(x, packed), atol=1e-4, rtol=0)


def test_residual_through_x_hi_plus_lo_breaks_the_bound():
    """Why the kernel reads f32 x for the residual: x_hi + x_lo keeps 16 of
    x's 24 bits, off by up to 2^-16 |x|, and on the same inputs that alone
    takes the output past 1e-4, while f32 x keeps it within."""
    packed = trained_packed("trunk.11.rdb2", torch.float32)
    x = trunk_scale(normal_input((1, 32, 48, C), torch.float32, seed=2))
    hi, lo = split_bf16(x)
    gap = (x - (hi.float() + lo.float())).abs()
    assert (gap <= x.abs() * 2.0 ** -16).all() and gap.max() > 1e-4
    ref = rdb_plain(x, packed)
    assert (tile_model(x, packed, residual="split") - ref).abs().max() > 1e-4
    assert (tile_model(x, packed) - ref).abs().max() <= 1e-4


def test_split_model_generator_matches_jax_golden(monkeypatch):
    """The full-depth x4 f32 generator with every one of its 69 RDBs in the
    float32 kernel's arithmetic (split_model) stays within 1e-4 of the JAX
    golden output on the 67x93 crop of the test image."""
    from real_esrgan_tpu_torch.models import Generator, rrdbnet
    from real_esrgan_tpu_torch.utils.imgio import read_png

    calls = []

    def emulated(x, packed, split=None, boxes=None):
        calls.append(x.shape)
        return split_model(x, packed)

    monkeypatch.setattr(rrdbnet, "fused_rdb", emulated)
    model = Generator(dtype=torch.float32, device="cpu").eval()
    model.load_state_dict(load_generator_params(os.path.join(ROOT, "assets",
                                                             "inenv10_esrnet_ema.npz")))
    crop = read_png(os.path.join(ROOT, "tests", "data", "tree_lr.png"))[64:131, 128:221]
    with torch.no_grad():
        out = model(torch.from_numpy(crop.astype("float32") / 255.0)[None])[0]
    golden = torch.from_numpy(np.load(os.path.join(ROOT, "tests", "data",
                                                   "jax_sr_tree_crop67x93_f32.npy")))
    assert len(calls) == 69 and out.shape == golden.shape == (268, 372, 3)
    torch.testing.assert_close(out, golden, atol=1e-4, rtol=0)


def test_split_model_matches_the_tile_model():
    """The whole-image model of the split is the tile model's arithmetic in
    another order of summation."""
    packed = trained_packed("trunk.0.rdb1", torch.float32)
    x = trunk_scale(normal_input((1, 20, 28, C), torch.float32, seed=3))
    torch.testing.assert_close(split_model(x, packed), tile_model(x, packed), atol=2e-5, rtol=0)


def test_split_bf16_keeps_sixteen_bits():
    g = torch.Generator().manual_seed(5)
    t = torch.randn(100_000, generator=g) * torch.exp2(torch.randint(-20, 20, (100_000,), generator=g))
    t = torch.cat([t, torch.tensor([0.0, -0.0, 1.0, -57.2])])
    hi, lo = split_bf16(t)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, t.to(torch.bfloat16))
    assert torch.equal(lo, (t - hi.float()).to(torch.bfloat16))
    assert ((t - hi.float() - lo.float()).abs() <= t.abs() * 2.0 ** -16).all()


def test_split_rdb_weights_splits_the_five_weights():
    packed = trained_packed("trunk.11.rdb2", torch.float32)
    hi, lo = split_rdb_weights(packed)
    assert len(hi) == len(lo) == 5
    for w, h, l_ in zip(packed[:5], hi, lo):
        assert h.shape == l_.shape == w.shape and h.is_contiguous() and l_.is_contiguous()
        assert torch.equal(h, split_bf16(w)[0]) and torch.equal(l_, split_bf16(w)[1])


def test_check_validates_the_split():
    packed = list(trained_packed("trunk.0.rdb1", torch.float32))
    x = torch.zeros(1, 8, 8, C)
    hi, lo = split_rdb_weights(packed)
    _check(x, packed, (hi, lo))
    with pytest.raises(ValueError, match="only the float32"):
        _check(x.bfloat16(), [w.bfloat16() for w in packed[:5]] + packed[5:], (hi, lo))
    with pytest.raises(ValueError, match="five weights"):
        _check(x, packed, (hi, lo[:4]))
    with pytest.raises(ValueError, match="bfloat16"):
        _check(x, packed, (hi, (lo[0].float(),) + lo[1:]))
    with pytest.raises(ValueError, match="contiguous"):
        _check(x, packed, (hi[:4] + (hi[4][:, :16],), lo))
    shifted = torch.empty(lo[2].numel() + 8, dtype=torch.bfloat16)[1:1 + lo[2].numel()]
    shifted = shifted.view(lo[2].shape)
    shifted.copy_(lo[2])
    with pytest.raises(ValueError, match="16-byte boundary"):
        _check(x, packed, (hi, lo[:2] + (shifted,) + lo[3:]))


def test_block_keeps_its_split_beside_its_pack():
    """ResidualDenseBlock splits its cached float32 pack once and drops the
    split with the pack: after load_state_dict the split is the new
    weights'; another pack is split anew and not kept."""
    from real_esrgan_tpu_torch.models.rrdbnet import ResidualDenseBlock

    block = ResidualDenseBlock(C, G)
    state = load_generator_params(os.path.join(ROOT, "assets", "inenv10_esrnet_ema.npz"))

    def load(name):
        block.load_state_dict({k[len(name) + 1:]: v for k, v in state.items()
                               if k.startswith(name + ".")})

    same = lambda a, b: all(torch.equal(s, t) for s, t in zip(a, b))  # noqa: E731
    with torch.no_grad():
        load("trunk.0.rdb1")
        packed = block.packed_weights(torch.float32)
        split = block.split_weights(packed)
        assert block.split_weights(block.packed_weights(torch.float32)) is split
        assert same(split[0], split_rdb_weights(trained_packed("trunk.0.rdb1", torch.float32))[0])
        load("trunk.22.rdb3")
        fresh = block.split_weights(block.packed_weights(torch.float32))
        expected = split_rdb_weights(trained_packed("trunk.22.rdb3", torch.float32))
        assert fresh is not split and same(fresh[0], expected[0]) and same(fresh[1], expected[1])
        other = trained_packed("trunk.0.rdb1", torch.float32)
        assert block.split_weights(other) is not block.split_weights(other)
        assert block.split_weights(block.packed_weights(torch.float32)) is fresh


def swizzle(row: int, chunks: int) -> int:
    """csrc/fused_rdb.cu's swizzle: chunk c of a row of 4 or 8 16-byte chunks
    is stored at chunk c ^ swizzle(row)."""
    return row & 7 if chunks == 8 else (row >> 1) & 3


@pytest.mark.parametrize("chunks", [4, 8], ids=["64_byte_rows", "128_byte_rows"])
def test_swizzle_keeps_ldmatrix_phases_free_of_bank_conflicts(chunks):
    """Within a row the swizzle permutes the chunks; eight consecutive rows
    read at one chunk (an ldmatrix phase, wherever it starts) hit eight
    different bank groups."""
    for row in range(64):
        assert sorted(c ^ swizzle(row, chunks) for c in range(chunks)) == list(range(chunks))
    for first in range(64):
        for chunk in range(chunks):
            groups = {((row * chunks + (chunk ^ swizzle(row, chunks))) % BANK_GROUPS)
                      for row in range(first, first + 8)}
            assert len(groups) == BANK_GROUPS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_swizzle_holds_in_every_plane_of_the_plan(dtype):
    """Every buffer and ring plane of the plan (float32: a hi and a lo plane
    each) starts on a 128-byte line, so the swizzle's eight bank groups hold
    for ldmatrix in the lo planes as in the hi ones.  bfloat16: the ring's
    slots and x, which TMA and wgmma address with the 128-byte swizzle, start
    on 1024-byte boundaries, o1..o4 on 128-byte lines."""
    plan = rdb_plan(dtype)
    if dtype == torch.bfloat16:
        offset = 0
        for name, size in list(plan["buffers"].items())[1:-1]:  # past "align", before the mbarriers
            assert offset % (1024 if name in ("weight_ring", "x") else 128) == 0, name
            if name == "weight_ring":
                assert all((offset + slot * plan["slot_bytes"]) % 1024 == 0
                           for slot in range(plan["ring_slots"]))
            chunks = 8 if name in ("x", "weight_ring") else 4
            for first in range(0, 40):
                groups = {((offset // 16 + row * chunks + swizzle(row, chunks)) % BANK_GROUPS)
                          for row in range(first, first + 8)}
                assert len(groups) == BANK_GROUPS
            offset += size
        assert offset % 8 == 0  # the mbarriers
        return
    offset = 0
    for name, size in plan["buffers"].items():
        plane = size // plan["planes"]
        for p in range(plan["planes"]):
            start = offset + p * plane
            if name == "weight_ring":  # two slots, each a hi and a lo slice
                starts = [start + slot * size // 2 for slot in range(2)]
            else:
                starts = [start]
            chunks = 8 if name in ("x", "weight_ring") else 4
            for base in starts:
                assert base % (16 * BANK_GROUPS) == 0
                for first in range(0, 40):
                    groups = {((base // 16 + row * chunks + swizzle(row, chunks)) % BANK_GROUPS)
                              for row in range(first, first + 8)}
                    assert len(groups) == BANK_GROUPS
        offset += size


def test_no_fallback_on_a_device_without_a_kernel():
    packed = [t.to("meta") for t in trained_packed("trunk.0.rdb1", torch.bfloat16)]
    before = fused_rdb.launches
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_rdb(torch.empty(1, 8, 8, C, dtype=torch.bfloat16, device="meta"), packed)
    assert fused_rdb.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_scalar_like_rounds_as_a_tensor_constant(dtype):
    """Filled on the device (so a CUDA graph can capture rdb_plain), with the
    value torch.tensor gives in that dtype."""
    like = torch.zeros(2, dtype=dtype)
    value = scalar_like(0.2, like)
    assert value.dtype == dtype and value.shape == ()
    assert torch.equal(value, torch.tensor(0.2, dtype=dtype))
