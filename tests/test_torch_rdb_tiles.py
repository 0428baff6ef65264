"""The tile schedule of the fused RDB kernels (csrc/fused_rdb.cu), on the CPU.

``tile_model`` computes an RDB block by block as the kernels do: an output
tile of side T, the x window with its 5-pixel halo, the five stage regions
(sides T + 8 .. T), each stage an implicit GEMM over fragments of 16 region
pixels whose tail reads a clamped pixel and stores nothing, taps as offsets
into the source's buffer, weight slices of one tap row x 32 input channels,
one f32 sum per (source, consumer) conv rounded to the working dtype, and
every intermediate zero outside the image.  It is the executable spec of the
region and mask arithmetic the CUDA kernels implement, held against
``rdb_plain``: f32 within 1e-5 (same math, other summation order), bf16
within atol/rtol 2e-2 (the bound of tests/test_torch_rdb.py).  The block
plan and the shared-memory layout come from ``rdb_plan``, which the wrapper
holds the built kernels to on the card.
"""

import functools
import math
import os

import pytest
import torch

from real_esrgan_tpu_torch.ops.fused_rdb import (
    HALO, fused_rdb, pack_rdb_weights, rdb_plain, rdb_plan, scalar_like,
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


def tile_model(x: torch.Tensor, packed) -> torch.Tensor:
    """``fused_rdb`` computed tile by tile as csrc/fused_rdb.cu schedules it."""
    *weights, bias = packed
    dtype = x.dtype
    t = rdb_plan(dtype)["tile"]
    sides = [t + 2 * (HALO - k) for k in range(6)]  # x, o1..o4, the output tile
    rnd = lambda v: v.to(dtype).float()  # noqa: E731
    point2 = rnd(scalar_like(0.2, x))  # LeakyReLU's slope and the residual scale
    b_, h, w, _ = x.shape
    # zero outside the image, and room for a ragged last tile
    xp = torch.nn.functional.pad(x.float(), (0, 0, HALO, HALO + t, HALO, HALO + t))
    out = torch.empty_like(x)
    for b in range(b_):
        for ty0 in range(0, h, t):
            for tx0 in range(0, w, t):
                bufs = [xp[b, ty0:ty0 + sides[0], tx0:tx0 + sides[0]].reshape(-1, C)]
                for k in range(1, 6):
                    side, n = sides[k], G if k < 5 else C
                    pixels = side * side
                    m = torch.arange(math.ceil(pixels / 16) * 16).clamp(max=pixels - 1)
                    r, c = m // side, m % side
                    total = None
                    for s in range(k):
                        shift, cin = k - s - 1, bufs[s].shape[1]
                        acc = torch.zeros(len(m), n)
                        for group in range(cin // GROUP):
                            chans = slice(group * GROUP, (group + 1) * GROUP)
                            for dy in range(3):  # one weight slice
                                for dx in range(3):
                                    px = (r + shift + dy) * sides[s] + c + shift + dx
                                    wt = weights[s][3 * dy + dx, chans, (k - 1 - s) * G:][:, :n]
                                    acc += bufs[s][px, chans] @ wt.float()
                        term = rnd(acc)
                        total = term if total is None else rnd(total + term)
                    v = rnd(total + rnd(bias[k - 1, :n]))
                    gy, gx = ty0 - (HALO - k) + r, tx0 - (HALO - k) + c
                    if k < 5:
                        inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
                        v = torch.where(v >= 0, v, rnd(v * point2))
                        bufs.append(torch.where(inside[:, None], v, 0.0)[:pixels])
                    else:
                        xc = bufs[0][(r + HALO) * sides[0] + c + HALO]
                        y = rnd(rnd(v * point2) + xc)[:pixels].reshape(t, t, C)
                        hh, ww = min(t, h - ty0), min(t, w - tx0)
                        out[b, ty0:ty0 + hh, tx0:tx0 + ww] = y[:hh, :ww].to(dtype)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plan_fits_shared_memory_and_sums_its_buffers(dtype):
    plan = rdb_plan(dtype)
    t, size = plan["tile"], torch.finfo(dtype).bits // 8
    assert plan["smem_bytes"] == sum(plan["buffers"].values()) <= SMEM_LIMIT
    assert plan["buffers"]["x"] == (t + 2 * HALO) ** 2 * C * size
    for k in range(1, 5):
        assert plan["buffers"][f"o{k}"] == (t + 2 * (HALO - k)) ** 2 * G * size
    with pytest.raises(TypeError):
        rdb_plan(torch.float16)


@pytest.mark.parametrize("stage", range(1, 6))
def test_fragments_cover_each_stage_region_once(stage):
    """A warp computes 32 columns; warp w of a group of g takes fragments
    w, w + g, ... below the stage's count.  Every (fragment, 32 columns) is
    taken by exactly one warp, every region pixel lies in exactly one
    fragment, and the tail is clamped."""
    plan = rdb_plan(torch.bfloat16)
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
