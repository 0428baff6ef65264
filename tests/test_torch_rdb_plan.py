"""The bfloat16 RDB kernel's geometry and operand layouts (csrc/fused_rdb.cu,
``rdb_bf16_wgmma_kernel`` on csrc/hopper.cuh), on the CPU: the executable
spec of what the kernel computes where.

* The units: each stage's region cut into units of 64 pixels (one wgmma
  m64 tile), warpgroup g of two taking units g, g + 2, ...; every region
  pixel stored by exactly one unit row, the tail and the dummy clamped.
* The weight stream (``box_rdb_weights``): 124 boxes of 32 columns x 64 k,
  128-byte swizzled; read back through each k step's wgmma descriptor, every
  weight of every (consumer, source) arrives exactly once a tile, source
  by source, in the order (group of 32 channels, tap, channel).
* The ring: the producer and the two consumer warpgroups played out with
  the full and empty mbarriers' parities, in random interleavings: every
  box delivered in order, no slot reloaded while a warpgroup reads it.
* The A fragments: every lane's ldmatrix address, out of the x box as TMA
  lays it down (128-byte swizzle, zeros outside the image) and out of o1..o4
  as the epilogue writes them, gives back the tap-shifted pixels, and each
  8-lane phase hits 8 bank groups.
* The epilogue: wgmma's accumulator places into o_K's buffer and into the
  output, every element once.
* The whole tile model, built from the pieces above in the kernel's order
  of summation, against ``rdb_plain`` in bfloat16.
* The weight boxes' cache in ``ResidualDenseBlock``: rebuilt after
  ``load_state_dict``, dropped with its pack.
"""

import functools
import os

import numpy as np
import pytest
import torch
from test_torch_conv_plan import read_b
from test_torch_mm_plan import Mbarrier, fields, smem_desc, swizzle

from real_esrgan_tpu_torch.ops.fused_rdb import (
    BOX_BYTES, BOX_K, BOX_ROWS, CONSUMER_WARPGROUPS, HALO, RING_SLOTS, UNIT_PIXELS,
    box_rdb_weights, pack_rdb_weights, rdb_plain, rdb_plan,
)
from real_esrgan_tpu_torch.train.checkpoint import load_generator_params

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, G = 64, 32
PLAN = rdb_plan(torch.bfloat16)
T = PLAN["tile"]
SIDES = [T + 2 * (HALO - k) for k in range(6)]  # x, o1..o4, the output tile
CIN = [C, G, G, G, G]
ROW_BYTES = [2 * c for c in CIN]
GROUPS = CONSUMER_WARPGROUPS


def _offsets():
    """Byte offset of each buffer from the block's 1024-aligned base."""
    offsets, at = {}, 0
    for name, size in PLAN["buffers"].items():
        if name != "align":
            offsets[name] = at
            at += size
    return offsets


OFFSET = _offsets()
BUF = [OFFSET["x"]] + [OFFSET[f"o{k}"] for k in range(1, 5)]
SMEM_VALUES = (PLAN["smem_bytes"] - PLAN["buffers"]["align"]) // 2  # one value per bf16


def stage(k):
    return PLAN["stages"][k - 1]


def stream():
    """(consumer k, source s, box b, half h) of every box, in stream order."""
    return [(k, s, b, h) for k in range(1, 6) for s in range(k)
            for b in range(stage(k)["boxes"][s]) for h in range(stage(k)["halves"])]


STREAM = stream()
FIRST_BOX = {}
for _i, (_k, _s, _b, _h) in enumerate(STREAM):
    FIRST_BOX.setdefault((_k, _s), _i)


def rnd(v):
    """Rounded to bfloat16, as float32."""
    return torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(torch.bfloat16).float().numpy()


# ---- the units ------------------------------------------------------------

def unit_rows(k):
    """(g, u, w, r) -> (unit, m, clamped m): the region pixel of row 16 w + r
    of warpgroup g's unit u, and the pixel its lane reads."""
    st = stage(k)
    g, u, w, r = np.meshgrid(np.arange(GROUPS), np.arange(st["units_per_warpgroup"]),
                             np.arange(4), np.arange(16), indexing="ij")
    unit = g + GROUPS * u
    m = unit * UNIT_PIXELS + 16 * w + r
    return unit, m, np.minimum(m, st["pixels"] - 1)


@pytest.mark.parametrize("k", range(1, 6))
def test_units_store_every_region_pixel_once(k):
    st = stage(k)
    unit, m, clamped = unit_rows(k)
    stored = (unit < st["units"]) & (m < st["pixels"])
    assert sorted(m[stored].tolist()) == list(range(st["pixels"]))
    assert (clamped[~stored] == st["pixels"] - 1).all()  # the tail and the dummy read a real pixel
    assert (~stored).sum() == GROUPS * st["units_per_warpgroup"] * UNIT_PIXELS - st["pixels"]


def test_plan_is_the_designed_one():
    assert (PLAN["tile"], PLAN["threads"], PLAN["ring_slots"], PLAN["slot_bytes"]) == \
        (16, 384, 7, 4096)
    assert [st["units"] for st in PLAN["stages"]] == [9, 8, 7, 6, 4]
    assert [st["units_per_warpgroup"] for st in PLAN["stages"]] == [5, 4, 4, 3, 2]
    assert PLAN["slots_per_tile"] == len(STREAM) == 124
    assert OFFSET["weight_ring"] == 0 and OFFSET["x"] % 1024 == 0
    assert PLAN["buffers"]["x"] == 26 * 26 * 128  # one TMA box (64, 26, 26, 1)
    regs = PLAN["registers"]
    assert GROUPS * 128 * regs["consumer"] + 128 * regs["producer"] <= 65536
    # the tensor work the units issue: 1.48x the bound's, 1.34x of it the halo
    done = sum(GROUPS * st["units_per_warpgroup"] * st["halves"] * sum(st["k_steps"])
               for st in PLAN["stages"]) * UNIT_PIXELS * G * 16
    assert round(done / (T * T * 239_616), 2) == 1.48


# ---- the weight stream and the B descriptors --------------------------------

def coded_pack():
    """Packed float32 weights whose every element is its own code (1, 2, ...),
    and the stream's boxes of them."""
    weights, code = [], 1
    for s in range(5):
        n = (4 - s) * G + C
        size = 9 * CIN[s] * n
        weights.append(torch.arange(code, code + size, dtype=torch.float64).float()
                       .reshape(9, CIN[s], n))
        code += size
    return weights, box_rdb_weights(weights + [torch.zeros(5, C)]).numpy()


def slot_smem(boxes, i, smem=None):
    """Shared memory after the producer's bulk copy of stream box i into its
    slot: the box's 4096 bytes as they lie."""
    if smem is None:
        smem = np.full(SMEM_VALUES, np.nan, np.float32)
    slot = i % RING_SLOTS
    smem[slot * BOX_BYTES // 2:(slot + 1) * BOX_BYTES // 2] = \
        boxes[i * BOX_BYTES // 2:(i + 1) * BOX_BYTES // 2]
    return smem


def b_descriptor(i, j):
    """The kernel's descriptor of step j of stream box i."""
    return smem_desc((i % RING_SLOTS) * BOX_BYTES + 32 * j, 16, 1024)


def read_pair(boxes, k, s):
    """Consumer k's B from source s as the wgmma of every k step read it:
    (N, k_steps * 16); in stage 5 a wgmma a half, each its own box."""
    st = stage(k)
    cols = []
    for t in range(st["k_steps"][s]):
        halves = []
        for h in range(st["halves"]):
            i = FIRST_BOX[(k, s)] + (t // 4) * st["halves"] + h
            halves.append(read_b(slot_smem(boxes, i), b_descriptor(i, t % 4), BOX_ROWS))
        cols.append(np.concatenate(halves))
    return np.concatenate(cols, axis=1)


def k_order(w, k, s):
    """Consumer k's columns of source s's packed weights, K-major in the
    kernel's order: k = (group of 32 channels, tap, channel of the group)."""
    n = G if k < 5 else C
    cols = w[:, :, (k - 1 - s) * G:(k - 1 - s) * G + n]  # (9, Cin, n)
    return np.ascontiguousarray(
        cols.reshape(9, CIN[s] // 32, 32, n).transpose(1, 0, 2, 3).reshape(9 * CIN[s], n).T)


@pytest.mark.parametrize("k", range(1, 6))
def test_stream_delivers_every_weight_once_source_major(k):
    weights, boxes = coded_pack()
    seen = []
    for s in range(k):
        got = read_pair(boxes, k, s)
        np.testing.assert_array_equal(got, k_order(weights[s].numpy(), k, s))
        seen.append(got.ravel())
    seen = np.concatenate(seen)
    assert len(np.unique(seen)) == seen.size  # once each
    # source-major: every code of source s before any of source s + 1
    firsts = [FIRST_BOX[(k, s)] for s in range(k)]
    assert firsts == sorted(firsts) and all(b - a == stage(k)["halves"] * stage(k)["boxes"][s]
                                            for s, (a, b) in enumerate(zip(firsts, firsts[1:])))


def test_stream_holds_every_weight_and_zeros_only_past_an_o():
    weights, boxes = coded_pack()
    total = sum(w.numel() for w in weights)
    codes = boxes[boxes > 0]
    # every weight element once for each consumer it feeds: all of a source's
    # columns are some consumer's, so each code appears exactly once
    assert codes.size == total and len(np.unique(codes)) == total
    zeros = (boxes == 0).sum()
    # an o's fifth box is half zeros: 32 k x 32 columns, for each (consumer,
    # source >= 1) pair and half
    assert zeros == sum(stage(k)["halves"] * 32 * 32 for k in range(2, 6) for s in range(1, k))


@pytest.mark.parametrize("k,s", [(k, s) for k in range(1, 6) for s in range(k)])
def test_b_descriptors_give_back_the_packed_weights(k, s):
    packed = trained_packed("trunk.11.rdb2")
    boxes = box_rdb_weights(packed).float().numpy()
    w = packed[s].float().numpy()
    np.testing.assert_array_equal(read_pair(boxes, k, s), k_order(w, k, s))


def test_descriptor_faults_show_as_permutations():
    """SBO and LBO swapped, or a box laid down unswizzled, do not give the
    weights back."""
    weights, boxes = coded_pack()
    i = FIRST_BOX[(3, 1)] + 1
    smem = slot_smem(boxes, i)
    good = read_b(smem, b_descriptor(i, 2), BOX_ROWS)
    f = fields(b_descriptor(i, 2))
    assert f["sbo"] == 1024 and f["layout"] == 1
    swapped = smem_desc((i % RING_SLOTS) * BOX_BYTES + 64, 1024, 16)
    assert not np.array_equal(read_b(smem, swapped, BOX_ROWS), good)
    plain = np.full_like(smem, np.nan)
    start = (i % RING_SLOTS) * BOX_BYTES // 2
    box = boxes[i * BOX_BYTES // 2:(i + 1) * BOX_BYTES // 2]
    plain[start + (swizzle(np.arange(BOX_BYTES // 2) * 2) // 2)] = box  # undo the swizzle
    assert not np.array_equal(read_b(plain, b_descriptor(i, 2), BOX_ROWS), good)


# ---- the ring ---------------------------------------------------------------

def warpgroup_events():
    """One warpgroup's walk of the stream, as add_source makes it: wait for
    box b's slots, issue its steps; at step 0 of box b > 0 release box b - 1;
    the last box of a source is released after the source's final wait."""
    events = []
    for k in range(1, 6):
        halves = stage(k)["halves"]
        for s in range(k):
            first, nb = FIRST_BOX[(k, s)], stage(k)["boxes"][s]
            ids = lambda b: [first + b * halves + h for h in range(halves)]  # noqa: E731
            for b in range(nb):
                events.append(("wait", ids(b)))
                if b > 0:
                    events.append(("release", ids(b - 1)))
            events.append(("release", ids(nb - 1)))
    return events


@pytest.mark.parametrize("seed", range(6))
def test_ring_delivers_every_box_in_order_and_never_overwrites(seed):
    """The producer thread and the two consumer warpgroups with their
    parities: box i goes to slot i % 7 once empty passes parity
    (i // 7 & 1) ^ 1 (an expect_tx arrival, the bulk copy's bytes later); a
    warpgroup waits full at parity i // 7 & 1 and, once done with the box,
    arrives on empty (128 threads; 256 complete the phase)."""
    rng = np.random.default_rng(seed)
    full = [Mbarrier(1) for _ in range(RING_SLOTS)]
    empty = [Mbarrier(2) for _ in range(RING_SLOTS)]  # a warpgroup's 128 arrivals as one
    holder = [None] * RING_SLOTS
    events = [warpgroup_events() for _ in range(GROUPS)]
    at = [0] * GROUPS
    held = [set() for _ in range(GROUPS)]
    got = [[] for _ in range(GROUPS)]
    produced, pending = 0, []
    for _ in range(100_000):
        if all(a == len(e) for a, e in zip(at, events)):
            break
        actor = rng.integers(0, GROUPS + 2)
        if actor == GROUPS and produced < len(STREAM):
            s = produced % RING_SLOTS
            if empty[s].try_wait((produced // RING_SLOTS & 1) ^ 1):
                assert all(holder[s] not in h for h in held), f"slot {s} reloaded while read"
                full[s].arrive(expect_tx=BOX_BYTES)
                holder[s] = produced
                pending.append(s)
                produced += 1
        elif actor == GROUPS + 1 and pending:  # a bulk copy lands
            full[pending.pop(0)].transfer(BOX_BYTES)
        elif actor < GROUPS and at[actor] < len(events[actor]):
            kind, ids = events[actor][at[actor]]
            if kind == "wait":
                if all(full[i % RING_SLOTS].try_wait(i // RING_SLOTS & 1) for i in ids):
                    assert all(holder[i % RING_SLOTS] == i for i in ids)
                    held[actor] |= set(ids)
                    got[actor] += ids
                    at[actor] += 1
            else:
                for i in ids:
                    held[actor].discard(i)
                    empty[i % RING_SLOTS].arrive()
                at[actor] += 1
    assert got[0] == got[1] == list(range(len(STREAM)))
    assert produced == len(STREAM)


# ---- the A fragments ----------------------------------------------------------

def lane_addresses(k, s):
    """add_source's ldmatrix address of every (g, u, w, lane, step t): byte
    offsets from the block's base."""
    st = stage(k)
    steps = st["k_steps"][s]
    g, u, w, lane, t = np.meshgrid(np.arange(GROUPS), np.arange(st["units_per_warpgroup"]),
                                   np.arange(4), np.arange(32), np.arange(steps), indexing="ij")
    m = np.minimum((g + GROUPS * u) * UNIT_PIXELS + 16 * w + (lane & 15), st["pixels"] - 1)
    shift, sin = k - s - 1, SIDES[s]
    p0 = (m // st["side"] + shift) * sin + m % st["side"] + shift
    group, tap = t // 18, (t % 18) >> 1
    chunk = group * 4 + ((t & 1) << 1) + (lane >> 4)
    q = p0 + (tap // 3) * sin + tap % 3
    swz = (q & 7) if s == 0 else ((q >> 1) & 3)
    return BUF[s] + q * ROW_BYTES[s] + ((chunk ^ swz) << 4)


def gather_a(smem, addresses):
    """What ldmatrix.x4 gives each warp, as wgmma's A: (g, u, 64 rows,
    steps * 16 k).  Lane l's 16-byte row is A row 16 w + l % 16, k 8 (l // 16)
    .. + 7 of the step."""
    rows = smem[addresses[..., None] // 2 + np.arange(8)]  # (g, u, w, lane, t, 8)
    gs, us, _, _, steps, _ = rows.shape
    a = np.zeros((gs, us, 4, 16, steps, 16), np.float32)
    lane = np.arange(32)
    for half in range(2):
        lanes = lane[lane // 16 == half]
        a[:, :, :, lanes % 16, :, 8 * half:8 * half + 8] = rows[:, :, :, lanes]
    return a.reshape(gs, us, 64, steps * 16)


def x_window(x, b, ty0, tx0):
    """The (26, 26, 64) box TMA loads at (0, tx0 - 5, ty0 - 5, b): zeros
    outside the image."""
    _, h, w, _ = x.shape
    side = SIDES[0]
    out = np.zeros((side, side, C), np.float32)
    y0, x0 = ty0 - HALO, tx0 - HALO
    ys, xs = slice(max(y0, 0), min(y0 + side, h)), slice(max(x0, 0), min(x0 + side, w))
    out[ys.start - y0:ys.stop - y0, xs.start - x0:xs.stop - x0] = x[b, ys, xs]
    return out


def tma_write_x(smem, window):
    q, c = np.meshgrid(np.arange(SIDES[0] ** 2), np.arange(C), indexing="ij")
    smem[swizzle(BUF[0] + 128 * q + 2 * c) // 2] = window.reshape(-1, C)


def o_address(k, m, n):
    """The epilogue's byte of pixel m, channel n of o_k's buffer."""
    return BUF[k] + m * ROW_BYTES[k] + (((n >> 3) ^ ((m >> 1) & 3)) << 4) + (n & 7) * 2


def expected_a(values, k, s):
    """Stage k's A from source s: rows the units' (clamped) pixels, k in the
    kernel's order, values the source region ``values`` (side_s^2, Cin)."""
    _, _, clamped = unit_rows(k)
    st = stage(k)
    shift, sin = k - s - 1, SIDES[s]
    r, c = clamped // st["side"], clamped % st["side"]
    cols = []
    for t in range(st["k_steps"][s]):
        group, tap = t // 18, (t % 18) // 2
        ch = 32 * group + 16 * (t % 2)
        q = (r + shift + tap // 3) * sin + c + shift + tap % 3
        cols.append(values[q][..., ch:ch + 16])  # (g, u, w, 16 r, 16)
    a = np.concatenate(cols, axis=-1)
    return a.reshape(GROUPS, st["units_per_warpgroup"], 64, -1)


@pytest.mark.parametrize("origin", [(0, 0), (16, 32), (48, 16)], ids=["corner", "inside", "edge"])
@pytest.mark.parametrize("k", range(1, 6))
def test_ldmatrix_addresses_give_back_the_tap_shifted_x(k, origin):
    x = np.random.default_rng(k).random((1, 64, 48, C)).astype(np.float32) + 1.0
    window = x_window(x, 0, *origin)
    smem = np.full(SMEM_VALUES, np.nan, np.float32)
    tma_write_x(smem, window)
    a = gather_a(smem, lane_addresses(k, 0))
    assert not np.isnan(a).any()
    np.testing.assert_array_equal(a, expected_a(window.reshape(-1, C), k, 0))
    if origin == (0, 0):  # the halo above and left of the image is TMA's zeros
        assert not window[:HALO].any() and not window[:, :HALO].any()


@pytest.mark.parametrize("k,s", [(k, s) for k in range(2, 6) for s in range(1, k)])
def test_ldmatrix_addresses_give_back_the_tap_shifted_o(k, s):
    side = SIDES[s]
    values = np.random.default_rng(10 * k + s).random((side * side, G)).astype(np.float32) + 1.0
    smem = np.full(SMEM_VALUES, np.nan, np.float32)
    m, n = np.meshgrid(np.arange(side * side), np.arange(G), indexing="ij")
    smem[o_address(s, m, n) // 2] = values
    a = gather_a(smem, lane_addresses(k, s))
    assert not np.isnan(a).any()
    np.testing.assert_array_equal(a, expected_a(values, k, s))


@pytest.mark.parametrize("s", range(5))
def test_ldmatrix_phases_conflict_at_most_two_ways(s):
    """The eight rows of an ldmatrix phase are eight consecutive region
    pixels: the swizzle puts them in eight bank groups, except where they
    wrap a region row (the source's rows are wider than the stage's), which
    costs at most a second pass; stage 5's rows of 16 never wrap inside a
    phase.  Clamped rows repeat an address, which is one read."""
    for k in range(s + 1, 6):
        rows = np.moveaxis(lane_addresses(k, s), 3, -1).reshape(-1, 32)
        worst = 1
        for phase in range(4):
            for lanes in rows[:, 8 * phase:8 * phase + 8]:
                distinct = np.unique(lanes)
                worst = max(worst, np.bincount((distinct % 128) // 16, minlength=8).max())
        assert worst <= (1 if k == 5 else 2), (k, s, worst)


# ---- the epilogue -------------------------------------------------------------

def accumulator_places(k):
    """(g, u, h, thread, register) -> (unit, row, column n) of wgmma's
    accumulator (hopper.cuh's layout): thread t of the warpgroup holds rows
    16 (t / 32) + (t % 32) / 4 (+ 8) and columns 8 j + 2 (t % 4) + {0, 1},
    register 4 j + 2 half + {0, 1}; half h of stage 5 adds 32 columns."""
    st = stage(k)
    g, u, h, t, e = np.meshgrid(np.arange(GROUPS), np.arange(st["units_per_warpgroup"]),
                                np.arange(st["halves"]), np.arange(128), np.arange(16),
                                indexing="ij")
    j, within = e // 4, e % 4
    row = 16 * (t // 32) + (t % 32) // 4 + 8 * (within // 2)
    n = G * h + 8 * j + 2 * (t % 4) + within % 2
    return g + GROUPS * u, row, n


@pytest.mark.parametrize("k", range(1, 6))
def test_accumulator_places_cover_o_and_the_output_once(k):
    st = stage(k)
    unit, row, n = accumulator_places(k)
    m = unit * UNIT_PIXELS + row
    stored = (unit < st["units"]) & (m < st["pixels"])
    if k < 5:
        where = o_address(k, m[stored], n[stored])
        assert len(np.unique(where)) == st["pixels"] * G == where.size
        assert where.min() >= BUF[k] and where.max() < BUF[k] + PLAN["buffers"][f"o{k}"]
        assert (where % 4 == 0)[n[stored] % 2 == 0].all()  # bf16 pairs, one 4-byte store
    else:
        pixel = m[stored] * C + n[stored]
        assert len(np.unique(pixel)) == T * T * C == pixel.size


# ---- the whole tile model -------------------------------------------------------

@functools.lru_cache(maxsize=None)
def trained_packed(name):
    state = load_generator_params(os.path.join(ROOT, "assets", "inenv10_esrnet_ema.npz"))
    convs = [(state[f"{name}.conv{k}.weight"], state[f"{name}.conv{k}.bias"]) for k in range(1, 6)]
    return pack_rdb_weights([w for w, _ in convs], [b for _, b in convs], C, G, torch.bfloat16)


def model_tile(smem, boxes, bias, b, ty0, tx0, h, w, out):
    """One block: stages 1-5 in the kernel's order, reading A at the lanes'
    addresses and B through the descriptors out of the ring, each source's
    f32 conv rounded to bf16 and summed in bf16, written back by the
    epilogue's addresses; the output tile into ``out``."""
    point2 = rnd(np.float32(0.2))
    for k in range(1, 6):
        st = stage(k)
        total = None
        for s in range(k):
            a = gather_a(smem, lane_addresses(k, s))
            bmat = read_pair(boxes, k, s)  # (N, steps * 16), k-steps read box by box
            acc = rnd(a @ bmat.T)          # (g, u, 64, N) f32 products, one rounding
            total = acc if s == 0 else rnd(total + acc)
        unit, row, n = accumulator_places(k)
        m = unit * UNIT_PIXELS + row
        u_local = (unit - unit % GROUPS) // GROUPS
        value = total[unit % GROUPS, u_local, row, n]
        stored = (unit < st["units"]) & (m < st["pixels"])
        m, n, value = m[stored], n[stored], value[stored]
        v = rnd(value + rnd(bias[k - 1, n]))
        r, c = m // st["side"], m % st["side"]
        gy, gx = ty0 - (HALO - k) + r, tx0 - (HALO - k) + c
        if k < 5:
            inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
            v = np.where(v >= 0, v, rnd(v * point2))
            smem[o_address(k, m, n) // 2] = np.where(inside, v, 0.0)
        else:
            px = (r + HALO) * SIDES[0] + c + HALO
            xv = smem[swizzle(BUF[0] + 128 * px + 2 * n) // 2]
            y = rnd(rnd(v * point2) + xv)
            keep = (gy < h) & (gx < w)
            out[b, gy[keep], gx[keep], n[keep]] = y[keep]


def tile_model(x, packed):
    """``fused_rdb`` in bfloat16 computed block by block as
    rdb_bf16_wgmma_kernel does."""
    xb = x.float().numpy()
    boxes = box_rdb_weights(packed).float().numpy()
    bias = packed[5].numpy()
    bsz, h, w, _ = x.shape
    out = np.full(x.shape, np.nan, np.float32)
    for b in range(bsz):
        for ty0 in range(0, h, T):
            for tx0 in range(0, w, T):
                smem = np.full(SMEM_VALUES, np.nan, np.float32)
                tma_write_x(smem, x_window(xb, b, ty0, tx0))
                model_tile(smem, boxes, bias, b, ty0, tx0, h, w, out)
    assert not np.isnan(out).any()
    return torch.from_numpy(out)


@pytest.mark.parametrize("shape,seed", [((1, 32, 48, C), 0), ((2, 20, 28, C), 1), ((1, 5, 3, C), 2),
                                        ((3, 17, 40, C), 3)],
                         ids=["aligned", "ragged", "smaller_than_a_tile", "three_ragged"])
def test_tile_model_matches_plain_bf16(shape, seed):
    packed = trained_packed("trunk.11.rdb2")
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=g) * 0.5).to(torch.bfloat16)
    torch.testing.assert_close(tile_model(x, packed), rdb_plain(x, packed).float(),
                               atol=2e-2, rtol=2e-2)


# ---- the cache of the boxes ---------------------------------------------------------

def test_block_keeps_its_boxes_beside_its_pack():
    """ResidualDenseBlock lays out its cached bfloat16 pack once and drops the
    boxes with the pack: after load_state_dict they are the new weights';
    another pack is laid out anew and not kept; a float32 pack keeps none."""
    from real_esrgan_tpu_torch.models.rrdbnet import ResidualDenseBlock

    block = ResidualDenseBlock(C, G)
    state = load_generator_params(os.path.join(ROOT, "assets", "inenv10_esrnet_ema.npz"))

    def load(name):
        block.load_state_dict({k[len(name) + 1:]: v for k, v in state.items()
                               if k.startswith(name + ".")})

    with torch.no_grad():
        load("trunk.0.rdb1")
        boxes = block.box_weights(block.packed_weights(torch.bfloat16))
        assert block.box_weights(block.packed_weights(torch.bfloat16)) is boxes
        assert torch.equal(boxes, box_rdb_weights(trained_packed("trunk.0.rdb1")))
        assert boxes.dtype == torch.bfloat16 and boxes.numel() * 2 == 124 * BOX_BYTES
        load("trunk.22.rdb3")
        fresh = block.box_weights(block.packed_weights(torch.bfloat16))
        assert fresh is not boxes
        assert torch.equal(fresh, box_rdb_weights(trained_packed("trunk.22.rdb3")))
        other = trained_packed("trunk.0.rdb1")
        assert block.box_weights(other) is not block.box_weights(other)
        block.packed_weights(torch.float32)  # another pack: the boxes go with the old one
        assert block._boxes is None
        assert block.box_weights(block.packed_weights(torch.bfloat16)) is not fresh


def test_box_k_is_a_128_byte_row():
    assert BOX_K * 2 == 128 and BOX_ROWS * BOX_K * 2 == BOX_BYTES == 4096
