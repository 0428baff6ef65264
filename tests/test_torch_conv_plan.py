"""The geometry and operand layouts of the conv3x3 kernel (csrc/conv3x3.cu on
csrc/hopper.cuh), on the CPU: the executable spec of what the kernel
computes where.

* ``conv3x3_plan``: the channel slice BN, the ring's stages and the shared
  memory within a block's limit, the persistent grid; the kernels built
  cover every plan.
* The input window as TMA lays it down (4-D box, 128-byte swizzle, zeros
  outside the image and past Cin) and every lane's ldmatrix address for
  each unit and k step: the fragments gathered must be the tap-shifted x,
  halo zeros included, and each 8-lane phase must hit 8 bank groups.
* The K-major weight boxes and the wgmma descriptor of each k step: the
  B slice read back must be the weights; a wrong SBO, LBO or swizzle shows
  as a permutation.
* The epilogue: accumulators into the 64-byte-swizzled staging boxes that
  the TMA store reads, every element once, free of bank conflicts.
* The work schedule: every (batch, row tile, column, slice) once, the
  slices of a pixel tile walked side by side, and the ring of windows
  played out with its mbarrier parities.
* The whole model, built from the pieces above, against ``conv3x3_plain``
  at the shapes the card tests and chip_smoke.py give the kernel (at the
  tool's default shape for the sub-tiles of four blocks, the first and last
  group's two slices).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_mm_plan import Mbarrier, fields, smem_desc, swizzle

from real_esrgan_tpu_torch.ops.conv3x3 import (
    ALIGN, CHANNEL_BOX, H100_SMS, K_BOX, KERNEL_COLS, KERNEL_ROWS, MAX_STAGES, MBARRIER_BYTES,
    OUT_BOX_BYTES, OUT_BOX_CHANNELS, SMEM_LIMIT, THREADS, WIDTHS, WINDOW_BOX_BYTES, WINDOW_COLS,
    WINDOW_ROWS, WINDOW_STRIDE, conv3x3, conv3x3_plain, conv3x3_plan, k_major_weights,
)
from real_esrgan_tpu_torch.ops.resize import true_f32

torch.set_num_threads(2)

# (B, H, W, Cin), Cout, tile: the card tests' and chip_smoke.py's shapes
SHAPES = [((8, 256, 256, 64), 192, 32), ((2, 16, 32, 32), 96, 8), ((1, 64, 48, 64), 64, 16),
          ((2, 64, 48, 32), 96, 16)]
SHAPE_IDS = ["tool_default", "small_cin32", "w48", "cin32_w48"]
# the (BN, channel boxes) kernels csrc/conv3x3.cu instantiates
BUILT = {(96, 1), (64, 1), (32, 1), (64, 2), (32, 2)}
PIXELS = KERNEL_ROWS * KERNEL_COLS  # 128 a sub-tile


# ---- the plan -----------------------------------------------------------

@pytest.mark.parametrize("shape,cout,tile", SHAPES, ids=SHAPE_IDS)
def test_plan_fits_a_block_and_covers_the_output(shape, cout, tile):
    b, h, w, cin = shape
    plan = conv3x3_plan(b, h, w, cin, cout, tile)
    bn, stages, cb = plan["bn"], plan["stages"], plan["channel_boxes"]
    assert cout % bn == 0 and (bn, cb) in BUILT and plan["threads"] == THREADS == 288
    assert 2 <= stages <= MAX_STAGES
    weights = plan["k_boxes"] * bn * 128
    staging = 2 * bn // OUT_BOX_CHANNELS * OUT_BOX_BYTES
    assert plan["smem_bytes"] == ALIGN + weights + stages * cb * WINDOW_STRIDE + staging + \
        (2 * stages + 1) * MBARRIER_BYTES <= SMEM_LIMIT
    assert plan["weight_tx_bytes"] == weights and plan["window_tx_bytes"] == cb * WINDOW_BOX_BYTES
    assert plan["pixel_tiles"] == b * (h // tile) * (w // KERNEL_COLS)
    assert plan["items"] == plan["pixel_tiles"] * plan["slices"] == \
        plan["pixel_tiles"] * cout // bn
    assert plan["grid"] == plan["groups"] * plan["slices"] <= H100_SMS
    assert plan["groups"] <= plan["pixel_tiles"]
    # every unit's k steps stay inside the loaded weight boxes
    assert 8 * cin + CHANNEL_BOX * cb <= K_BOX * plan["k_boxes"]


def test_tool_default_plan_is_the_designed_one():
    plan = conv3x3_plan(8, 256, 256, 64, 192, 32)
    assert (plan["bn"], plan["stages"], plan["grid"], plan["groups"]) == (96, 4, 132, 66)
    assert plan["weight_tx_bytes"] == 110_592 and plan["smem_bytes"] == 230_472
    assert plan["items"] == 2048 and plan["k_boxes"] == 9


@pytest.mark.parametrize("cin", range(16, 129, 16))
def test_every_plan_is_a_built_kernel(cin):
    for cout in range(32, 513, 32):
        try:
            plan = conv3x3_plan(1, 8, 16, cin, cout, 8)
        except ValueError:
            continue
        assert (plan["bn"], plan["channel_boxes"]) in BUILT, (cin, cout)
        wider = [bn for bn in WIDTHS if bn > plan["bn"] and cout % bn == 0]
        for bn in wider:  # a wider slice would not have fit
            fixed = ALIGN + plan["k_boxes"] * bn * 128 + 2 * bn // 32 * OUT_BOX_BYTES + 8
            assert fixed + 2 * (plan["channel_boxes"] * WINDOW_STRIDE + 16) > SMEM_LIMIT


def test_plan_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="Cin up to 128"):
        conv3x3_plan(1, 8, 16, 144, 32, 8)
    with pytest.raises(ValueError, match="Cin up to 128"):
        conv3x3(torch.zeros(1, 8, 16, 144, dtype=torch.bfloat16), torch.zeros(3, 3, 144, 32),
                tile=8)


def test_plan_follows_the_sm_count():
    plan = conv3x3_plan(8, 256, 256, 64, 192, 32, sms=114)
    assert plan["grid"] == 114 and plan["groups"] == 57
    assert conv3x3_plan(1, 8, 16, 64, 192, 8, sms=132)["grid"] == 2  # one pixel tile


# ---- the input window and the A fragments ------------------------------

def window_values(x, b, y0, x0, cb):
    """The (10, 18, 64 cb) window TMA loads at (0, x0 - 1, y0 - 1, b): zero
    outside the image and past Cin."""
    _, h, w, cin = x.shape
    out = np.zeros((WINDOW_ROWS, WINDOW_COLS, CHANNEL_BOX * cb), np.float32)
    ys, xs = slice(max(y0 - 1, 0), min(y0 - 1 + WINDOW_ROWS, h)), \
        slice(max(x0 - 1, 0), min(x0 - 1 + WINDOW_COLS, w))
    out[ys.start - y0 + 1:ys.stop - y0 + 1, xs.start - x0 + 1:xs.stop - x0 + 1, :cin] = \
        x[b, ys, xs]
    return out


def tma_write_window(values):
    """The window's boxes as TMA lays them in shared memory: box k (64
    channels) at k * WINDOW_STRIDE, pixel q = 18 wy + wx at 128 q, channel c
    at 2 c, with the 128-byte swizzle.  One value per 2 bytes."""
    cb = values.shape[2] // CHANNEL_BOX
    smem = np.full(cb * WINDOW_STRIDE // 2, np.nan, np.float32)
    wy, wx, c = np.meshgrid(np.arange(WINDOW_ROWS), np.arange(WINDOW_COLS),
                            np.arange(CHANNEL_BOX * cb), indexing="ij")
    address = (c // CHANNEL_BOX) * WINDOW_STRIDE + 128 * (wy * WINDOW_COLS + wx) + \
        2 * (c % CHANNEL_BOX)
    smem[swizzle(address) // 2] = values
    return smem


def lane_addresses(cb):
    """load_unit's ldmatrix address of every (warp, lane, unit, k step):
    (8, 32, 9 cb, 4) byte offsets into the window stage."""
    orow, lane, u, kk = np.meshgrid(np.arange(8), np.arange(32), np.arange(9 * cb), np.arange(4),
                                    indexing="ij")
    tap, box = u // cb, u % cb
    q = orow * WINDOW_COLS + (lane & 15) + (tap // 3) * WINDOW_COLS + tap % 3
    swz = (lane >> 4) ^ (q & 7)
    return box * WINDOW_STRIDE + 128 * q + 16 * ((2 * kk) ^ swz)


def gather_fragments(smem, addresses):
    """What ldmatrix.x4 gives: each lane's 16-byte row (8 values) at its
    address; lane l's row is fragment row l % 16, columns 8 (l // 16) ..
    + 7.  Returns (units, 4 k steps, 128 pixels, 16 channels): pixel
    16 warp + row."""
    rows = smem[addresses[..., None] // 2 + np.arange(8)]  # (8, 32, U, 4, 8)
    lane = np.arange(32)
    frag = np.zeros((addresses.shape[2], 4, 8, 16, 16), np.float32)
    for half in range(2):
        lanes = lane[lane // 16 == half]
        frag[:, :, :, lanes % 16, 8 * half:8 * half + 8] = rows[:, lanes].transpose(2, 3, 0, 1, 4)
    return frag.reshape(addresses.shape[2], 4, PIXELS, 16)


def shifted(values, tap, box, kk):
    """The A tile unit (tap, box) k step kk should see: output pixel
    (row, col) takes window pixel (row + dy, col + dx), channels
    64 box + 16 kk .. + 15."""
    dy, dx = divmod(tap, 3)
    c0 = CHANNEL_BOX * box + 16 * kk
    return values[dy:dy + KERNEL_ROWS, dx:dx + KERNEL_COLS, c0:c0 + 16].reshape(PIXELS, 16)


@pytest.mark.parametrize("cin", [16, 32, 64, 96, 128])
@pytest.mark.parametrize("y0,x0", [(0, 0), (8, 16), (56, 32)], ids=["corner", "inside", "edge"])
def test_ldmatrix_addresses_give_back_the_tap_shifted_window(cin, y0, x0):
    x = np.random.default_rng(cin).random((1, 64, 48, cin)).astype(np.float32) + 1.0
    cb = -(-cin // CHANNEL_BOX)
    values = window_values(x, 0, y0, x0, cb)
    frag = gather_fragments(tma_write_window(values), lane_addresses(cb))
    assert not np.isnan(frag).any()
    for u in range(9 * cb):
        for kk in range(4):
            np.testing.assert_array_equal(frag[u, kk], shifted(values, u // cb, u % cb, kk))
    # the halo outside the image and the channels past Cin are zeros
    if y0 == 0:
        assert not frag[0, :, :KERNEL_COLS].any()  # tap (0, 0), output row 0: image row -1
    if cin % CHANNEL_BOX:
        assert not frag[cb - 1, (cin % CHANNEL_BOX) // 16:].any()


def test_each_ldmatrix_phase_hits_eight_bank_groups():
    addresses = lane_addresses(2)
    for phase in range(4):
        groups = (addresses[:, 8 * phase:8 * phase + 8] % 128) // 16  # (8, 8 lanes, U, 4)
        assert (np.sort(groups, axis=1) == np.arange(8)[None, :, None, None]).all()


def test_window_read_without_the_swizzle_is_a_permutation():
    x = np.random.default_rng(1).random((1, 16, 32, 64)).astype(np.float32) + 1.0
    values = window_values(x, 0, 8, 16, 1)
    plain = np.full(WINDOW_STRIDE // 2, np.nan, np.float32)
    wy, wx, c = np.meshgrid(np.arange(WINDOW_ROWS), np.arange(WINDOW_COLS), np.arange(64),
                            indexing="ij")
    plain[(128 * (wy * WINDOW_COLS + wx) + 2 * c) // 2] = values  # laid down unswizzled
    frag = gather_fragments(plain, lane_addresses(1))
    assert not np.array_equal(frag[4, 0], shifted(values, 4, 0, 0))
    assert np.isin(frag[4, 0], values).all()  # codes of the window, in the wrong places


# ---- the weights and the B descriptors ---------------------------------

def weight_boxes(wk, n0, bn, k_boxes):
    """The block's resident slice: k_boxes TMA boxes of bn rows x 64 k of the
    K-major weights (zeros past 9 Cin), box u at u * bn * 128, 128-byte
    swizzled."""
    padded = np.zeros((bn, K_BOX * k_boxes), np.float32)
    padded[:, :wk.shape[1]] = wk[n0:n0 + bn]
    smem = np.full(k_boxes * bn * 64, np.nan, np.float32)
    n, k = np.meshgrid(np.arange(bn), np.arange(K_BOX * k_boxes), indexing="ij")
    smem[swizzle((k // K_BOX) * bn * 128 + 128 * n + 2 * (k % K_BOX)) // 2] = padded
    return smem, padded


def b_descriptor(bn, cin, cb, u, kk, lbo=16, sbo=1024):
    """issue_unit's descriptor of unit u's k step kk."""
    k = (u // cb) * cin + (u % cb) * CHANNEL_BOX + 16 * kk
    return smem_desc((k // K_BOX) * bn * 128 + 32 * ((k % K_BOX) // 16), lbo, sbo), k


def read_b(smem, desc, bn):
    """The 16 x bn B slice wgmma reads through a K-major descriptor (no
    transpose bit), as (bn, 16): row n at SBO (n // 8) + 128 (n % 8), k
    element j at 2 j, then the swizzle."""
    f = fields(desc)
    assert f["layout"] == 1 and f["base_offset"] == 0
    n, j = np.meshgrid(np.arange(bn), np.arange(16), indexing="ij")
    return smem[swizzle(f["start"] + (n // 8) * f["sbo"] + (n % 8) * 128 + 2 * j) // 2]


@pytest.mark.parametrize("cin,cout", [(64, 192), (32, 96), (64, 64), (96, 128), (16, 32)])
def test_k_major_descriptors_give_back_the_weights(cin, cout):
    w = np.random.default_rng(cin + cout).standard_normal((3, 3, cin, cout)).astype(np.float32)
    wk = k_major_weights(torch.from_numpy(w)).float().numpy()
    np.testing.assert_array_equal(wk.reshape(cout, 3, 3, cin),
                                  torch.from_numpy(w).bfloat16().float().numpy().transpose(3, 0, 1, 2))
    plan = conv3x3_plan(1, 8, 16, cin, cout, 8)
    bn, cb, k_boxes = plan["bn"], plan["channel_boxes"], plan["k_boxes"]
    for n0 in range(0, cout, bn):
        smem, padded = weight_boxes(wk, n0, bn, k_boxes)
        for u in range(9 * cb):
            for kk in range(4):
                desc, k = b_descriptor(bn, cin, cb, u, kk)
                np.testing.assert_array_equal(read_b(smem, desc, bn), padded[:, k:k + 16])


def test_descriptor_faults_show_as_permutations():
    """SBO and LBO swapped, or the boxes laid down without the swizzle, do
    not give the weights back."""
    wk = np.arange(96 * 576, dtype=np.float32).reshape(96, 576)
    smem, padded = weight_boxes(wk, 0, 96, 9)
    desc, k = b_descriptor(96, 64, 1, 4, 1)
    assert np.array_equal(read_b(smem, desc, 96), padded[:, k:k + 16])
    swapped, _ = b_descriptor(96, 64, 1, 4, 1, lbo=1024, sbo=16)
    assert not np.array_equal(read_b(smem, swapped, 96), padded[:, k:k + 16])
    plain = np.full_like(smem, np.nan)
    n, kk = np.meshgrid(np.arange(96), np.arange(576), indexing="ij")
    plain[((kk // 64) * 96 * 128 + 128 * n + 2 * (kk % 64)) // 2] = padded
    read = read_b(plain, desc, 96)
    assert not np.array_equal(read, padded[:, k:k + 16])
    assert np.isin(read, padded).all()  # codes of the weights, in the wrong places


# ---- the epilogue -------------------------------------------------------

def out_offset(r, n):
    """conv3x3.cu's out_offset: the byte of pixel r (0..63), channel n (a
    multiple of 8) in a warpgroup's staging tile."""
    return (n // OUT_BOX_CHANNELS) * OUT_BOX_BYTES + 64 * r + \
        16 * (((n % OUT_BOX_CHANNELS) >> 3) ^ ((r >> 1) & 3))


def swizzle64(address):
    """The 64-byte swizzle: address bits 4-5 XOR bits 7-8."""
    return address ^ (((address >> 7) & 3) << 4)


def accumulator_places(bn):
    """(thread, register) -> (pixel, channel, staging byte) for the 256
    consumer threads: wgmma's accumulator layout (hopper.cuh) in warpgroup
    g = t // 128, pixel 64 g + row of the sub-tile, stored as bf16 pairs
    into the warpgroup's half of the staging tile (bn / 32 boxes of 4096
    bytes from g bn / 32 boxes on)."""
    t, reg = np.meshgrid(np.arange(256), np.arange(bn // 2), indexing="ij")
    lane, j, within = t % 32, reg // 4, reg % 4
    row = 16 * ((t % 128) // 32) + lane // 4 + 8 * (within // 2)
    pixel = 64 * (t // 128) + row
    channel = 8 * j + 2 * (lane % 4) + within % 2
    byte = (t // 128) * (bn // 32) * OUT_BOX_BYTES + out_offset(row, 8 * j) + \
        4 * (lane % 4) + 2 * (within % 2)
    return pixel, channel, byte


@pytest.mark.parametrize("bn", WIDTHS)
def test_epilogue_writes_the_boxes_the_tma_store_reads(bn):
    pixel, channel, byte = accumulator_places(bn)
    assert len(np.unique(byte)) == PIXELS * bn  # every element written once
    tile = np.random.default_rng(bn).permutation(PIXELS * bn).reshape(PIXELS, bn)
    smem = np.full(2 * bn // 32 * OUT_BOX_BYTES // 2, -1)
    smem[byte // 2] = tile[pixel, channel]
    # warpgroup g's TMA store of its box j (32 channels, 16 pixels, 4 rows,
    # 1) at output rows 4 g .. 4 g + 3, 64-byte swizzled
    r, c = np.meshgrid(np.arange(PIXELS), np.arange(bn), indexing="ij")
    g, rg = r // 64, r % 64
    linear = (g * (bn // 32) + c // 32) * OUT_BOX_BYTES + 2 * (rg * 32 + c % 32)
    np.testing.assert_array_equal(smem[swizzle64(linear) // 2], tile)


@pytest.mark.parametrize("bn", WIDTHS)
def test_epilogue_stores_are_free_of_bank_conflicts(bn):
    _, _, byte = accumulator_places(bn)
    for warp in range(8):
        for reg in range(0, bn // 2, 2):  # one 4-byte store a pair of registers
            words = byte[32 * warp:32 * warp + 32, reg] // 4
            assert len(np.unique(words % 32)) == 32


# ---- the schedule -------------------------------------------------------

def schedule(plan, h, w, tile):
    """Each block's walk, as the producer and the consumers make it:
    [(b, ty, tx, sub, slice), ...] for block i."""
    tiles_x, tiles_y, subs = w // KERNEL_COLS, h // tile, tile // KERNEL_ROWS
    walks = []
    for block in range(plan["grid"]):
        slice_, group = block % plan["slices"], block // plan["slices"]
        walk = []
        for p in range(group, plan["pixel_tiles"], plan["groups"]):
            tx, ty, b = p % tiles_x, (p // tiles_x) % tiles_y, p // (tiles_x * tiles_y)
            walk += [(b, ty, tx, sub, slice_) for sub in range(subs)]
        walks.append(walk)
    return walks


@pytest.mark.parametrize("shape,cout,tile", SHAPES + [((1, 8, 16, 64), 192, 8),
                                                     ((3, 40, 64, 64), 128, 8)],
                         ids=SHAPE_IDS + ["one_tile", "more_sms_than_tiles"])
def test_schedule_covers_every_item_once_with_slices_paired(shape, cout, tile):
    b, h, w, cin = shape
    plan = conv3x3_plan(b, h, w, cin, cout, tile)
    walks = schedule(plan, h, w, tile)
    done = [item for walk in walks for item in walk]
    want = {(bi, ty, tx, sub, s) for bi in range(b) for ty in range(h // tile)
            for tx in range(w // KERNEL_COLS) for sub in range(tile // KERNEL_ROWS)
            for s in range(cout // plan["bn"])}
    assert len(done) == len(set(done)) == len(want) and set(done) == want
    slices = plan["slices"]
    for group in range(plan["groups"]):  # the slices of a pixel tile go side by side
        pixels = [[item[:4] for item in walks[group * slices + s]] for s in range(slices)]
        assert all(p == pixels[0] for p in pixels)
    lengths = {len(walk) for walk in walks}
    assert max(lengths) - min(lengths) <= tile // KERNEL_ROWS and min(lengths) > 0


@pytest.mark.parametrize("windows,stages", [(1, 2), (7, 4), (16, 4), (9, 3), (5, 2)])
def test_ring_delivers_every_window_once_in_order_and_never_overwrites(windows, stages):
    """The producer and the consumers of csrc/conv3x3.cu played out with
    their parities: window n goes to stage n % S once empty passes parity
    (n // S & 1) ^ 1 (an expect_tx arrival, TMA's bytes later; in mode dots
    a plain arrival); the consumers wait full at parity n // S & 1 and
    release the stage when done with the window (the 256 threads as one)."""
    tx = WINDOW_BOX_BYTES
    for dots in (False, True):
        full = [Mbarrier(1) for _ in range(stages)]
        empty = [Mbarrier(1) for _ in range(stages)]
        holder, pending, produced, consumed = [None] * stages, [], 0, []
        reading = None
        for _ in range(10 * windows + 10):
            if produced < windows:
                s = produced % stages
                if empty[s].try_wait((produced // stages & 1) ^ 1):
                    assert s != reading, f"stage {s} reloaded while window {holder[s]} is read"
                    full[s].arrive(expect_tx=0 if dots else tx)
                    holder[s] = produced
                    if not dots:
                        pending.append(s)
                    produced += 1
            if pending:
                full[pending.pop(0)].transfer(tx)
            if reading is not None:  # the consumers finish the window they read
                empty[reading].arrive()
                reading = None
            c = len(consumed)
            if c < windows and full[c % stages].try_wait(c // stages & 1):
                assert holder[c % stages] == c
                consumed.append(c)
                reading = c % stages
        assert consumed == list(range(windows))


# ---- the whole model ----------------------------------------------------

def model_subtile(x, wk_boxes, plan, cin, b, y0, x0, n0, addresses):
    """One sub-tile of one slice as the kernel computes it, in f32: the
    window laid down by TMA, every unit's A fragments gathered at the
    lanes' ldmatrix addresses, each k step's B read through its descriptor,
    summed over the 9 CB units of four k steps."""
    cb, bn = plan["channel_boxes"], plan["bn"]
    frag = gather_fragments(tma_write_window(window_values(x, b, y0, x0, cb)), addresses)
    acc = np.zeros((PIXELS, bn), np.float32)
    for u in range(9 * cb):
        for kk in range(4):
            desc, _ = b_descriptor(bn, cin, cb, u, kk)
            acc += frag[u, kk] @ read_b(wk_boxes[n0], desc, bn).T
    return acc.reshape(KERNEL_ROWS, KERNEL_COLS, bn)


def plain_region(xt, wt, b, y0, x0, n0, bn):
    """conv3x3_plain's arithmetic (true f32 on bf16-rounded operands) on the
    sub-tile's window alone: (8, 16, bn) f32."""
    xp = F.pad(xt[b:b + 1].float(), (0, 0, 1, 1, 1, 1))
    crop = xp[:, y0:y0 + WINDOW_ROWS, x0:x0 + WINDOW_COLS].permute(0, 3, 1, 2)
    with true_f32():
        out = F.conv2d(crop, wt[..., n0:n0 + bn].float().permute(3, 2, 0, 1))
    return out[0].permute(1, 2, 0).numpy()


@pytest.mark.parametrize("shape,cout,tile", SHAPES, ids=SHAPE_IDS)
def test_model_matches_conv3x3_plain(shape, cout, tile):
    b, h, w, cin = shape
    rng = np.random.default_rng(cin + cout)
    xt = torch.from_numpy(rng.random(shape).astype(np.float32)).to(torch.bfloat16)
    wt = torch.from_numpy((rng.standard_normal((3, 3, cin, cout)) * 0.05).astype(np.float32))
    wt = wt.to(torch.bfloat16)
    x = xt.float().numpy()
    plan = conv3x3_plan(b, h, w, cin, cout, tile)
    bn = plan["bn"]
    wk = k_major_weights(wt).float().numpy()
    wk_boxes = {n0: weight_boxes(wk, n0, bn, plan["k_boxes"])[0] for n0 in range(0, cout, bn)}
    addresses = lane_addresses(plan["channel_boxes"])
    walks = schedule(plan, h, w, tile)
    whole = shape != SHAPES[0][0]
    blocks = range(plan["grid"]) if whole else [0, 1, plan["grid"] - 2, plan["grid"] - 1]
    out = np.full((b, h, w, cout), np.nan, np.float32)
    for block in blocks:
        for bi, ty, tx, sub, s in walks[block]:
            y0, x0, n0 = ty * tile + sub * KERNEL_ROWS, tx * KERNEL_COLS, s * bn
            acc = model_subtile(x, wk_boxes, plan, cin, bi, y0, x0, n0, addresses)
            np.testing.assert_allclose(acc, plain_region(xt, wt, bi, y0, x0, n0, bn),
                                       atol=1e-5, rtol=1e-5)
            out[bi, y0:y0 + KERNEL_ROWS, x0:x0 + KERNEL_COLS, n0:n0 + bn] = acc
    done = ~np.isnan(out)
    if whole:
        assert done.all()  # every output element written
        ref = conv3x3_plain(xt, wt).float().numpy()
        model = torch.from_numpy(out).to(torch.bfloat16).float().numpy()
        np.testing.assert_allclose(model, ref, atol=2e-2, rtol=2e-2)
        assert torch.equal(conv3x3(xt, wt, tile=tile), conv3x3_plain(xt, wt))  # the CPU route
    else:
        assert done.sum() == sum(len(walks[i]) for i in blocks) * PIXELS * bn
