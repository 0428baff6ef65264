"""The geometry and operand layouts of the two kernels of csrc/mm_probe.cu (on
csrc/hopper.cuh), mm_grid and mm_resident, on the CPU.

The models, the executable spec of what each kernel computes where:

* ``mm_grid_plan`` at every shape the experiment tool and the card tests
  (test_torch_cuda.py) give the kernel and at the ragged edges: the block width and grid, the shared
  memory (alignment, stages, mbarriers) within a block's limit, and the
  bytes each stage's full mbarrier expects (whole TMA boxes, zero fill
  included).  On the card the wrapper holds the built kernel to this plan.
* The 128-byte swizzle TMA writes, and wgmma's reading of a K-major (A) and
  an MN-major (B) tile through the 64-bit shared-memory descriptors the
  kernel builds (start address, LBO, SBO, layout bits): gathering a tile
  through the descriptors must give the tile back; and the epilogue's
  placement of wgmma's accumulators into the boxes TMA stores.
* The ring of stages (full and empty mbarriers with phase parity) played out
  step by step, and the k chunks with TMA's zero fill past k and n, computed
  block by block against ``mm_grid_plain``.
* ``mm_resident_plan`` at the same shapes (one wave at the gate's, shared
  memory and the registers a thread holds its operands in); every lane's
  loads of its A fragments against wgmma's register layout; b's resident
  slice (column boxes whose k rows run on from box to box) read back step
  by step through the descriptors; the two warpgroups' sums meeting in
  shared memory; and the whole block, step by step as the kernel issues
  it, against ``mm_resident_plain``.
"""

import numpy as np
import pytest
import torch

from real_esrgan_tpu_torch.ops.conv3x3 import SMEM_LIMIT
from real_esrgan_tpu_torch.ops.mm_probe import (
    BLOCK_ROWS, GRID_ALIGN, GRID_ATOM, GRID_BK, GRID_BOX_BYTES, GRID_WIDTHS, MBARRIER_BYTES,
    RESIDENT_WIDTHS, mm_grid, mm_grid_plain, mm_grid_plan, mm_resident, mm_resident_plain,
    mm_resident_plan,
)
from real_esrgan_tpu_torch.tools import conv_exp

torch.set_num_threads(2)

SMS = 132  # streaming multiprocessors of an H100 SXM
# the card tests' extra shapes and the ragged edges: ragged k (96) with
# m = 64, k shorter than a box, n = 32, 160 (192-wide) and 320 and 512 (two
# column blocks)
EXTRA_SHAPES = [(256, 96, 160), (128, 64, 64), (64, 96, 192), (64, 16, 64), (128, 64, 32),
                (128, 96, 160), (128, 128, 320), (64, 64, 512)]
PLAN_SHAPES = list(conv_exp.MM_SHAPES) + EXTRA_SHAPES

# the descriptor fields csrc/mm_probe.cu gives wgmma (hopper.cuh's layout contract)
A_LBO, A_SBO, A_STEP = 16, 1024, 32           # K-major: a k16 slice is 32 bytes along a row
B_LBO, B_SBO, B_STEP = GRID_BOX_BYTES, 1024, 2048  # MN-major: a k16 slice is 16 rows of 128 bytes
LAYOUT_SWIZZLE_128B = 1


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_plan_covers_the_output_and_fits_a_block(m, k, n):
    plan = mm_grid_plan(m, k, n)
    bn, stages = plan["bn"], plan["stages"]
    assert bn in GRID_WIDTHS and plan["bk"] == GRID_BK == 64
    assert bn == min(256, -(-n // 64) * 64)   # all of n up to 256, whole 64-column boxes
    assert (plan["grid_x"] - 1) * bn < n <= plan["grid_x"] * bn
    assert plan["grid_y"] * BLOCK_ROWS == m
    assert plan["threads"] == 160 and plan["cluster"] == 1
    # every box whole, its zero-filled part included: A's 64 x 64 and bn / 64 of B's
    assert plan["tx_bytes"] == (1 + bn // GRID_ATOM) * 64 * 64 * 2
    assert plan["smem_bytes"] == GRID_ALIGN + stages * (plan["tx_bytes"] + 2 * MBARRIER_BYTES)
    assert plan["smem_bytes"] <= SMEM_LIMIT == 232_448
    chunks = -(-k // GRID_BK)
    assert 1 <= stages <= min(chunks, 6)
    assert stages >= 2 or chunks == 1  # a ring of one stage would wait on itself


@pytest.mark.parametrize("m,k,n", conv_exp.GATE_SHAPES)
def test_gate_shapes_run_in_one_wave_reading_a_once(m, k, n):
    plan = mm_grid_plan(m, k, n)
    assert plan["grid_x"] == 1 and plan["grid_x"] * plan["grid_y"] <= SMS
    assert plan["bn"] == n == 192


def swizzle(address):
    """The 128-byte swizzle on a shared-memory byte address: bits 4-6 (the
    16-byte chunk in a 128-byte row) XOR bits 7-9 (the row in 1024 bytes)."""
    return address ^ (((address >> 7) & 7) << 4)


def tma_write(smem, base, box):
    """A 64 x 64 bf16 box as TMA lays it down at ``base`` (1024-aligned) with
    CU_TENSOR_MAP_SWIZZLE_128B: row r at 128 r, element c at 2 c, swizzled.
    ``smem`` holds one value per 2 bytes."""
    rows, cols = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    smem[swizzle(base + rows * 128 + cols * 2) // 2] = box


def smem_desc(address, lbo, sbo):
    """hopper.cuh's smem_desc: address, LBO and SBO in 16-byte units at bits
    0-13, 16-29 and 32-45, layout 1 (128-byte swizzle) at bits 62-63."""
    return ((address & 0x3FFFF) >> 4) | ((lbo >> 4) & 0x3FFF) << 16 | \
        ((sbo >> 4) & 0x3FFF) << 32 | LAYOUT_SWIZZLE_128B << 62


def fields(desc):
    return {"start": (desc & 0x3FFF) << 4, "lbo": ((desc >> 16) & 0x3FFF) << 4,
            "sbo": ((desc >> 32) & 0x3FFF) << 4, "base_offset": (desc >> 49) & 7,
            "layout": desc >> 62}


def read_k_major(smem, desc):
    """The 64 x 16 A slice wgmma reads through a K-major descriptor: row i at
    SBO (i // 8) + 128 (i % 8), element j at 2 j, then the swizzle."""
    f = fields(desc)
    assert f["layout"] == LAYOUT_SWIZZLE_128B and f["base_offset"] == 0
    i, j = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
    return smem[swizzle(f["start"] + (i // 8) * f["sbo"] + (i % 8) * 128 + j * 2) // 2]


def read_mn_major(smem, desc, n):
    """The 16 x n B slice wgmma reads through an MN-major descriptor (the
    transpose bit): k row j at SBO (j // 8) + 128 (j % 8), column i at LBO
    (i // 64) + 2 (i % 64), then the swizzle."""
    f = fields(desc)
    assert f["layout"] == LAYOUT_SWIZZLE_128B and f["base_offset"] == 0
    j, i = np.meshgrid(np.arange(16), np.arange(n), indexing="ij")
    address = f["start"] + (i // 64) * f["lbo"] + (j // 8) * f["sbo"] + (j % 8) * 128 + (i % 64) * 2
    return smem[swizzle(address) // 2]


def coded(rows, cols, seed):
    return np.random.default_rng(seed).permutation(rows * cols).reshape(rows, cols)


STAGE_BASE = 3 * 1024  # any 1024-aligned stage


def test_swizzle_spreads_each_column_of_eight_rows_over_eight_bank_groups():
    for col in range(0, 64, 8):
        chunks = {(swizzle(STAGE_BASE + r * 128 + col * 2) % 128) // 16 for r in range(8)}
        assert chunks == set(range(8))


@pytest.mark.parametrize("kk", range(4))
def test_k_major_descriptor_gives_back_the_a_tile(kk):
    tile = coded(64, 64, seed=kk)
    smem = np.full(64 * 1024, -1)
    tma_write(smem, STAGE_BASE, tile)
    desc = smem_desc(STAGE_BASE + A_STEP * kk, A_LBO, A_SBO)
    np.testing.assert_array_equal(read_k_major(smem, desc), tile[:, 16 * kk:16 * kk + 16])


@pytest.mark.parametrize("bn", GRID_WIDTHS)
@pytest.mark.parametrize("kk", range(4))
def test_mn_major_descriptor_gives_back_the_b_tile(bn, kk):
    tile = coded(64, bn, seed=bn + kk)  # (k, n): bn / 64 boxes side by side
    smem = np.full(64 * 1024, -1)
    b_base = STAGE_BASE + GRID_BOX_BYTES  # after A's box, as in a stage
    for j in range(bn // GRID_ATOM):
        tma_write(smem, b_base + j * GRID_BOX_BYTES, tile[:, 64 * j:64 * j + 64])
    desc = smem_desc(b_base + B_STEP * kk, B_LBO, B_SBO)
    np.testing.assert_array_equal(read_mn_major(smem, desc, bn), tile[16 * kk:16 * kk + 16])


def test_descriptor_faults_show_as_permutations():
    """The model tells the fields apart: B with LBO and SBO swapped, or A
    read without the swizzle, does not give the tile back."""
    tile = coded(64, 128, seed=7)
    smem = np.full(64 * 1024, -1)
    for j in range(2):
        tma_write(smem, STAGE_BASE + j * GRID_BOX_BYTES, tile[:, 64 * j:64 * j + 64])
    swapped = read_mn_major(smem, smem_desc(STAGE_BASE, B_SBO, B_LBO), 128)
    assert not np.array_equal(swapped, tile[:16])
    plain = smem.copy()
    rows, cols = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    plain[(STAGE_BASE + rows * 128 + cols * 2) // 2] = tile[:, :64]  # no swizzle
    assert not np.array_equal(read_k_major(plain, smem_desc(STAGE_BASE, A_LBO, A_SBO)),
                              tile[:, :16])


def wgmma_fragment(bn):
    """(thread, register) -> (row, column) of wgmma's m64nBN f32 accumulator:
    thread t holds rows 16 (t // 32) + (t % 32) // 4 (+ 8 for registers
    4 j + 2, 4 j + 3) and columns 8 j + 2 (t % 4) + {0, 1}."""
    t, reg = np.meshgrid(np.arange(128), np.arange(bn // 2), indexing="ij")
    j, within = reg // 4, reg % 4
    rows = 16 * (t // 32) + (t % 32) // 4 + 8 * (within // 2)
    cols = 8 * j + 2 * (t % 4) + within % 2
    return rows, cols


@pytest.mark.parametrize("bn", GRID_WIDTHS)
def test_epilogue_writes_the_boxes_the_tma_store_reads(bn):
    """The epilogue of csrc/mm_probe.cu puts each accumulator pair at box
    col // 64, byte r * 128 + 2 (col % 64), XOR (r % 8) << 4; TMA's store
    reads the boxes with the 128-byte swizzle.  Every element of the tile
    is written once and read back in place."""
    rows, cols = wgmma_fragment(bn)
    tile = coded(64, bn, seed=bn)
    offset = (cols // 64) * GRID_BOX_BYTES + rows * 128 + (cols % 64) * 2
    address = STAGE_BASE + (offset ^ ((rows % 8) << 4))
    assert len(np.unique(address)) == 64 * bn  # no element written twice
    smem = np.full(64 * 1024, -1)
    smem[address // 2] = tile[rows, cols]
    r, c = np.meshgrid(np.arange(64), np.arange(bn), indexing="ij")
    stored = smem[swizzle(STAGE_BASE + (c // 64) * GRID_BOX_BYTES + r * 128 + (c % 64) * 2) // 2]
    np.testing.assert_array_equal(stored, tile)


class Mbarrier:
    """An mbarrier: its current phase completes when ``count`` arrivals and
    the expected transaction bytes are in; try_wait(parity) is true while
    the current phase's parity differs from ``parity`` (so at first, for
    parity 1), as on the card, where a barrier two phases ahead looks like
    one that has not moved."""

    def __init__(self, count):
        self.count, self.phase, self.arrived, self.tx = count, 0, 0, 0

    def arrive(self, expect_tx=0):
        self.arrived += 1
        self.tx += expect_tx
        self._complete()

    def transfer(self, nbytes):
        self.tx -= nbytes
        self._complete()

    def _complete(self):
        if self.arrived == self.count and self.tx == 0:
            self.phase, self.arrived = self.phase + 1, 0

    def try_wait(self, parity):
        return self.phase % 2 != parity


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_ring_delivers_every_chunk_once_in_order_and_never_overwrites(m, k, n):
    """The producer and the consumer of csrc/mm_probe.cu played out with
    their parities: the producer loads chunk c into stage c % S once empty
    passes parity (c // S & 1) ^ 1; TMA completes the stage's bytes later;
    the consumer waits full at parity c // S & 1 and releases chunk c - 1
    after issuing c (one group in flight).  Every chunk arrives once, in
    order, and no stage is loaded while its last chunk is still read."""
    plan = mm_grid_plan(m, k, n)
    stages, tx = plan["stages"], plan["tx_bytes"]
    chunks = -(-k // GRID_BK)
    full = [Mbarrier(1) for _ in range(stages)]
    empty = [Mbarrier(1) for _ in range(stages)]  # the consumer warpgroup, as one
    holder = [None] * stages  # the chunk a stage holds or is loading
    in_use = set()            # stages whose chunk the consumer may still read
    pending, produced, consumed = [], 0, []
    for _ in range(10 * chunks + 10):
        if produced < chunks:
            s = produced % stages
            if empty[s].try_wait((produced // stages & 1) ^ 1):
                assert s not in in_use, f"stage {s} reloaded while chunk {holder[s]} is read"
                full[s].arrive(expect_tx=tx)
                holder[s] = produced
                pending.append(s)
                produced += 1
        if pending:  # TMA lands the oldest load
            full[pending.pop(0)].transfer(tx)
        c = len(consumed)
        if c < chunks and full[c % stages].try_wait(c // stages & 1):
            assert holder[c % stages] == c
            consumed.append(c)
            in_use.add(c % stages)
            if c > 0:
                in_use.discard((c - 1) % stages)
                empty[(c - 1) % stages].arrive()
    assert consumed == list(range(chunks))


def chunk_model(a, b):
    """mm_grid as the kernel computes it, in f32: blocks of 64 rows x bn
    columns; k in chunks of 64, each chunk's boxes zero past k and past n
    (TMA's fill); min(64, k - k0) / 16 steps of k16 a chunk; columns past n
    not stored."""
    (m, k), n = a.shape, b.shape[1]
    plan = mm_grid_plan(m, k, n)
    bn = plan["bn"]
    out = torch.full((m, n), float("nan"))
    for bx in range(plan["grid_x"]):
        for by in range(plan["grid_y"]):
            r0, c0 = by * BLOCK_ROWS, bx * bn
            acc = torch.zeros(BLOCK_ROWS, bn)
            for k0 in range(0, k, GRID_BK):
                a_box = torch.zeros(BLOCK_ROWS, GRID_BK)
                b_box = torch.zeros(GRID_BK, bn)
                a_part = a[r0:r0 + BLOCK_ROWS, k0:k0 + GRID_BK].float()
                b_part = b[k0:k0 + GRID_BK, c0:c0 + bn].float()
                a_box[:, :a_part.shape[1]] = a_part
                b_box[:b_part.shape[0], :b_part.shape[1]] = b_part
                for kk in range(min(GRID_BK, k - k0) // 16):
                    acc += a_box[:, 16 * kk:16 * kk + 16] @ b_box[16 * kk:16 * kk + 16]
            width = min(bn, n - c0)
            out[r0:r0 + BLOCK_ROWS, c0:c0 + width] = acc[:, :width]
    return out


@pytest.mark.parametrize("m,k,n", [(64, 96, 192), (64, 16, 64), (128, 64, 32), (128, 96, 160),
                                   (128, 128, 320), (256, 576, 192)])
def test_chunk_model_matches_mm_grid_plain(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy((rng.standard_normal((k, n)) * 0.05).astype(np.float32)).to(torch.bfloat16)
    model = chunk_model(a, b)
    assert torch.isfinite(model).all()  # every output element written once
    torch.testing.assert_close(model, a.float() @ b.float(), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(model.to(torch.bfloat16), mm_grid_plain(a, b), atol=2e-2, rtol=2e-2)
    assert torch.equal(mm_grid(a, b), mm_grid_plain(a, b))  # the CPU path is the plain version


# ---- mm_resident --------------------------------------------------------

# what the kernel must run: the experiment tool's shapes and the card
# tests' ragged ones
RESIDENT_SHAPES = list(conv_exp.MM_SHAPES) + [(64, 96, 192), (128, 64, 32), (128, 96, 160),
                                              (256, 96, 160), (128, 64, 64)]
# a thread of a 256-thread block may have 255 registers; its operands leave
# at least 48 of them to addresses, indices and the epilogue
OPERAND_REGISTER_BUDGET = 255 - 48
STEP_BYTES = 16 * 128  # one k step of a column box: 16 rows of 128 bytes


@pytest.mark.parametrize("m,k,n", RESIDENT_SHAPES)
def test_resident_plan_covers_the_output_and_fits_a_block(m, k, n):
    plan = mm_resident_plan(m, k, n)
    bn, k_boxes, k_steps = plan["bn"], plan["k_boxes"], plan["k_steps"]
    assert plan["bm"] == BLOCK_ROWS and bn in RESIDENT_WIDTHS
    assert (plan["grid_x"] - 1) * bn < n <= plan["grid_x"] * bn
    assert plan["grid_y"] * BLOCK_ROWS == m
    # k in whole boxes of 64, two warpgroups of k_steps k steps of 16 each
    assert (k_boxes - 1) * 64 < k <= k_boxes * 64
    assert plan["warpgroups"] == 2 and plan["threads"] == 256
    assert plan["warpgroups"] * k_steps * 16 == k_boxes * 64
    # no built width leaves fewer columns past n
    assert plan["grid_x"] * bn == min(-(-n // w) * w for w in RESIDENT_WIDTHS)
    tile = k_boxes * (bn // 64) * GRID_BOX_BYTES  # b's whole slice, resident
    assert plan["tx_bytes"] == tile
    # the epilogue's f32 partial sums and bf16 tile fit where b was
    assert plan["smem_bytes"] == GRID_ALIGN + max(tile, 256 * bn + 128 * bn) + MBARRIER_BYTES
    assert plan["smem_bytes"] <= SMEM_LIMIT == 232_448
    # A's fragments (4 registers a k step) and the accumulators (bn / 2)
    assert plan["operand_registers"] == 4 * k_steps + bn // 2 <= OPERAND_REGISTER_BUDGET


def test_resident_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        mm_resident_plan(64, 4096, 32)  # b's slice alone is 512 KB
    with pytest.raises(ValueError, match="registers"):
        mm_resident_plan(64, 640, 32)  # fits shared memory; a's 20 k steps a warpgroup do not fit
    assert mm_resident_plan(64, 576, 32)["k_steps"] == 18


@pytest.mark.parametrize("m,k,n", conv_exp.GATE_SHAPES)
def test_resident_gate_shapes_run_in_one_wave(m, k, n):
    plan = mm_resident_plan(m, k, n)
    assert plan["grid_x"] == 1 and plan["grid_x"] * plan["grid_y"] <= SMS
    assert plan["bn"] == n == 192 and plan["k_steps"] * 32 == k  # no padded k step


def a_fragment_loads(k, k_steps):
    """The kernel's loads of A, (warpgroup, thread, k step, register): the
    32-bit word (two bf16) of the block's rows it reads, as
    csrc/mm_probe.cu computes it (lo = row r's words + lane % 4, hi = lo +
    4 k, eight rows on; step s adds 8 s words, registers 2 and 3 four more),
    and whether the step is live (s < k / 16; else the register is zero)."""
    g, t, i, q = np.meshgrid(np.arange(2), np.arange(128), np.arange(k_steps), np.arange(4),
                             indexing="ij")
    warp, lane = t // 32, t % 32
    s = g * k_steps + i
    lo = (16 * warp + lane // 4) * (k // 2) + lane % 4
    word = lo + 4 * k * (q % 2) + 8 * s + 4 * (q // 2)
    return word, s < k // 16


def wgmma_a_layout(k_steps):
    """wgmma's A fragment in registers (m64 x k16, bf16): thread t of the
    warpgroup holds, in register q, row 16 (t // 32) + (t % 32) // 4 + 8
    (q % 2), k 2 (t % 4) + 8 (q // 2) and the next, of its k step."""
    g, t, i, q = np.meshgrid(np.arange(2), np.arange(128), np.arange(k_steps), np.arange(4),
                             indexing="ij")
    rows = 16 * (t // 32) + (t % 32) // 4 + 8 * (q % 2)
    cols = 16 * (g * k_steps + i) + 2 * (t % 4) + 8 * (q // 2)
    return rows, cols


@pytest.mark.parametrize("k", [16, 64, 96, 192, 512, 576])
def test_a_fragment_loads_hold_what_wgmma_expects(k):
    k_steps = mm_resident_plan(64, k, 64)["k_steps"]
    word, live = a_fragment_loads(k, k_steps)
    rows, cols = wgmma_a_layout(k_steps)
    np.testing.assert_array_equal(word[live] // (k // 2), rows[live])
    np.testing.assert_array_equal(2 * (word[live] % (k // 2)), cols[live])
    # every (row, k) of the block's 64 x k slice is loaded once
    assert np.array_equal(np.sort(word[live]), np.arange(64 * k // 2))
    assert live.all() == (2 * 16 * k_steps == k)  # only the steps past k are dead
    assert live.sum() == 64 * k // 2


def a_fragments(a_block, k_steps):
    """What each thread's registers hold, gathered at its loads (zero for a
    dead step): (warpgroup, k step, 64, 16), laid back out by wgmma's A
    layout, so each k step's tile reads as rows x 16 k."""
    k = a_block.shape[1]
    word, live = a_fragment_loads(k, k_steps)
    rows, cols = wgmma_a_layout(k_steps)
    flat = a_block.reshape(-1)
    tiles = np.zeros((2, k_steps, 64, 16), np.float32)
    g, _, i, _ = np.meshgrid(np.arange(2), np.arange(128), np.arange(k_steps), np.arange(4),
                             indexing="ij")
    for half in range(2):
        values = np.where(live, flat[np.minimum(2 * word + half, flat.size - 1)], 0.0)
        tiles[g, i, rows, cols % 16 + half] = values
    return tiles


def test_a_fragments_give_back_each_k_step_of_a():
    for k in (96, 576):
        a_block = coded(64, k, seed=k).astype(np.float32)
        k_steps = mm_resident_plan(64, k, 64)["k_steps"]
        tiles = a_fragments(a_block, k_steps)
        padded = np.zeros((64, 32 * 2 * k_steps), np.float32)
        padded[:, :k] = a_block
        for g in range(2):
            for i in range(k_steps):
                s = g * k_steps + i
                np.testing.assert_array_equal(tiles[g, i], padded[:, 16 * s:16 * s + 16])


def resident_b_smem(b_slice, k_boxes, bn):
    """b's slice as TMA lays it down: column box j's k box kb at (j k_boxes
    + kb) 8192 bytes, so a column box's k rows run on from one box to the
    next; zeros past k and n (TMA's fill)."""
    padded = np.zeros((64 * k_boxes, bn), np.float32)
    padded[:b_slice.shape[0], :b_slice.shape[1]] = b_slice
    smem = np.full(k_boxes * (bn // 64) * GRID_BOX_BYTES // 2, np.nan, np.float32)
    for j in range(bn // 64):
        for kb in range(k_boxes):
            tma_write(smem, (j * k_boxes + kb) * GRID_BOX_BYTES,
                      padded[64 * kb:64 * kb + 64, 64 * j:64 * j + 64])
    return smem, padded


def resident_desc(k_boxes, k_steps, g, i):
    """The kernel's descriptor of warpgroup g's k step i: its first step's
    (start 2048 k_steps g, LBO the distance between column boxes, SBO
    1024) plus 128 i, 2048 bytes in the 16-byte units of the start field."""
    base = smem_desc(STEP_BYTES * k_steps * g, k_boxes * GRID_BOX_BYTES, 1024)
    return base + (STEP_BYTES >> 4) * i


@pytest.mark.parametrize("bn", RESIDENT_WIDTHS)
@pytest.mark.parametrize("k", [64, 96, 192, 576])
def test_resident_descriptors_give_back_each_k_step_of_b(bn, k):
    k_boxes = -(-k // 64)
    k_steps = 2 * k_boxes
    smem, padded = resident_b_smem(coded(k, bn - 32, seed=k + bn).astype(np.float32), k_boxes, bn)
    for g in range(2):
        for i in range(k_steps):
            s = g * k_steps + i
            desc = resident_desc(k_boxes, k_steps, g, i)
            assert desc == smem_desc(STEP_BYTES * s, k_boxes * GRID_BOX_BYTES, 1024)  # no carry
            step = read_mn_major(smem, desc, bn)
            np.testing.assert_array_equal(step, padded[16 * s:16 * s + 16])
    assert not padded[k:].any() and not padded[:, bn - 32:].any()  # TMA's zeros


def test_resident_descriptor_with_mm_grid_lbo_is_a_permutation():
    """Read with mm_grid's LBO (adjacent column boxes), the resident layout
    gives the wrong columns."""
    k_boxes = 3
    smem, padded = resident_b_smem(coded(192, 192, seed=3).astype(np.float32), k_boxes, 192)
    wrong = read_mn_major(smem, smem_desc(0, GRID_BOX_BYTES, 1024), 192)
    assert not np.array_equal(wrong, padded[:16])


def partial_index(bn):
    """The float the kernel's second warpgroup writes accumulator register
    r of thread t to (and the first reads it from): float4 q = r // 4 of
    the 128 threads' pieces, at q 512 + 4 t + r % 4."""
    t, reg = np.meshgrid(np.arange(128), np.arange(bn // 2), indexing="ij")
    return (reg // 4) * 512 + 4 * t + reg % 4


@pytest.mark.parametrize("bn", RESIDENT_WIDTHS)
def test_k_split_sums_meet_in_place_and_the_epilogue_fits(bn):
    """Each of the second warpgroup's accumulators lands in its own float,
    read back by the thread of the first that holds the same (row, column);
    the partial sums take 256 bn bytes, and C's tile after them the boxes
    TMA stores, 128 bn more, all inside the plan's region."""
    index = partial_index(bn)
    assert np.array_equal(np.sort(index.reshape(-1)), np.arange(64 * bn))
    rows, cols = wgmma_fragment(bn)
    acc_first = coded(64, bn, seed=1).astype(np.float32)
    acc_second = coded(64, bn, seed=2).astype(np.float32)
    partial = np.full(64 * bn, np.nan, np.float32)
    partial[index] = acc_second[rows, cols]
    np.testing.assert_array_equal(acc_first[rows, cols] + partial[index],
                                  (acc_first + acc_second)[rows, cols])
    tile_c = 256 * bn  # bytes
    offset = (cols // 64) * GRID_BOX_BYTES + rows * 128 + (cols % 64) * 2
    address = tile_c + (offset ^ ((rows % 8) << 4))
    assert address.min() >= 4 * partial.size and tile_c % GRID_ALIGN == 0
    assert address.max() < 384 * bn
    smem = np.full(384 * bn // 2, np.nan, np.float32)
    smem[address // 2] = (acc_first + acc_second)[rows, cols]
    r, c = np.meshgrid(np.arange(64), np.arange(bn), indexing="ij")
    stored = smem[swizzle(tile_c + (c // 64) * GRID_BOX_BYTES + r * 128 + (c % 64) * 2) // 2]
    np.testing.assert_array_equal(stored, acc_first + acc_second)


def resident_model(a, b, reps):
    """mm_resident as the kernel computes it, block by block, in f32: b's
    slice laid down by TMA, each warpgroup's A fragments gathered at its
    lanes' loads, its k steps issued rep by rep through their descriptors
    into its accumulator, the second's partial sums added once to the
    first's; columns past n not stored."""
    a, b = a.float().numpy(), b.float().numpy()
    (m, k), n = a.shape, b.shape[1]
    plan = mm_resident_plan(m, k, n)
    bn, k_boxes, k_steps = plan["bn"], plan["k_boxes"], plan["k_steps"]
    out = np.full((m, n), np.nan, np.float32)
    rows, cols = wgmma_fragment(bn)
    index = partial_index(bn)
    for bx in range(plan["grid_x"]):
        smem, _ = resident_b_smem(b[:, bx * bn:(bx + 1) * bn], k_boxes, bn)
        steps = [[read_mn_major(smem, resident_desc(k_boxes, k_steps, g, i), bn)
                  for i in range(k_steps)] for g in range(2)]
        for by in range(plan["grid_y"]):
            frags = a_fragments(a[by * 64:(by + 1) * 64], k_steps)
            acc = np.zeros((2, 64, bn), np.float32)
            for _ in range(reps):
                for g in range(2):
                    for i in range(k_steps):
                        acc[g] += frags[g, i] @ steps[g][i]
            partial = np.zeros(64 * bn, np.float32)
            partial[index] = acc[1][rows, cols]
            total = np.zeros((64, bn), np.float32)
            total[rows, cols] = acc[0][rows, cols] + partial[index]
            width = min(bn, n - bx * bn)
            out[by * 64:(by + 1) * 64, bx * bn:bx * bn + width] = total[:, :width]
    return torch.from_numpy(out)


@pytest.mark.parametrize("reps", [1, 3])
@pytest.mark.parametrize("m,k,n", [(64, 96, 192), (128, 64, 32), (128, 96, 160), (64, 576, 192),
                                   (64, 16, 64), (64, 512, 320)])
def test_resident_model_matches_mm_resident_plain(m, k, n, reps):
    rng = np.random.default_rng(m + k + n + reps)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy((rng.standard_normal((k, n)) * 0.05).astype(np.float32)).to(torch.bfloat16)
    model = resident_model(a, b, reps)
    assert torch.isfinite(model).all()  # every output element written once
    torch.testing.assert_close(model, reps * (a.float() @ b.float()), atol=1e-4 * reps, rtol=1e-5)
    torch.testing.assert_close(model.to(torch.bfloat16).float(),
                               mm_resident_plain(a, b, reps).float(), atol=2e-2, rtol=2e-2)
    assert torch.equal(mm_resident(a, b, reps), mm_resident_plain(a, b, reps))  # the CPU route
