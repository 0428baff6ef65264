"""Two bfloat16 matrix-product probes on the tensor cores: the ports of
tools/pallas_conv_exp.py::bench_mosaic_mm and ::bench_mosaic_mm_vmem.

* ``mm_grid(a, b)``: ``a @ b`` tiled over a grid of blocks, f32 accumulate,
  bfloat16 out.  The TPU kernel's ``grid_m`` (rows a sequential grid step)
  has no counterpart: the kernel tiles M and N over parallel blocks itself,
  with TMA loads into a ring of shared-memory stages, mbarriers and
  ``wgmma`` (``mm_grid_plan`` states each launch's geometry).
* ``mm_resident(a, b, reps)``: each block holds its slice of ``a`` in
  registers and its slice of ``b`` in shared memory, loaded once, and issues
  the product ``reps`` times from there with ``wgmma``, summed in f32: the
  tensor cores' rate with no device-memory read in the loop
  (``mm_resident_plan`` states each launch's geometry).

Both launch hand-written CUDA kernels (``csrc/mm_probe.cu``).  The plain
versions are taken only for tensors on the CPU; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from real_esrgan_tpu_torch.ops import _build
from real_esrgan_tpu_torch.ops.conv3x3 import ENCODE_ERROR_BASE, SMEM_LIMIT
from real_esrgan_tpu_torch.ops.resize import true_f32

BLOCK_ROWS = 64  # rows of the output one block computes, as kBM in csrc/mm_probe.cu

# mm_grid, as csrc/mm_probe.cu builds it
GRID_BK = 64            # k chunk: one 128-byte swizzle row of bfloat16
GRID_ATOM = 64          # columns of b in one TMA box
GRID_WIDTHS = (64, 128, 192, 256)  # the wgmma widths built
GRID_BOX_BYTES = 64 * 128          # one TMA box: 64 rows of 128 bytes
GRID_MAX_STAGES = 6
GRID_ALIGN = 1024       # the 128-byte swizzle pattern repeats every 1024 bytes
GRID_THREADS = 128 + 32  # one consumer warpgroup and one producer warp
MBARRIER_BYTES = 8
_PLAN_KEYS = ("bn", "bk", "stages", "grid_x", "grid_y", "threads", "smem_bytes", "cluster",
              "tx_bytes")


def mm_grid_plan(m: int, k: int, n: int) -> dict:
    """The geometry of one mm_grid launch at (m, k) @ (k, n): the block's
    width ``bn`` (all of n up to 256, a multiple of 64), the k chunk ``bk``,
    the ring's ``stages`` (every chunk up to six, as many as fit), the grid
    (column blocks, row blocks), threads, dynamic shared memory (1024 bytes
    of alignment, then each stage's A box and bn / 64 B boxes and its two
    mbarriers), the cluster size and ``tx_bytes``, the bytes a stage's full
    mbarrier expects: every box whole, the zeros TMA fills past k or n
    included."""
    bn = min(GRID_WIDTHS[-1], -(-n // GRID_ATOM) * GRID_ATOM)
    tx_bytes = GRID_BOX_BYTES * (1 + bn // GRID_ATOM)
    chunks = -(-k // GRID_BK)
    fit = (SMEM_LIMIT - GRID_ALIGN) // (tx_bytes + 2 * MBARRIER_BYTES)
    stages = min(chunks, GRID_MAX_STAGES, fit)
    return {"bn": bn, "bk": GRID_BK, "stages": stages, "grid_x": -(-n // bn),
            "grid_y": m // BLOCK_ROWS, "threads": GRID_THREADS,
            "smem_bytes": GRID_ALIGN + stages * (tx_bytes + 2 * MBARRIER_BYTES), "cluster": 1,
            "tx_bytes": tx_bytes}


# mm_resident, as csrc/mm_probe.cu builds it
RESIDENT_WIDTHS = (192, 128, 64)  # the wgmma widths built, widest first
RESIDENT_MAX_K_BOXES = 9  # k up to 576: a warpgroup's 18 k steps of a in registers
RESIDENT_WARPGROUPS = 2   # each holds one half of k
RESIDENT_THREADS = 128 * RESIDENT_WARPGROUPS
RESIDENT_PLAN_KEYS = ("bm", "bn", "k_boxes", "k_steps", "warpgroups", "threads",
                      "operand_registers", "smem_bytes", "grid_x", "grid_y", "tx_bytes")


def _resident_smem_bytes(k_boxes: int, bn: int) -> int:
    """1024 bytes of alignment, then b's slice (k boxes of 64 k x bn / 64
    column boxes) or the epilogue's f32 partial sums (256 bn bytes) and
    bfloat16 tile (128 bn), whichever is larger, then one mbarrier."""
    tile = k_boxes * bn // GRID_ATOM * GRID_BOX_BYTES
    return GRID_ALIGN + max(tile, 384 * bn) + MBARRIER_BYTES


def mm_resident_plan(m: int, k: int, n: int) -> dict:
    """The geometry of one mm_resident launch at (m, k) @ (k, n): a block of
    ``bm`` = 64 rows and ``bn`` columns, of the built widths whose slice of
    b fits shared memory the one that leaves the fewest columns past n (the
    widest on a tie); k padded to ``k_boxes`` boxes of 64, split over two
    ``warpgroups`` of ``k_steps`` k steps of 16 each; ``threads``; the
    registers a thread holds its operands in (4 a k step of a's fragments,
    bn / 2 accumulators); dynamic shared memory; the grid (column blocks,
    row blocks); and ``tx_bytes``, the bytes of b's slice the mbarrier
    expects, TMA's zeros past k and n included.  The kernel instance
    launched is (bn, k_boxes).  Raises ValueError where no slice of b fits
    shared memory or k is past what the registers hold."""
    k_boxes = -(-k // GRID_BK)
    fits = [bn for bn in RESIDENT_WIDTHS if _resident_smem_bytes(k_boxes, bn) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"mm_resident: no slice of a ({k}, {n}) matrix fits a block's "
                         f"{SMEM_LIMIT} bytes of shared memory")
    if k_boxes > RESIDENT_MAX_K_BOXES:
        raise ValueError(f"mm_resident holds a's slice in registers, k up to "
                         f"{RESIDENT_MAX_K_BOXES * GRID_BK}; got k = {k}")
    bn = min(fits, key=lambda width: -(-n // width) * width)
    k_steps = 2 * k_boxes
    return {"bm": BLOCK_ROWS, "bn": bn, "k_boxes": k_boxes, "k_steps": k_steps,
            "warpgroups": RESIDENT_WARPGROUPS, "threads": RESIDENT_THREADS,
            "operand_registers": 4 * k_steps + bn // 2,
            "smem_bytes": _resident_smem_bytes(k_boxes, bn), "grid_x": -(-n // bn),
            "grid_y": m // BLOCK_ROWS, "tx_bytes": k_boxes * bn // GRID_ATOM * GRID_BOX_BYTES}


def _check(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"{name} takes bfloat16 matrices, not {a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{name} takes (m, k) and (k, n), got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"{name}: a on {a.device}, b on {b.device}")
    m, k = a.shape
    n = b.shape[1]
    if m == 0 or m % BLOCK_ROWS or k == 0 or k % 16 or n == 0 or n % 32:
        raise ValueError(f"{name} needs m % {BLOCK_ROWS} == 0, k % 16 == 0 and n % 32 == 0, "
                         f"got ({m}, {k}) @ ({k}, {n})")
    if not a.is_contiguous() or not b.is_contiguous():
        raise ValueError(f"{name} needs contiguous row-major matrices")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"{name} needs a and b on a 16-byte boundary")


def mm_grid_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``mm_grid``: a true-float32 product of the
    bfloat16 operands, rounded once."""
    with true_f32():
        return (a.float() @ b.float()).to(torch.bfloat16)


def mm_resident_plain(a: torch.Tensor, b: torch.Tensor, reps: int = 32) -> torch.Tensor:
    """Plain PyTorch version of ``mm_resident``: ``reps`` times the product,
    which equals the f32 sum of ``reps`` equal products up to summation
    order."""
    with true_f32():
        return (reps * (a.float() @ b.float())).to(torch.bfloat16)


def _library() -> ctypes.CDLL:
    lib = _build.load("mm_probe")
    if lib.mm_grid_forward.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.mm_grid_forward.argtypes = [vp, vp, vp, i, i, i, i, i, vp]
        lib.mm_grid_forward.restype = i
        lib.mm_grid_built_plan.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.mm_grid_built_plan.restype = i
        lib.mm_resident_forward.argtypes = [vp, vp, vp, i, i, i, i, i, i, vp]
        lib.mm_resident_forward.restype = i
        lib.mm_resident_built_plan.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.mm_resident_built_plan.restype = i
    return lib


def _launch(wrapper, a: torch.Tensor, b: torch.Tensor, call) -> torch.Tensor:
    if a.device.type != "cuda":
        raise ValueError(f"{wrapper.__name__} runs on cpu or cuda, not {a.device}")
    out = torch.empty(a.shape[0], b.shape[1], dtype=torch.bfloat16, device=a.device)
    with torch.cuda.device(a.device):
        err = call(_library(), out, torch.cuda.current_stream(a.device).cuda_stream)
    if err >= ENCODE_ERROR_BASE:
        raise RuntimeError(f"{wrapper.__name__}: cuTensorMapEncodeTiled failed with CUresult "
                           f"{err - ENCODE_ERROR_BASE}")
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed with CUDA error {err}")
    wrapper.launches += 1
    return out


def _built_plan(name: str, keys, m: int, k: int, n: int) -> dict:
    out = (ctypes.c_int * len(keys))()
    err = getattr(_library(), f"{name}_built_plan")(m, k, n, out)
    if err != 0:
        raise ValueError(f"{name} takes no ({m}, {k}) @ ({k}, {n}): CUDA error {err}")
    return dict(zip(keys, out))


def built_mm_grid_plan(m: int, k: int, n: int) -> dict:
    """The geometry csrc/mm_probe.cu launches at (m, k) @ (k, n), as its
    ``mm_grid_built_plan`` reports it (building the library first if
    needed); ``mm_grid`` refuses to launch unless it is ``mm_grid_plan``'s."""
    return _built_plan("mm_grid", _PLAN_KEYS, m, k, n)


def built_mm_resident_plan(m: int, k: int, n: int) -> dict:
    """The geometry csrc/mm_probe.cu launches mm_resident at, as its
    ``mm_resident_built_plan`` reports it; the launch refuses any width or
    k boxes but ``mm_resident_plan``'s."""
    return _built_plan("mm_resident", RESIDENT_PLAN_KEYS, m, k, n)


def mm_grid(a: torch.Tensor, b: torch.Tensor, acc32: bool = True) -> torch.Tensor:
    """``a @ b`` for bfloat16 (m, k) and (k, n), f32 accumulate, bfloat16
    out; m a multiple of 64, k of 16, n of 32, each launch at
    ``mm_grid_plan(m, k, n)``.

    ``acc32=False`` asks for a bfloat16 accumulator, as the TPU probe can;
    Hopper's bfloat16 tensor-core instructions accumulate in f32 only, so it
    raises.  A CPU tensor goes through ``mm_grid_plain``; a CUDA tensor
    through the kernel, which adds one to ``mm_grid.launches``.
    """
    if not acc32:
        raise ValueError("mm_grid: acc32=False (a bfloat16 accumulator) does not exist on "
                         "Hopper's bfloat16 tensor cores; they accumulate in float32")
    _check("mm_grid", a, b)
    if a.device.type == "cpu":
        return mm_grid_plain(a, b)
    (m, k), n = a.shape, b.shape[1]
    plan = mm_grid_plan(m, k, n)  # the C side refuses any other bn or stages
    return _launch(mm_grid, a, b, lambda lib, out, stream: lib.mm_grid_forward(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, plan["bn"], plan["stages"], stream))


def mm_resident(a: torch.Tensor, b: torch.Tensor, reps: int = 32) -> torch.Tensor:
    """The f32 sum of ``reps`` products ``a @ b``, rounded to bfloat16, each
    product issued in full from registers and shared memory; shapes as for
    ``mm_grid``, k up to 576, each launch at ``mm_resident_plan(m, k, n)``.

    A CPU tensor goes through ``mm_resident_plain``; a CUDA tensor through
    the kernel, which adds one to ``mm_resident.launches``.
    """
    if reps < 1:
        raise ValueError(f"mm_resident needs reps >= 1, got {reps}")
    _check("mm_resident", a, b)
    (m, k), n = a.shape, b.shape[1]
    plan = mm_resident_plan(m, k, n)  # the C side refuses any other bn or k boxes
    if a.device.type == "cpu":
        return mm_resident_plain(a, b, reps)
    return _launch(mm_resident, a, b, lambda lib, out, stream: lib.mm_resident_forward(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, reps, plan["bn"], plan["k_boxes"],
        stream))


mm_grid.launches = 0
mm_resident.launches = 0
