"""One 'same' 3x3 convolution, NHWC bfloat16: the port of
tools/pallas_conv_exp.py::pallas_conv.

``conv3x3`` launches the hand-written CUDA kernel ``csrc/conv3x3.cu``, an
implicit GEMM on Hopper's tensor cores: TMA loads of the weights (once a
block) and of haloed input windows (into a ring of shared-memory stages, on
mbarriers), ``wgmma`` with A from registers, f32 accumulation, one rounding
to bfloat16 and a TMA store.  ``conv3x3_plan`` states each launch's
geometry; the kernel refuses any other.  It is the subject of the
experiment tool ``tools/conv_exp.py``.

``conv3x3_plain`` is the same function in plain PyTorch.  ``conv3x3`` takes
it only for a tensor on the CPU; on a CUDA tensor it launches the kernel or
raises.

Modes split the kernel's time between its steps:

* ``full``: the convolution.
* ``dots``: the weights are loaded and the products and the store run, but
  no input window is loaded.  The values are undefined (as they are in the
  TPU kernel, which multiplies an unwritten scratch buffer); the plain
  version returns zeros, and only the shape is comparable.
* ``patch``: only the input windows.  Returns the first ``Cout`` columns of
  the dy = 0 patch row ``[x(y-1, x-1), x(y-1, x), x(y-1, x+1)]`` (zero
  outside the image), which needs ``Cout <= 3 Cin``.  The CUDA kernel
  builds no patch matrix, so this times what it has in its place: loading
  the windows and copying out of them.
* ``dma``: all loads (weights and input windows) and a store of zeros.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from real_esrgan_tpu_torch.ops import _build
from real_esrgan_tpu_torch.ops.resize import true_f32

MODES = ("full", "dots", "patch", "dma")
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on sm_90
ENCODE_ERROR_BASE = 10000  # hopper::kEncodeErrorBase: + a CUresult of the tensor-map encoder
H100_SMS = 132        # streaming multiprocessors of an H100 SXM

# the geometry of csrc/conv3x3.cu
KERNEL_ROWS = 8       # output rows of one sub-tile
KERNEL_COLS = 16      # output pixels of one row: a sub-tile is 128 pixels
WINDOW_ROWS, WINDOW_COLS = KERNEL_ROWS + 2, KERNEL_COLS + 2  # with the 1-pixel halo
CHANNEL_BOX = 64      # channels of one window box: 128 bytes a pixel
WINDOW_BOX_BYTES = WINDOW_ROWS * WINDOW_COLS * CHANNEL_BOX * 2   # 23040
ALIGN = 1024          # the 128-byte swizzle repeats every 1024 bytes
WINDOW_STRIDE = -(-WINDOW_BOX_BYTES // ALIGN) * ALIGN           # 23552
K_BOX = 64            # k of one weight box: 128 bytes
OUT_BOX_CHANNELS = 32  # one output box: a warpgroup's 64 pixels x 64 bytes, 64-byte swizzled
OUT_BOX_BYTES = KERNEL_ROWS // 2 * KERNEL_COLS * OUT_BOX_CHANNELS * 2  # 4096
MAX_STAGES = 4
MAX_CHANNEL_BOXES = 2   # Cin up to 128: the kernels built
THREADS = 2 * 128 + 32  # two consumer warpgroups and the producer warp
WIDTHS = (96, 64, 32)   # the output-channel slices (wgmma N) built, widest first
MBARRIER_BYTES = 8
PLAN_KEYS = ("bn", "stages", "grid", "threads", "smem_bytes", "window_tx_bytes",
             "weight_tx_bytes", "k_boxes", "channel_boxes", "pixel_tiles", "slices", "groups",
             "items")
# shapes at which the built library's plan is held to conv3x3_plan when it
# loads: (B, H, W, Cin, Cout, tile), the tool's default and the card tests'
PLAN_CHECK_SHAPES = ((8, 256, 256, 64, 192, 32), (2, 16, 32, 32, 96, 8),
                     (1, 64, 48, 64, 64, 16), (2, 64, 48, 32, 96, 16))


def conv3x3_plan(B: int, H: int, W: int, Cin: int, Cout: int, tile: int,
                 sms: int = H100_SMS) -> dict:
    """The geometry of one conv3x3 launch on a card of ``sms`` SMs.

    * ``bn``: the output channels a block computes, the widest of ``WIDTHS``
      that divides Cout and leaves room for two windows beside the weights;
    * ``k_boxes``: the weight slice, ceil(9 Cin / 64) TMA boxes of bn rows x
      64 k (``weight_tx_bytes`` in all), resident for the whole launch;
    * ``channel_boxes``: the 64-channel boxes of one 10 x 18 input window
      (``window_tx_bytes``: whole boxes, TMA's zeros past Cin included);
    * ``stages``: the windows in the ring, up to four, as many as fit
      beside the weights, the staging tile (two warpgroups' bn / 32 boxes
      of 4096 bytes) and the mbarriers (two a stage, one for the weights);
    * ``smem_bytes``: 1024 bytes of alignment slack and all of the above;
    * ``pixel_tiles``: B (H / tile) (W / 16) tiles of ``tile`` rows x 16
      pixels; ``items`` = pixel_tiles x ``slices`` (Cout / bn);
    * ``grid``: ``groups`` x ``slices`` persistent blocks, groups as many
      as the SMs hold and no more than the pixel tiles; block i computes
      slice i % slices of pixel tiles i // slices, + groups, ...

    Raises ``ValueError`` for Cin above 128 or where no width fits a
    block's shared memory.
    """
    channel_boxes = -(-Cin // CHANNEL_BOX)
    if channel_boxes > MAX_CHANNEL_BOXES:
        raise ValueError(f"conv3x3 takes Cin up to {MAX_CHANNEL_BOXES * CHANNEL_BOX}, got {Cin}")
    k_boxes = -(-9 * Cin // K_BOX)
    window = channel_boxes * WINDOW_STRIDE
    for bn in WIDTHS:
        if Cout % bn:
            continue
        staging = 2 * bn // OUT_BOX_CHANNELS * OUT_BOX_BYTES
        fixed = ALIGN + k_boxes * bn * 128 + staging + MBARRIER_BYTES
        stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // (window + 2 * MBARRIER_BYTES))
        if stages >= 2:
            break
    else:
        raise ValueError(f"conv3x3: no weight slice of Cin={Cin}, Cout={Cout} fits a block's "
                         f"{SMEM_LIMIT} bytes of shared memory beside two input windows")
    slices = Cout // bn
    pixel_tiles = B * (H // tile) * (W // KERNEL_COLS)
    groups = min(pixel_tiles, max(1, sms // slices))
    return {"bn": bn, "stages": stages, "grid": groups * slices, "threads": THREADS,
            "smem_bytes": fixed + stages * (window + 2 * MBARRIER_BYTES),
            "window_tx_bytes": channel_boxes * WINDOW_BOX_BYTES,
            "weight_tx_bytes": k_boxes * bn * 128, "k_boxes": k_boxes,
            "channel_boxes": channel_boxes, "pixel_tiles": pixel_tiles, "slices": slices,
            "groups": groups, "items": pixel_tiles * slices}


def _check(x: torch.Tensor, w: torch.Tensor, tile: int, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"conv3x3 mode must be one of {MODES}, not {mode!r}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"conv3x3 takes a bfloat16 input, not {x.dtype}")
    if w.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv3x3 takes bfloat16 or float32 weights, not {w.dtype}")
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[-1]):
        raise ValueError(f"conv3x3 takes x (B, H, W, Cin) and w (3, 3, Cin, Cout), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError(f"conv3x3: x on {x.device}, w on {w.device}")
    b, h, width, cin = x.shape
    cout = w.shape[-1]
    if tile <= 0 or tile % KERNEL_ROWS or h % tile:
        raise ValueError(f"conv3x3 needs tile % {KERNEL_ROWS} == 0 and H % tile == 0, "
                         f"got H={h}, tile={tile}")
    if width % KERNEL_COLS:
        raise ValueError(f"conv3x3 needs W % {KERNEL_COLS} == 0, got W={width}")
    if cin % 16 or cout % 32:
        raise ValueError(f"conv3x3 needs Cin % 16 == 0 and Cout % 32 == 0, got {cin} -> {cout}")
    if mode == "patch" and cout > 3 * cin:
        raise ValueError(f"conv3x3 mode 'patch' needs Cout <= 3 Cin, got {cin} -> {cout}")
    if not x.is_contiguous() or not w.is_contiguous():
        raise ValueError("conv3x3 needs contiguous NHWC x and HWIO w")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("conv3x3 needs x and w on a 16-byte boundary")
    conv3x3_plan(b, h, width, cin, cout, tile)


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, mode: str = "full") -> torch.Tensor:
    """Plain PyTorch version of ``conv3x3``: bfloat16-rounded operands, a
    true-float32 convolution, one rounding to bfloat16."""
    b, h, width, cin = x.shape
    cout = w.shape[-1]
    if mode in ("dots", "dma"):
        return torch.zeros(b, h, width, cout, dtype=torch.bfloat16, device=x.device)
    if mode == "patch":
        xp = F.pad(x, (0, 0, 1, 1, 1, 1))  # one zero pixel around H and W
        bands = [xp[:, 0:h, dx:dx + width, :] for dx in range(3)]
        return torch.cat(bands, dim=-1)[..., :cout].contiguous()
    weight = w.to(torch.bfloat16).float().permute(3, 2, 0, 1)  # HWIO -> OIHW
    with true_f32():
        out = F.conv2d(x.float().permute(0, 3, 1, 2), weight, padding=1)
    return out.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()


def k_major_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO ``w`` (3, 3, Cin, Cout) as the kernel's K-major B: bfloat16
    (Cout, 9 Cin), row o holding k = (3 dy + dx) Cin + c."""
    cout = w.shape[-1]
    return w.to(torch.bfloat16).permute(3, 0, 1, 2).reshape(cout, -1).contiguous()


def _library() -> ctypes.CDLL:
    lib = _build.load("conv3x3")
    if lib.conv3x3_forward.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.conv3x3_forward.argtypes = [vp, vp, vp] + [i] * 10 + [vp]
        lib.conv3x3_forward.restype = i
        lib.conv3x3_built_plan.argtypes = [i] * 7 + [ctypes.POINTER(i)]
        lib.conv3x3_built_plan.restype = i
        for shape in PLAN_CHECK_SHAPES:
            plan, built = conv3x3_plan(*shape), _built_plan(lib, *shape, H100_SMS)
            if built != plan:
                raise RuntimeError(f"csrc/conv3x3.cu plans {built} at {shape}, "
                                   f"conv3x3_plan says {plan}")
    return lib


def _built_plan(lib: ctypes.CDLL, B: int, H: int, W: int, Cin: int, Cout: int, tile: int,
                sms: int) -> dict:
    out = (ctypes.c_int * len(PLAN_KEYS))()
    err = lib.conv3x3_built_plan(B, H, W, Cin, Cout, tile, sms, out)
    if err != 0:
        raise ValueError(f"conv3x3 takes no ({B}, {H}, {W}, {Cin}) -> {Cout} at tile {tile}: "
                         f"CUDA error {err}")
    return dict(zip(PLAN_KEYS, out))


def built_conv3x3_plan(B: int, H: int, W: int, Cin: int, Cout: int, tile: int,
                       sms: int = H100_SMS) -> dict:
    """The geometry csrc/conv3x3.cu launches at this shape on ``sms`` SMs,
    as its ``conv3x3_built_plan`` reports it (building the library first if
    needed); ``conv3x3`` refuses to launch unless it is ``conv3x3_plan``'s."""
    return _built_plan(_library(), B, H, W, Cin, Cout, tile, sms)


def conv3x3(x: torch.Tensor, w: torch.Tensor, tile: int = 32, mode: str = "full") -> torch.Tensor:
    """'same' 3x3 convolution of NHWC bfloat16 ``x`` (B, H, W, Cin) with
    ``w`` (3, 3, Cin, Cout) -> (B, H, W, Cout) bfloat16.

    ``tile`` is the number of image rows one block walks down, 8 rows at a
    time, before it takes its next pixel tile.  It must divide H and be a
    multiple of 8; W must be a multiple of 16, Cin of 16, Cout of 32.  A
    CPU tensor goes through ``conv3x3_plain``; a CUDA tensor through the
    kernel, at ``conv3x3_plan`` for the card's SM count, which adds one to
    ``conv3x3.launches``.
    """
    _check(x, w, tile, mode)
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, mode)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3 runs on cpu or cuda, not {x.device}")
    b, h, width, cin = x.shape
    cout = w.shape[-1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = conv3x3_plan(b, h, width, cin, cout, tile, sms)
    lib = _library()
    weight = k_major_weights(w)
    out = torch.empty(b, h, width, cout, dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv3x3_forward(x.data_ptr(), weight.data_ptr(), out.data_ptr(), b, h, width,
                                  cin, cout, tile, MODES.index(mode), plan["bn"], plan["stages"],
                                  sms, stream)
    if err >= ENCODE_ERROR_BASE:
        raise RuntimeError(f"conv3x3: cuTensorMapEncodeTiled failed with CUresult "
                           f"{err - ENCODE_ERROR_BASE}")
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed with CUDA error {err}")
    conv3x3.launches += 1
    return out


conv3x3.launches = 0
