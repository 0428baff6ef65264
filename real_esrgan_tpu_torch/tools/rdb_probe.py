"""Variants of the RDB kernels (``csrc/fused_rdb.cu``) side by side on the card.

    python -m real_esrgan_tpu_torch.tools.rdb_probe [--variants shipped,no_products] [--rounds 2]
    python -m real_esrgan_tpu_torch.tools.rdb_probe --dtype bf16

Each variant is the kernel's source with a few lines replaced (``VARIANTS``;
the names of the bfloat16 kernel's variants start with ``bf16_``).  float32
(``rdb_f32_split_kernel``):

* ``shipped``: the source as it is;
* ``one_accumulator``: the three products of a source in one accumulator,
  added to the running sum once a source;
* ``slice_partials``: one accumulator for the three products, restarted
  every weight slice;
* ``kstep_partials``: the shipped two accumulators, restarted every k-step;
* ``no_lo_loads``: the lo planes not loaded, the hi fragments used in their
  place (wrong values): half the ``ldmatrix`` of the shipped kernel;
* ``one_product``: hi*hi alone (wrong values): a third of the products;
* ``no_products``: no products at all (wrong values): what is left is the
  loads, the weight ring, the barriers and the epilogues.

bfloat16 (``rdb_bf16_wgmma_kernel``, TMA, mbarriers and wgmma):

* ``bf16_shipped``: the source as it is;
* ``bf16_no_products``: no wgmma (wrong values): what is left is the x
  load, the weight stream, the ldmatrix of A, the drains and the epilogues;
* ``bf16_no_setmaxnreg``: the producer warpgroup keeps its registers;
* ``bf16_producer_warp``: one producer warp, not a warpgroup (and no
  setmaxnreg);
* ``bf16_no_loads``: no ldmatrix of A (wrong values);
* ``bf16_no_loads_no_ring``: nor any wait on the ring or refill of it
  (wrong values): the wgmma, the drains and the epilogues;
* ``bf16_no_stream``: the ring's slots marked full without a copy (wrong
  values): what the weight stream costs;

and the earlier ``mma.sync`` schedule (``rdb_body<1>``, which no shipped
kernel instantiates), built back as dtype 1's kernel:

* ``bf16_mma_sync``: as it was shipped;
* ``bf16_mma_sync_no_products``: no products (wrong values);
* ``bf16_mma_sync_no_slice_barrier``: the weight ring's block-wide barrier
  left out (wrong values): what the 60 barriers of a tile cost.

The tool builds every variant at once with nvcc into ``_build/probe/``, keeps
the input of each of the 69 RDBs in one forward of
``tests/data/tree_lr.png`` in the variants' dtype through ``SRPipeline``
with the committed weights, and prints one JSON line a variant: its worst
max-abs difference from ``rdb_plain`` over those 69 inputs, and its time at (1, 256, 512, 64)
(the input of ``trunk.11.rdb2``) inside a CUDA graph of 10 launches, taken
in turns (every variant in order, then in reverse, ``--rounds`` times).
Then the card's name and power limit.  The variants that compute wrong
values are there to tell which work sets the pace, not to be used.  Runs on
CUDA only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

import numpy as np
import torch

from real_esrgan_tpu_torch import resolve_device
from real_esrgan_tpu_torch.models.rrdbnet import ResidualDenseBlock
from real_esrgan_tpu_torch.ops import _build
from real_esrgan_tpu_torch.ops.fused_rdb import rdb_plain
from real_esrgan_tpu_torch.serve import SRPipeline
from real_esrgan_tpu_torch.tools.conv_exp import time_in_graph
from real_esrgan_tpu_torch.utils.imgio import read_png

ROOT = Path(__file__).resolve().parents[2]
WEIGHTS = ROOT / "assets" / "inenv10_esrnet_ema.npz"
IMAGE = ROOT / "tests" / "data" / "tree_lr.png"
TIMED_RDB = "trunk.11.rdb2"

_MMA = "tile::mma(t == 0 ? st.acc[u][q] : cross[u][q], "
_ADD = "st.sum[u][q][e] += st.acc[u][q].r[e] + cross[u][q].r[e];"
_RESTART = "    if constexpr (P == 3) {\n      zero(st.acc);\n      zero(cross);\n    }\n"
_ADD_OPEN = "    if constexpr (P == 3) {\n      // the slice's partial sums"
_PRODUCTS = "      for (int t = 0; t < P; ++t)\n"
_WGMMA = ("        hopper::WgmmaRS<kG>::mma(*reinterpret_cast<float(*)[16]>(&st.acc[u][16 * h]), "
          "f[u], desc,\n                                 t > 0);\n")
_LDSM = "      hopper::ldmatrix_x4(f[u], in + q * kRow + ((chunk ^ swz) << 4));\n"
# the ring's slots marked full without a copy
_NO_STREAM = [("""        hopper::mbar_arrive_expect_tx(&full[s], kBoxBytes);
        hopper::bulk_load(smem + s * kBoxBytes, w + (size_t)i * kBoxBytes, kBoxBytes, &full[s]);
""", "        hopper::mbar_arrive(&full[s]);\n")]
# no waits on the ring's slots and no releases; the producer loads the
# first boxes only
_NO_RING = [
    ("      hopper::mbar_wait_at(full_at(base, box % kRingSlots), (box / kRingSlots) & 1);\n",
     "      (void)box;\n"),
    ("        hopper::mbar_wait(&empty[s], ((i / kRingSlots) & 1) ^ 1);"
     "  // round 0 passes at once\n", ""),
    ("      for (int i = 0; i < kStreamBoxes; ++i) {",
     "      for (int i = 0; i < kRingSlots; ++i) {"),
    ("      hopper::mbar_arrive_at(empty_at(base, (kFirst + b * kH + h) % kRingSlots));\n",
     "      (void)b;\n"),
]
_NO_LOADS = [(_LDSM, "      f[u][0] ^= q ^ swz ^ chunk;\n")]
_NO_SETMAXNREG = [("    hopper::setmaxnreg_dec<kProducerRegisters>();\n", ""),
                  ("  hopper::setmaxnreg_inc<kConsumerRegisters>();\n", "")]
_F32_KERNEL = "__global__ void __launch_bounds__(kThreads, 1) rdb_f32_split_kernel(Params p) {"
# the earlier bf16 schedule, mma.sync on rdb_body<1>, as dtype 1's kernel: it
# reads the packed weights, not the boxes
_MMA_SYNC = [
    (_F32_KERNEL, "__global__ void __launch_bounds__(kThreads, 1) rdb_bf16_kernel(Params p) {\n"
                  "  extern __shared__ __align__(128) unsigned char smem_raw[];\n"
                  "  rdb_body<1>(p, reinterpret_cast<bf16*>(smem_raw));\n}\n\n" + _F32_KERNEL),
    ("  if (dtype == 1) return wg::launch_bf16(p, B, s);",
     "  if (dtype == 1) return launch<1>(rdb_bf16_kernel, p, B, s);"),
]
# (old, new) replacements, applied in order; each old text must occur once
VARIANTS = {
    "shipped": [],
    "one_accumulator": [
        (_MMA, "tile::mma(st.acc[u][q], "),
        (_RESTART, "    if constexpr (P == 3) if (part == 0) zero(st.acc);\n"),
        (_ADD_OPEN, "    if constexpr (P == 3) if (part == 3 * kCin / kGroup - 1) {\n"
                    "      // the slice's partial sums"),
        (_ADD, "st.sum[u][q][e] += st.acc[u][q].r[e];"),
    ],
    "slice_partials": [
        (_MMA, "tile::mma(st.acc[u][q], "),
        (_ADD, "st.sum[u][q][e] += st.acc[u][q].r[e];"),
    ],
    "kstep_partials": [
        (_RESTART, ""),
        ("      // products t = 0, 1, 2: hi*hi, hi*lo, lo*hi, each over every fragment\n"
         "      // pair before the next\n",
         "      if constexpr (P == 3) {\n        zero(st.acc);\n        zero(cross);\n      }\n"),
        ("b[j & 1][t == 1][q]);\n    }\n    if constexpr (P == 3) {",
         "b[j & 1][t == 1][q]);\n    if constexpr (P == 3) {"),
        (_ADD + "\n    }\n", _ADD + "\n    }\n    }\n"),
    ],
    "no_lo_loads": [
        ("for (int h = 0; h < kPlanes; ++h) tile::ldsm_x4(fa[h][u].r, at + h * kInLo);",
         "{ tile::ldsm_x4(fa[0][u].r, at); fa[kPlanes - 1][u] = fa[0][u]; }"),
        ("for (int h = 0; h < kPlanes; ++h) tile::ldsm_x4_trans(fb[h][q].r, at + h * kSliceLo);",
         "{ tile::ldsm_x4_trans(fb[0][q].r, at); fb[kPlanes - 1][q] = fb[0][q]; }"),
    ],
    "one_product": [(_PRODUCTS, "      for (int t = 0; t < 1; ++t)\n")],
    "no_products": [(_PRODUCTS, "      for (int t = 0; t < (P == 1 ? 1 : 0); ++t)\n")],
    "bf16_shipped": [],
    "bf16_no_products": [(_WGMMA, "        hopper::fence_fragment(f[u]);\n")],
    "bf16_no_setmaxnreg": _NO_SETMAXNREG,
    "bf16_producer_warp": _NO_SETMAXNREG + [
        ("constexpr int kThreads = kConsumers + 128;",
         "constexpr int kThreads = kConsumers + 32;")],
    "bf16_no_loads": _NO_LOADS,
    "bf16_no_loads_no_ring": _NO_LOADS + _NO_RING,
    "bf16_no_stream": _NO_STREAM,
    "bf16_mma_sync": _MMA_SYNC,
    "bf16_mma_sync_no_products": _MMA_SYNC + [
        (_PRODUCTS, "      for (int t = 0; t < (P == 1 ? 0 : P); ++t)\n")],
    "bf16_mma_sync_no_slice_barrier": _MMA_SYNC + [
        ("  __syncthreads();\n  start_slice<P>(p, ring, i + kRingSlots - 1);",
         "  if (P == 3) __syncthreads();\n  start_slice<P>(p, ring, i + kRingSlots - 1);")],
}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def variant_dtype(name: str) -> str:
    """The dtype of the kernel a variant changes: ``bf16`` or ``f32``."""
    return "bf16" if name.startswith("bf16_") else "f32"


def variant_source(name: str) -> str:
    """``csrc/fused_rdb.cu`` with the variant's replacements; raises when a
    replaced text is not found exactly once (the source moved on)."""
    source = (_build.CSRC / "fused_rdb.cu").read_text()
    for old, new in VARIANTS[name]:
        if source.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} occurs {source.count(old)} times")
        source = source.replace(old, new)
    return source


def build_variants(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """Every variant's library, built at once (one nvcc each)."""
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)

    def build(name):
        src = out_dir / f"{name}.cu"
        src.write_text(variant_source(name))
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                               "-o", str(out_dir / f"{name}.so"), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{proc.stdout}")
        return [line.strip() for line in proc.stdout.splitlines()
                if "Used" in line or "spill" in line]

    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        ptxas = dict(zip(names, pool.map(build, names)))
    libs = {}
    for name in names:
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_rdb_forward.argtypes = [i] + [vp] * 13 + [i, i, i, vp]
        lib.fused_rdb_forward.restype = i
        libs[name] = lib
        print(json.dumps({"variant": name, "ptxas": ptxas[name]}), flush=True)
    return libs


def launch(lib: ctypes.CDLL, x: torch.Tensor, packed, weights) -> torch.Tensor:
    """One launch of a variant's kernel for x's dtype, as ``fused_rdb``
    makes it: ``weights`` the split (float32), the boxes (bfloat16) or None
    (the packed weights, for the mma.sync variants)."""
    out = torch.empty_like(x)
    if isinstance(weights, torch.Tensor):
        hi, lo = [weights] + [None] * 4, [None] * 5
    else:
        hi, lo = weights if weights is not None else (packed[:5], [None] * 5)
    err = lib.fused_rdb_forward(0 if x.dtype == torch.float32 else 1, x.data_ptr(),
                                *[None if t is None else t.data_ptr() for t in (*hi, *lo)],
                                packed[5].data_ptr(),
                                out.data_ptr(), *x.shape[:3],
                                torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed with CUDA error {err}")
    return out


@torch.no_grad()
def rdb_inputs(device: torch.device, dtype: torch.dtype) -> Dict[str, tuple]:
    """name -> (NHWC input, pack, split or boxes) of each RDB in one forward
    of the test image in ``dtype``."""
    pipe = SRPipeline(str(WEIGHTS), bfloat16=dtype == torch.bfloat16, device=device)
    inputs, hooks = {}, []
    for name, module in pipe.model.named_modules():
        if isinstance(module, ResidualDenseBlock):
            def keep(module, args, name=name):
                packed = module.packed_weights(dtype)
                weights = (module.split_weights(packed) if dtype == torch.float32
                           else module.box_weights(packed))
                inputs[name] = (args[0].permute(0, 2, 3, 1).contiguous().clone(), packed, weights)
            hooks.append(module.register_forward_pre_hook(keep))
    image = read_png(str(IMAGE)).astype(np.float32) / 255.0
    pipe.apply(torch.from_numpy(image)[None].to(device))
    for hook in hooks:
        hook.remove()
    return inputs


def main(argv: Sequence[str] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dtype", choices=sorted(DTYPES), default="f32",
                        help="the kernel whose variants run when --variants is not given")
    parser.add_argument("--variants", default=None,
                        help="comma-separated names of VARIANTS, all of one dtype")
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args(argv)
    names = (args.variants.split(",") if args.variants else
             [name for name in VARIANTS if variant_dtype(name) == args.dtype])
    for name in names:
        variant_source(name)  # unknown names and stale replacements fail before the build
    dtypes = {variant_dtype(name) for name in names}
    if len(dtypes) != 1:
        raise ValueError(f"variants of one dtype at a time, not {sorted(dtypes)}")
    dtype = DTYPES[dtypes.pop()]
    device = resolve_device()
    torch.backends.cudnn.allow_tf32 = False
    libs = build_variants(names)
    inputs = rdb_inputs(device, dtype)
    worst = {name: (-1.0, None) for name in names}
    operand = lambda name, weights: None if "mma_sync" in name else weights  # noqa: E731
    for rdb, (x, packed, weights) in inputs.items():
        ref = rdb_plain(x, packed)
        for name, lib in libs.items():
            err = (launch(lib, x, packed, operand(name, weights)) - ref).abs().max().item()
            if err > worst[name][0]:
                worst[name] = (err, rdb)
    x, packed, weights = inputs[TIMED_RDB]
    times = {name: [] for name in names}
    for _ in range(args.rounds):
        for name in names + names[::-1]:
            call = lambda: launch(libs[name], x, packed, operand(name, weights))  # noqa: E731
            times[name].append(time_in_graph(call, 10, device) * 1e3)
    results = {}
    for name in names:
        results[name] = {"variant": name, "dtype": str(dtype), "worst_max_abs_diff": worst[name][0],
                         "worst_rdb": worst[name][1], "rdbs": len(inputs),
                         "device_ms": sum(times[name]) / len(times[name]),
                         "device_ms_in_turns": times[name], "shape": list(x.shape)}
        print(json.dumps(results[name]), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "max_abs_x": max(v[0].abs().max().item()
                                                     for v in inputs.values())}), flush=True)
    return results


if __name__ == "__main__":
    main()
