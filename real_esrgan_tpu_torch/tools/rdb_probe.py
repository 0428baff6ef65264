"""Variants of the float32 RDB kernel (``csrc/fused_rdb.cu``,
``rdb_f32_split_kernel``) side by side on the card.

    python -m real_esrgan_tpu_torch.tools.rdb_probe [--variants shipped,no_products] [--rounds 2]

Each variant is the kernel's source with a few lines replaced (``VARIANTS``):

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

The tool builds every variant at once with nvcc into ``_build/probe/``, keeps
the input of each of the 69 RDBs in one float32 forward of
``tests/data/tree_lr.png`` through ``SRPipeline`` with the committed
weights, and prints one JSON line a variant: its worst max-abs difference
from ``rdb_plain`` over those 69 inputs, and its time at (1, 256, 512, 64)
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
}


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
        return [line.strip() for line in proc.stdout.splitlines() if "Used" in line]

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


def launch(lib: ctypes.CDLL, x: torch.Tensor, packed, split) -> torch.Tensor:
    """One launch of a variant's float32 kernel, as ``fused_rdb`` makes it."""
    out = torch.empty_like(x)
    hi, lo = split
    err = lib.fused_rdb_forward(0, x.data_ptr(), *[t.data_ptr() for t in hi],
                                *[t.data_ptr() for t in lo], packed[5].data_ptr(),
                                out.data_ptr(), *x.shape[:3],
                                torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed with CUDA error {err}")
    return out


@torch.no_grad()
def rdb_inputs(device: torch.device) -> Dict[str, tuple]:
    """name -> (NHWC input, f32 pack, split) of each RDB in one float32
    forward of the test image."""
    pipe = SRPipeline(str(WEIGHTS), bfloat16=False, device=device)
    inputs, hooks = {}, []
    for name, module in pipe.model.named_modules():
        if isinstance(module, ResidualDenseBlock):
            def keep(module, args, name=name):
                packed = module.packed_weights(torch.float32)
                inputs[name] = (args[0].permute(0, 2, 3, 1).contiguous().clone(), packed,
                                module.split_weights(packed))
            hooks.append(module.register_forward_pre_hook(keep))
    image = read_png(str(IMAGE)).astype(np.float32) / 255.0
    pipe.apply(torch.from_numpy(image)[None].to(device))
    for hook in hooks:
        hook.remove()
    return inputs


def main(argv: Sequence[str] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", default=",".join(VARIANTS),
                        help="comma-separated names of VARIANTS")
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args(argv)
    device = resolve_device()
    names = args.variants.split(",")
    for name in names:
        variant_source(name)  # unknown names and stale replacements fail before the build
    torch.backends.cudnn.allow_tf32 = False
    libs = build_variants(names)
    inputs = rdb_inputs(device)
    worst = {name: (0.0, None) for name in names}
    for rdb, (x, packed, split) in inputs.items():
        ref = rdb_plain(x, packed)
        for name, lib in libs.items():
            err = (launch(lib, x, packed, split) - ref).abs().max().item()
            if err > worst[name][0]:
                worst[name] = (err, rdb)
    x, packed, split = inputs[TIMED_RDB]
    times = {name: [] for name in names}
    for _ in range(args.rounds):
        for name in names + names[::-1]:
            times[name].append(time_in_graph(lambda: launch(libs[name], x, packed, split),
                                             10, device) * 1e3)
    results = {}
    for name in names:
        results[name] = {"variant": name, "worst_max_abs_diff": worst[name][0],
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
