"""Convolution and matrix-product experiment tool: the port of
``tools/pallas_conv_exp.py``.

Times the hand-written tensor-core kernels of the port beside the library's
own, at the fused RDB's shapes, to say what a kernel written by hand reaches
there before the RDB kernel is redesigned around it.

    python -m real_esrgan_tpu_torch.tools.conv_exp [--batch 8 --size 256 --tile 32]
    python -m real_esrgan_tpu_torch.tools.conv_exp --mm
    python -m real_esrgan_tpu_torch.tools.conv_exp --gate [--gate-threshold TF/s]
    python -m real_esrgan_tpu_torch.tools.conv_exp --reps-sweep

* default run: ``conv3x3`` (``ops/conv3x3.py``) against the library
  convolution (``F.conv2d``, bfloat16, channels_last) on the same input,
  then the time of the library convolution and of the kernel's four modes;
* ``--mm``: ``mm_resident`` (``ops/mm_probe.py``) at five shapes;
* ``--gate``: ``mm_resident`` at the two shapes that dominate a fused-RDB
  product chain, beside ``torch.matmul`` at the same shapes, shape by shape,
  and one JSON verdict line;
* ``--reps-sweep``: ``mm_resident`` at the gate's shapes at 1 to 32 reps,
  each inside a CUDA graph, and the line through those times: its slope is
  one rep's products, its intercept the work done once a launch (the loads
  of A and B, the reduction, the store, the launch itself).  One JSON line a
  shape.

Each time is that of the launch alone: one warm call, then ``--iters`` calls
between two CUDA events on the current stream.  One library product at the
gate's shapes, and ``mm_resident`` at three of the five, is shorter than its
launch through the host, so ``--mm``, ``--gate`` and ``--reps-sweep`` time
``mm_resident`` (and ``--gate`` the library) inside a CUDA graph of
``--iters`` calls, which leaves the host's gaps out.  Runs on CUDA; ``--cpu`` runs
the kernels' plain versions on the CPU (a check of the tool, not a
measurement), and without ``--cpu`` a machine with no CUDA device is an
error.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from real_esrgan_tpu_torch import resolve_device
from real_esrgan_tpu_torch.ops.conv3x3 import MODES, conv3x3
from real_esrgan_tpu_torch.ops.mm_probe import mm_grid, mm_resident

# The two shapes that dominate a fused-RDB product chain: the dense-growth
# product (k = 192) and the source-packed wide one (k = 576).
GATE_SHAPES = ((8192, 192, 192), (8192, 576, 192))
MM_SHAPES = GATE_SHAPES + ((8192, 96, 160), (8192, 512, 512), (2048, 192, 192))
SWEEP_REPS = (1, 2, 4, 8, 16, 32)
NUMERICS_BOUND = 0.15  # max |conv3x3 - library conv| on bf16 inputs in [0, 1)


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def time_launches(fn: Callable[[], object], iters: int, device: torch.device) -> float:
    """Seconds per call of ``fn``: one warm call, then ``iters`` calls
    between two CUDA events (host clock on the CPU)."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / 1e3 / iters


def time_in_graph(fn: Callable[[], object], iters: int, device: torch.device) -> float:
    """Seconds per call of ``fn`` inside a CUDA graph of ``iters`` calls,
    replayed five times between two events: the device's time for the call,
    without the host's gaps between launches.  On the CPU, ``time_launches``."""
    if device.type != "cuda":
        return time_launches(fn, iters, device)
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        fn()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(iters):
                fn()
    return time_launches(graph.replay, 5, device) / iters


def library_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """HWIO ``w`` as the library convolution takes it: bfloat16 OIHW,
    channels_last."""
    return w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def library_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The library's 'same' 3x3 convolution of NHWC bfloat16 ``x`` with a
    weight from ``library_conv_weight``: the yardstick, which no kernel's
    wrapper calls."""
    return F.conv2d(x.permute(0, 3, 1, 2), weight, padding=1).permute(0, 2, 3, 1)


def mm_operands(m: int, k: int, n: int, scale: float, device: torch.device, seed: int):
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn(m, k, generator=gen, device=device).to(torch.bfloat16)
    b = (torch.randn(k, n, generator=gen, device=device) * scale).to(torch.bfloat16)
    return a, b


def bench_mm_grid(m: int, k: int, n: int, iters: int, device: torch.device, seed: int = 0,
                  timer=time_launches) -> float:
    """TF/s of ``mm_grid`` at (m, k) @ (k, n); prints one line.  One launch
    is shorter than its launch through the host: ``timer=time_in_graph``
    reads the device's time."""
    a, b = mm_operands(m, k, n, 0.05, device, seed)
    dt = timer(lambda: mm_grid(a, b), iters, device)
    tf = 2 * m * k * n / dt / 1e12
    print(f"mm_grid ({m}x{k})@({k}x{n}): {dt * 1e3:7.3f} ms  {tf:6.1f} TF/s", flush=True)
    return tf


def bench_mm_resident(m: int, k: int, n: int, iters: int, device: torch.device,
                      reps: int = 32, seed: int = 0, timer=time_launches) -> float:
    """TF/s of ``mm_resident`` at (m, k) @ (k, n), counted as 2 m k n reps;
    prints one line."""
    a, b = mm_operands(m, k, n, 0.01, device, seed)
    dt = timer(lambda: mm_resident(a, b, reps), iters, device)
    tf = 2 * m * k * n * reps / dt / 1e12
    print(f"mm_resident ({m}x{k})@({k}x{n}) reps={reps}: {dt * 1e3:7.3f} ms  {tf:6.1f} TF/s",
          flush=True)
    return tf


def bench_library_mm(m: int, k: int, n: int, iters: int, device: torch.device,
                     seed: int = 0, timer=time_launches) -> float:
    """TF/s of one ``torch.matmul`` at (m, k) @ (k, n); prints one line."""
    a, b = mm_operands(m, k, n, 0.01, device, seed)
    dt = timer(lambda: torch.matmul(a, b), iters, device)
    tf = 2 * m * k * n / dt / 1e12
    print(f"library mm ({m}x{k})@({k}x{n}): {dt * 1e3:7.3f} ms  {tf:6.1f} TF/s", flush=True)
    return tf


def gate(iters: int, threshold: Optional[float], device: torch.device) -> dict:
    """``mm_resident`` beside ``torch.matmul`` at each fused-RDB shape, both
    timed inside a CUDA graph; prints and returns the verdict.  ``threshold``
    in TF/s; None takes, at each shape, half of what ``torch.matmul`` reaches
    there in this run.  The gate unparks when ``mm_resident`` reaches its
    threshold at every shape; ``value``, ``threshold`` and ``library_tflops``
    are those of the shape where it came closest to failing, or failed by
    most, and ``shapes`` holds both rates for each."""
    shapes = []
    for m, k, n in GATE_SHAPES:
        value = bench_mm_resident(m, k, n, iters, device, timer=time_in_graph)
        library = bench_library_mm(m, k, n, iters, device, timer=time_in_graph)
        limit = library / 2 if threshold is None else threshold
        shapes.append({"shape": [m, k, n], "value": value, "library_tflops": library,
                       "threshold": limit, "unparked": value >= limit})
    worst = min(shapes, key=lambda s: s["value"] / s["threshold"])
    unparked = all(s["unparked"] for s in shapes)
    verdict = {
        "gate": "mm_resident_tflops", "value": worst["value"], "threshold": worst["threshold"],
        "library_tflops": worst["library_tflops"], "unparked": unparked,
        "device": device_name(device),
        "timing": "cuda graph" if device.type == "cuda" else "host loop", "shapes": shapes,
        "note": ("mm_resident reaches its threshold at every fused-RDB shape: a fused-RDB "
                 "kernel built on hand-written tensor-core products unparks" if unparked else
                 "parked: mm_resident stays under its threshold at a fused-RDB shape")}
    print(json.dumps(verdict), flush=True)
    return verdict


def reps_sweep(iters: int, device: torch.device) -> list:
    """``mm_resident`` at each gate shape and each of ``SWEEP_REPS``, timed
    inside a CUDA graph of ``iters`` calls, and the least-squares line t =
    fixed + reps * per_rep through the times; prints and returns one record
    a shape."""
    records = []
    for m, k, n in GATE_SHAPES:
        a, b = mm_operands(m, k, n, 0.01, device, seed=0)
        times = [time_in_graph(lambda: mm_resident(a, b, reps), iters, device) * 1e3
                 for reps in SWEEP_REPS]
        mean_r, mean_t = sum(SWEEP_REPS) / len(SWEEP_REPS), sum(times) / len(times)
        per_rep = (sum((r - mean_r) * (t - mean_t) for r, t in zip(SWEEP_REPS, times))
                   / sum((r - mean_r) ** 2 for r in SWEEP_REPS))
        record = {"reps_sweep": "mm_resident", "shape": [m, k, n], "reps": list(SWEEP_REPS),
                  "ms": times, "fixed_ms": mean_t - per_rep * mean_r, "per_rep_ms": per_rep,
                  "per_rep_tflops": 2 * m * k * n / per_rep / 1e9, "device": device_name(device),
                  "timing": "cuda graph" if device.type == "cuda" else "host loop"}
        print(json.dumps(record), flush=True)
        records.append(record)
    return records


def conv_run(a: argparse.Namespace, device: torch.device) -> None:
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand(a.batch, a.size, a.size, a.cin, generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn(3, 3, a.cin, a.cout, generator=gen, device=device) * 0.05).to(torch.bfloat16)
    weight = library_conv_weight(w)  # both sides get their weights ready-made

    err = (conv3x3(x, w, tile=a.tile).float() - library_conv(x, weight).float()).abs().max().item()
    print(f"max |conv3x3 - library| = {err:.5f}  (bf16 inputs)", flush=True)
    if not err < NUMERICS_BOUND:
        raise RuntimeError(f"numerics mismatch: {err} >= {NUMERICS_BOUND}")

    flops = 2 * 9 * a.cin * a.cout * a.batch * a.size ** 2
    dt = time_launches(lambda: library_conv(x, weight), a.iters, device)
    print(f"library conv {a.cin}->{a.cout}: {dt * 1e3:7.3f} ms  {flops / dt / 1e12:6.1f} TF/s",
          flush=True)
    for mode in MODES:
        dt = time_launches(lambda: conv3x3(x, w, tile=a.tile, mode=mode), a.iters, device)
        print(f"conv3x3[{mode:5s}] tile={a.tile}: {dt * 1e3:7.3f} ms  "
              f"{flops / dt / 1e12:6.1f} TF/s", flush=True)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--cin", type=int, default=64)
    p.add_argument("--cout", type=int, default=192)
    p.add_argument("--tile", type=int, default=32)
    p.add_argument("--iters", type=int, default=100,
                   help="timed launches; a kernel of tens of microseconds needs about a "
                        "hundred before the host's launch rate stops showing")
    p.add_argument("--mm", action="store_true",
                   help="only run the mm_resident probes")
    p.add_argument("--gate", action="store_true",
                   help="measure mm_resident at the fused-RDB shapes beside torch.matmul, "
                        "both inside a CUDA graph, and print a JSON verdict: at or above the "
                        "threshold at every shape, a fused-RDB kernel built on hand-written "
                        "tensor-core products unparks")
    p.add_argument("--reps-sweep", action="store_true",
                   help="time mm_resident at the fused-RDB shapes at 1 to 32 reps and split "
                        "its time into the work done once and one rep's products")
    p.add_argument("--gate-threshold", type=float, default=None,
                   help="TF/s; default: at each shape, half of what torch.matmul reaches "
                        "there in the same run")
    p.add_argument("--cpu", action="store_true", help="Run on the CPU instead of CUDA.")
    return p


def main(argv: Optional[Sequence[str]] = None):
    """Runs the tool; returns the verdict of ``--gate``, the records of
    ``--reps-sweep``, else None."""
    a = build_parser().parse_args(argv)
    device = resolve_device(a.cpu)
    print(f"device: {device_name(device)}", flush=True)
    if a.gate:
        return gate(a.iters, a.gate_threshold, device)
    if a.reps_sweep:
        return reps_sweep(a.iters, device)
    if a.mm:
        for m, k, n in MM_SHAPES:
            bench_mm_resident(m, k, n, a.iters, device, timer=time_in_graph)
    else:
        conv_run(a, device)
    return None


if __name__ == "__main__":
    main()
