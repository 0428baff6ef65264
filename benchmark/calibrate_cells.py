"""The readings the limits of ``swinir_l.batch256`` and
``x4plus.batch256_f32`` were set from, on the chip.

    python3 -m benchmark.calibrate_cells --workload <cell> --seeds <a,b,...> \\
        [--control-seeds <x,y,z>] [--control-workload <cell>] [--seconds 2]

For each seed it runs the cell's own driver once, in one process, with a
short window at the cell's own sizes, and prints every number it compared:
the lower readings.  Before each run the TF32 switches are put back to
PyTorch's defaults, as a fresh process of the benchmark finds them (the
judge turns them off for the reference).  ``--control-seeds`` puts the plain
reference in the program's place, computed in float8 (``reference/quant.py``:
the nearest precision below the configuration's bfloat16), beside two faults
planted in the reference put there (one image turned upside down; half of a
batch left out, the first half repeated): the upper readings of
``swinir_l.batch256``.  ``--control-workload`` runs the same seeds through
another cell's driver, whose numbers are the upper readings: for
``x4plus.batch256_f32`` the bfloat16 program of ``x4plus.batch256``.  One
JSON object a line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from benchmark import run as bench_run
from benchmark.calibrate import context
from benchmark.harness import free_device
from benchmark.reference.quant import fp8


def pytorch_defaults() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True


def program(resolved: dict, seed: int, seconds: float, device, kind: str) -> None:
    pytorch_defaults()
    t0 = time.perf_counter()
    out = bench_run.run_cell(context(resolved, seed, seconds, device), resolved["traffic"])
    print(json.dumps({"kind": kind, "cell": resolved["cell"]["name"], "seed": seed,
                      "numbers": {c.name: c.value for c in out.checks},
                      "attempted": out.attempted, "seconds": time.perf_counter() - t0}),
          flush=True)
    del out
    free_device()


def swin_control(ctx) -> dict:
    """``swinir_l.batch256``'s upper readings on ``ctx``'s seed and sizes:
    ``out_err_ratio`` of the float8 reference put in the program's place
    (``control``) and of the two faults planted in the float32 reference."""
    from benchmark.drivers.batch import batch_inputs
    from benchmark.drivers.swin_batch import judge
    from benchmark.reference import swinir as reference
    from benchmark.weights_swinir import swinir_params

    reference.plain_float32()
    params = swinir_params(ctx.config, ctx.seed, ctx.device)
    inputs = batch_inputs(ctx, np.random.default_rng(ctx.seed))
    block, n = ctx.traffic["reference_block"], ctx.traffic["check_forwards"]
    low = [(i, reference.forward_in_blocks(params, inputs[i], ctx.config, block, quant=fp8))
           for i in range(n)]
    refs = [(i, reference.forward_in_blocks(params, inputs[i], ctx.config, block))
            for i in range(n)]
    altered = [(i, torch.cat([r[:1].flip(1), r[1:]])) for i, r in refs]
    repeated = [(i, torch.cat([r[:len(r) // 2]] * 2)) for i, r in refs]
    return {name: {"out_err_ratio": judge(ctx, params, inputs, kept)} for name, kept in
            (("control", low), ("answer_altered", altered), ("half_left_out", repeated))}


def control_swin(resolved: dict, seed: int, device) -> None:
    t0 = time.perf_counter()
    numbers = swin_control(context(resolved, seed, 0.0, device))
    print(json.dumps({"kind": "control", "cell": resolved["cell"]["name"], "seed": seed,
                      "numbers": numbers, "seconds": time.perf_counter() - t0}), flush=True)
    free_device()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--control-workload", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    bench = bench_run.load_benchmark()
    resolved = bench_run.resolve_cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("calibrate_cells: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for seed in seeds:
        program(resolved, seed, args.seconds, device, "program")
    if args.control_workload:
        other = bench_run.resolve_cell(bench, args.control_workload)
        for seed in seeds:
            program(other, seed, args.seconds, device, "control")
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        control_swin(resolved, seed, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
