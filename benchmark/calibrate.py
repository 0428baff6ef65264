"""The readings the benchmark's limits and rates were set from, on the chip.

    python3 -m benchmark.calibrate readings --workload <cell> --seeds <a,b,...> \\
        --control-seeds <x,y,z> [--seconds 2]
    python3 -m benchmark.calibrate sweep --workload <requests cell> \\
        --rates 4,6,8 --seconds 20 --seed <n>

``readings`` runs the cell's own driver once a seed, in one process, with
a short window at the cell's own sizes, and prints every number it
compared: the lower readings.  For each control seed it puts the plain
reference in the program's place, computed in float8
(``reference/quant.py``: the nearest precision below the configurations'
bfloat16), and prints the same numbers: the upper readings; and the same
numbers of the faults the cell can have, planted in the reference put in
the program's place (one answer altered; half of a batch left out, the
first half repeated).

``sweep`` offers the requests cell's traffic at each rate and prints the
latency percentiles, the mean service time and whether the queue grew
(how late the last quarter of the requests was sent against the first),
from which the cell's fixed rate is set.  Both print one JSON object a
line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from benchmark import run as bench_run
from benchmark.harness import Context, GapRatio, free_device, image_source, percentile_nearest_rank
from benchmark.reference import generator as reference
from benchmark.reference.quant import fp8
from benchmark.reference.serve import serve as reference_serve
from benchmark.weights import generator_params


def context(resolved: dict, seed: int, seconds: float, device) -> Context:
    return Context(workload=resolved["cell"]["name"], config=resolved["config"],
                   traffic=resolved["traffic"], limits=resolved["limits"], seed=seed,
                   seconds=seconds, trace=False, device=device, t_start=time.perf_counter())


def control_batch(ctx: Context) -> dict:
    from benchmark.drivers.batch import batch_inputs, judge
    params = generator_params(ctx.config, ctx.seed, ctx.device)
    inputs = batch_inputs(ctx, np.random.default_rng(ctx.seed))
    block = ctx.traffic["reference_block"]
    low = [(i, reference.forward_in_blocks(params, inputs[i], ctx.config, block, quant=fp8))
           for i in range(ctx.traffic["check_forwards"])]
    refs = [(i, reference.forward_in_blocks(params, inputs[i], ctx.config, block))
            for i in range(ctx.traffic["check_forwards"])]
    # the faults, planted in the reference put in the program's place: one
    # image's answer turned upside down; the first half of a batch repeated
    altered = [(i, torch.cat([r[:1].flip(1), r[1:]])) for i, r in refs]
    repeated = [(i, torch.cat([r[:len(r) // 2]] * 2)) for i, r in refs]
    return {name: {"out_err_ratio": judge(ctx, params, inputs, kept)} for name, kept in
            (("control", low), ("answer_altered", altered), ("half_left_out", repeated))}


def control_requests(ctx: Context) -> dict:
    from benchmark.drivers.requests import sample_indices, schedule
    params = generator_params(ctx.config, ctx.seed, ctx.device)
    requests = schedule(ctx.traffic, ctx.seed, ctx.seconds, image_source())
    p = ctx.traffic["pipeline"]
    serving = dict(bucket=p["bucket"], tile_threshold=p["tile_threshold"], tile=p["tile"],
                   overlap=p["tile_overlap"])
    gaps = {"control": GapRatio(), "answer_altered": GapRatio()}
    for i in sorted(sample_indices(requests, ctx.seed, ctx.traffic["check_requests"])):
        image = requests[i][1]
        ref, low, ref16 = (torch.from_numpy(reference_serve(
            params, image, ctx.config, ctx.device, quant=q, dtype=d, **serving))[None]
            for q, d in ((None, torch.float32), (fp8, torch.float32),
                         (None, torch.bfloat16)))
        gaps["control"].add(low, ref, ref16)
        gaps["answer_altered"].add(ref.flip(1), ref, ref16)
    return {name: {"out_err_ratio": gap.value()} for name, gap in gaps.items()}


CONTROLS = {"batch": control_batch, "requests": control_requests}


def readings(args, resolved, device) -> None:
    reference.plain_float32()
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        out = bench_run.run_cell(context(resolved, seed, args.seconds, device),
                                 resolved["traffic"])
        record = {"kind": "program", "seed": seed,
                  "numbers": {c.name: c.value for c in out.checks},
                  "attempted": out.attempted, "seconds": time.perf_counter() - t0}
        print(json.dumps(record), flush=True)
        del out
        free_device()
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t0 = time.perf_counter()
        numbers = CONTROLS[resolved["traffic"]["driver"]](
            context(resolved, seed, args.seconds, device))
        print(json.dumps({"kind": "control", "seed": seed, "numbers": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
        free_device()


def sweep(args, resolved, device) -> None:
    from benchmark.drivers.batch import build_pipeline
    from benchmark.drivers.requests import open_loop, schedule, shape_key
    ctx = context(resolved, args.seed, args.seconds, device)
    pipe = build_pipeline(ctx, generator_params(ctx.config, ctx.seed, device))
    image = image_source()
    for rate in [float(r) for r in args.rates.split(",")]:
        traffic = dict(ctx.traffic, rate_per_s=rate)
        requests = schedule(traffic, ctx.seed, ctx.seconds, image)
        firsts = {}
        for _, img in requests:
            firsts.setdefault(shape_key(pipe, img), img)
        for img in firsts.values():
            pipe.upscale(img)
        torch.cuda.synchronize()
        loop = open_loop(pipe, requests)
        q = len(requests) // 4
        slowest = sorted(range(len(requests)), key=lambda i: -loop["service"][i])[:5]
        print(json.dumps({
            "slowest": [[i, shape_key(pipe, requests[i][1]), loop["service"][i] * 1e3]
                        for i in slowest],
            "rate_per_s": rate, "requests": len(requests),
            "p50_ms": percentile_nearest_rank(loop["latency"], 50) * 1e3,
            "p95_ms": percentile_nearest_rank(loop["latency"], 95) * 1e3,
            "mean_service_ms": float(np.mean(loop["service"])) * 1e3,
            "completed_per_s": len(requests) / (loop["end"] - loop["start"]),
            "late_first_quarter_ms": float(np.median(loop["late"][:q])) * 1e3,
            "late_last_quarter_ms": float(np.median(loop["late"][-q:])) * 1e3}), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("mode", choices=("readings", "sweep"))
    parser.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--rates", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    resolved = bench_run.resolve_cell(bench_run.load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    (readings if args.mode == "readings" else sweep)(args, resolved, torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
