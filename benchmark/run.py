"""One run of one cell of the benchmark of the PyTorch/CUDA port
(``real_esrgan_tpu_torch``).

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's entry in ``BENCHMARK.json`` names
its configuration (``benchmark/configs/<config>.json``) and its traffic
(``benchmark/traffic/<traffic>.json``, whose ``driver`` names the module
of ``benchmark/drivers/`` that runs it); its limits are
``benchmark/limits/<cell>.json`` and each metric is read by
``benchmark/metrics/<metric>.py``.  A new cell, mix, configuration or
metric is new files and entries; nothing here names one.

The run sets the program up, warms every shape its traffic uses, measures
for ``--seconds``, has the plain reference judge what the timed path
produced, and prints one JSON line last on standard output (with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, the profiled sub-window and its breakdown), and every
number compared beside its limit as the last lines of standard error.  It
exits non-zero, printing no result, without a CUDA device, with fewer
devices than the cell asks for, and when a module of JAX or of the JAX
package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()  # before the heavy imports: set-up counts from here

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
# top-level module names the port must never load: JAX and its libraries,
# and the JAX package, whose name the port's own name begins with
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "real_esrgan_tpu")


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (``sys.modules``),
    each module's name cut at its first dot and compared whole."""
    names = {name.split(".")[0] for name in list(modules if modules is not None else sys.modules)}
    return sorted(names & set(FORBIDDEN))


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def resolve_cell(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell ``workload`` with its configuration, traffic and limits read
    from their files and the metrics it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no cell {workload!r} in BENCHMARK.json (cells: {sorted(cells)})")
    cell = cells[workload]
    config_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(root / config_entry["file"]) as f:
        config = json.load(f)
    with open(BENCH / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    with open(BENCH / "limits" / f"{workload}.json") as f:
        limits = json.load(f)["limits"]
    end_to_end = [m for m in bench["end_to_end"] if _applies(m, workload)]
    e2e_names = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return {"cell": cell, "config": config, "traffic": traffic, "limits": limits,
            "end_to_end": end_to_end, "per_layer": per_layer}


def metric_reader(name: str):
    """``read(outcome, ctx) -> float | None`` of ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}",
                                                  BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def power_limit() -> str:
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20)
        return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def read_metrics(entries, outcome, ctx) -> dict:
    metrics = {}
    for m in entries:
        value = metric_reader(m["name"])(outcome, ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return metrics


def run_cell(ctx, traffic: dict):
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    ctx.lap("program_import")
    return driver.run(ctx)


def kernel_build_seconds() -> float:
    """Seconds the program spent compiling its CUDA kernels in this process
    (its build log; 0 where every kernel was already built): the part of a
    checkout's first set-up that later runs do not pay."""
    build = sys.modules.get("real_esrgan_tpu_torch.ops._build")
    return float(sum(entry.get("seconds", 0.0)
                     for entry in getattr(build, "BUILD_LOG", {}).values()))


def result_line(ctx, resolved: dict, outcome, device: dict) -> dict:
    result = {"correct": outcome.correct, "attempted": outcome.attempted,
              "failed": outcome.failed,
              "metrics": read_metrics(resolved["per_layer"] if ctx.trace
                                      else resolved["end_to_end"], outcome, ctx),
              "device": device}
    if ctx.trace and outcome.profile and outcome.profile.get("busy_s"):
        result["device"] = {**device, "busy_s": outcome.profile["busy_s"],
                            "window_s": outcome.profile["window_s"]}
        result["breakdown"] = outcome.profile["breakdown"]
    result["setup"] = {"phases_s": ctx.setup_phases, "kernel_build_s": kernel_build_seconds()}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.seed < 0 or args.seconds <= 0:
        parser.error("--seed must be >= 0 and --seconds > 0")

    resolved = resolve_cell(load_benchmark(), args.workload)
    chips = resolved["cell"]["chips"]
    import torch

    from benchmark.harness import Context

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = Context(workload=args.workload, config=resolved["config"],
                  traffic=resolved["traffic"], limits=resolved["limits"], seed=args.seed,
                  seconds=args.seconds, trace=bool(args.trace),
                  device=torch.device("cuda", 0), t_start=T_START)
    ctx.lap("imports")
    torch.empty(1, device=ctx.device)
    torch.cuda.synchronize(ctx.device)
    ctx.lap("cuda_init")
    outcome = run_cell(ctx, resolved["traffic"])
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": int(outcome.memory_peak_bytes),
              "power_limit": power_limit()}
    result = result_line(ctx, resolved, outcome, device)

    loaded = forbidden_loaded()
    if loaded:
        print(f"benchmark: forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in ctx.setup_phases.items())
          + f" kernel_build {result['setup']['kernel_build_s']:.3f}", file=sys.stderr)
    for c in outcome.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
