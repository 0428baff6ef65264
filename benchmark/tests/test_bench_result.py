"""The run's last line and its exits: the keys the format asks for, the numbers
compared last, no result without a CUDA device or without the program."""

import json
import shutil
import subprocess
import sys

from benchmark.harness import Check, Context, Outcome
from benchmark.run import load_benchmark, resolve_cell, result_line
from benchmark.tests.conftest import ROOT


def _outcome(trace: bool) -> Outcome:
    out = Outcome(setup_s=12.5, window_s=40.0, attempted=2400, failed=0,
                  values={"output_mp": 2800.0, "forwards": 150, "batch": 16, "height": 256,
                          "width": 256},
                  spans_ms={"rdb": 30000.0, "tail": 6000.0},
                  checks=[Check("out_err_ratio", 0.006, 0.02)])
    if trace:
        out.profile = {"busy_s": 0.7, "window_s": 0.75,
                       "breakdown": {"device_ops": [["k", 0.5]], "idle_gaps": [["g", 0.01]]}}
    return out


def test_last_line_keys():
    import torch
    resolved = resolve_cell(load_benchmark(ROOT), "x4plus.batch256", ROOT)
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
              "memory_peak_bytes": 1}
    for trace in (False, True):
        ctx = Context("x4plus.batch256", resolved["config"], resolved["traffic"],
                      resolved["limits"], 1, 40.0, trace, torch.device("cpu"), 0.0)
        line = result_line(ctx, resolved, _outcome(trace), device)
        assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
        assert list(line)[-1] == "checks" and line["correct"] is True
        assert set(line["setup"]) == {"phases_s", "kernel_build_s"}
        assert line["checks"] == {"out_err_ratio": {"value": 0.006, "limit": 0.02}}
        if trace:
            assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
            # a share of a peak is read on a device the peak table holds, not on the CPU
            assert set(line["metrics"]) == {"tail.ms_per_mp.serve", "idle_share.serve"}
        else:
            assert set(line["metrics"]) == {"sr_mp_per_s", "setup_s"}
            assert line["metrics"]["sr_mp_per_s"] == {"value": 70.0, "unit": "MP/s"}
        json.dumps(line)


def _bench(cwd):
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "x4plus.batch256", "--seed", "3000000001", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True)


def test_no_result_without_a_cuda_device():
    import torch
    if torch.cuda.is_available():
        return  # the chip's own runs prove the other side
    proc = _bench(ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_no_result_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _bench(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_setup_phases_add_up_to_the_laps():
    import time

    import torch
    ctx = Context("x4plus.batch256", {}, {}, {}, 1, 1.0, False, torch.device("cpu"),
                  time.perf_counter())
    ctx.lap("imports")
    ctx.lap("warmup")
    ctx.lap("imports")
    end = ctx.lap("warmup")
    assert list(ctx.setup_phases) == ["imports", "warmup"]
    assert abs(sum(ctx.setup_phases.values()) - (end - ctx.t_start)) < 1e-9
