"""The control comes out not correct: the plain reference put in the
program's place and computed in float8, the nearest precision below the
configurations' bfloat16, fails each serving cell's limit.  Here at full
depth on small inputs on the CPU; ``python -m pytest -m cuda
benchmark/tests/test_bench_control.py`` runs it on the chip at the cells'
own sizes (``benchmark/calibrate.py`` reads it on three seeds or more)."""

import json
import time

import pytest
import torch

from benchmark import calibrate
from benchmark.harness import Context
from benchmark.run import load_benchmark, resolve_cell
from benchmark.tests.conftest import ROOT

SMALL = {"batch": dict(batch=2, height=24, width=24, distinct_batches=1, check_forwards=1,
                       reference_block=2),
         "requests": dict(rate_per_s=2.0, side_min=16, side_max=48, check_requests=2,
                          pipeline=dict(bucket=8, tile_threshold=40, tile=32, tile_overlap=4,
                                        tile_batch=2))}
CELLS = [w["name"] for w in load_benchmark(ROOT)["workloads"]]


def _control(cell: str, small: bool, device: torch.device) -> dict:
    resolved = resolve_cell(load_benchmark(ROOT), cell, ROOT)
    traffic = resolved["traffic"]
    if small:
        traffic = dict(traffic, **SMALL[traffic["driver"]])
    ctx = Context(cell, resolved["config"], traffic, resolved["limits"], 3_000_000_019, 2.0,
                  False, device, time.perf_counter())
    return calibrate.CONTROLS[traffic["driver"]](ctx)["control"], resolved["limits"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_small(cell):
    numbers, limits = _control(cell, True, torch.device("cpu"))
    assert any(numbers[k] > limits[k] for k in limits), json.dumps(numbers)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_cell_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control at the cell's own size")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    numbers, limits = _control(cell, False, torch.device("cuda", 0))
    assert any(numbers[k] > limits[k] for k in limits), json.dumps(numbers)
