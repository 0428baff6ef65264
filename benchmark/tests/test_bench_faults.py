"""The rest of a run, with the look for a chip skipped and the timed path
broken underneath, comes out not correct: one case a fault each cell can
have.  The cells run on the CPU at a tiny size in float32, under their own
limits, and the unbroken run comes out correct.  The configurations keep
their depth: a generator of random weights with few blocks gives an output
that hardly depends on where its input lies, which no comparison can tell
from a moved one."""

import json
import time

import numpy as np
import pytest
import torch

from benchmark.harness import Context
from benchmark.run import run_cell
from benchmark.tests.conftest import ROOT
from real_esrgan_tpu_torch import serve as serve_module


def _json(*parts):
    with open(ROOT.joinpath("benchmark", *parts)) as f:
        return json.load(f)


def _run(cell: str, traffic_name: str, config_name: str, **traffic_overrides):
    config = dict(_json("configs", f"{config_name}.json"), dtype="float32")
    traffic = dict(_json("traffic", f"{traffic_name}.json"), **traffic_overrides)
    limits = _json("limits", f"{cell}.json")["limits"]
    ctx = Context(cell, config, traffic, limits, 2 ** 31 + 77, 0.5, False,
                  torch.device("cpu"), time.perf_counter())
    return run_cell(ctx, traffic)


BATCH = dict(batch=4, height=16, width=20, distinct_batches=2, warmup_forwards=1,
             check_forwards=2, reference_block=4)
REQUESTS = dict(rate_per_s=40.0, side_min=8, side_max=40, check_requests=3,
                pipeline=dict(bucket=8, tile_threshold=32, tile=24, tile_overlap=4, tile_batch=2))


def _altered_answer(monkeypatch):
    apply = serve_module.SRPipeline.apply

    def broken(self, batch):
        out = apply(self, batch).clone()
        out[0] = out[0].flip(0)  # one image's answer altered where it is produced
        return out
    monkeypatch.setattr(serve_module.SRPipeline, "apply", broken)


def _half_batch_served(monkeypatch):
    apply = serve_module.SRPipeline.apply

    def broken(self, batch):
        half = apply(self, batch[:len(batch) // 2])
        return torch.cat([half, half])  # half the batch left out, the rest repeated
    monkeypatch.setattr(serve_module.SRPipeline, "apply", broken)


def _tiles_misstitched(monkeypatch):
    tiled = serve_module.tiled_upscale

    def broken(*args, **kwargs):
        return np.ascontiguousarray(tiled(*args, **kwargs)[:, ::-1])
    monkeypatch.setattr(serve_module, "tiled_upscale", broken)


X4, ANIME = "realesrgan_x4plus", "realesrgan_x4plus_anime_6b"
CELLS = {
    "x4plus.batch256": ("batch256", X4, BATCH,
                        {"answer_altered": _altered_answer, "half_left_out": _half_batch_served}),
    "anime6b.batch256": ("batch256", ANIME, BATCH,
                         {"answer_altered": _altered_answer, "half_left_out": _half_batch_served}),
    "x4plus.requests": ("requests", X4, REQUESTS,
                        {"answer_altered": _altered_answer, "tiles_misstitched": _tiles_misstitched}),
}
CASES = [(cell, fault) for cell, (*_, faults) in CELLS.items() for fault in [None, *faults]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_comes_out_not_correct(cell, fault, monkeypatch):
    traffic, config, overrides, faults = CELLS[cell]
    if fault is not None:
        faults[fault](monkeypatch)
    out = _run(cell, traffic, config, **overrides)
    numbers = {c.name: (c.value, c.limit) for c in out.checks}
    assert out.correct == (fault is None), numbers
