"""The SwinIR cell and the float32 cell: their work counts, weights and
limits, on the CPU.

The closed-form count of ``workcount_swinir`` equals PyTorch's FLOP counter
on the plain reference at small sizes, and the published figures at full
width; the seeded weights carry the program's names and shapes; a run of
each new cell at a tiny size comes out correct, and not correct with the
timed path broken (for the float32 cell: a program that computes in
bfloat16); the float8 control of the SwinIR cell, the plain reference
computed in float8 and put in the program's place, comes out not correct
(``benchmark/calibrate_cells.py`` reads it at the cell's size on the chip)."""

import json
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import workcount_swinir
from benchmark.calibrate_cells import swin_control
from benchmark.harness import Context
from benchmark.reference import swinir as reference
from benchmark.run import run_cell
from benchmark.tests.conftest import ROOT
from benchmark.tests.test_bench_faults import _altered_answer, _half_batch_served
from benchmark.weights_swinir import swinir_params
from real_esrgan_tpu_torch.models.swinir import SwinIR


def _json(*parts):
    with open(ROOT.joinpath("benchmark", *parts)) as f:
        return json.load(f)


SWIN = _json("configs", "swinir_l_realsr_x4.json")


@pytest.mark.parametrize("embed,depths,heads,feat", [(60, [2], [2], 16), (90, [2, 2], [3, 3], 8)])
def test_closed_form_matches_flop_counter(embed, depths, heads, feat):
    cfg = dict(SWIN, embed_dim=embed, depths=depths, num_heads=heads, num_feat=feat,
               dtype="float32")
    params = swinir_params(cfg, 7, "cpu")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        reference.forward(params, torch.rand(2, 16, 24, 3), cfg)
    expected = workcount_swinir.forward_flop(cfg, 2, 16, 24)
    assert abs(counter.get_total_flops() - expected) <= 1e-4 * expected


def test_full_width_figures():
    assert workcount_swinir.swin_block_flop(SWIN) == 983_040
    assert workcount_swinir.swin_linear_flop(SWIN) == 921_600
    assert workcount_swinir.forward_flop_per_lr_pixel(SWIN) == 61_339_104
    assert workcount_swinir.flop_per_output_mp(SWIN) == pytest.approx(3.8337e12, rel=1e-4)
    assert workcount_swinir.window_attn_bytes(SWIN, 1) == 1920
    peaks = {"flops": {"bfloat16": 989.4e12}, "bytes_per_s": 3.35e12}
    # bound by bytes at the cell's 16 x 256^2 tokens: 0.601 ms a call
    assert workcount_swinir.window_attn_least_seconds(SWIN, 16 * 256 * 256, peaks) == \
        pytest.approx(0.6009e-3, rel=1e-3)


def test_seeded_weights_are_the_programs_parameters():
    cfg = dict(SWIN, depths=[2], num_heads=[2], embed_dim=60, num_feat=16)
    params = swinir_params(cfg, 2 ** 31 + 3, "cpu")
    model = SwinIR(embed_dim=60, depths=(2,), num_heads=(2,), num_feat=16)
    model.load_state_dict(params)  # strict
    tables = [v for k, v in params.items() if k.endswith("relative_position_bias_table")]
    assert all(0.8 < float(t.std()) < 1.2 for t in tables)  # N(0, 1), not 0.02


def _run(cell: str, dtype=None, **traffic_overrides):
    entry = {w["name"]: w for w in _json("..", "BENCHMARK.json")["workloads"]}[cell]
    config_file = {c["name"]: c["file"] for c in _json("..", "BENCHMARK.json")["configs"]}
    with open(ROOT / config_file[entry["config"]]) as f:
        config = json.load(f)
    traffic = dict(_json("traffic", f"{entry['traffic']}.json"), **traffic_overrides)
    if dtype is not None:
        traffic["dtype"] = dtype
    limits = _json("limits", f"{cell}.json")["limits"]
    ctx = Context(cell, config, traffic, limits, 2 ** 31 + 77, 0.5, False,
                  torch.device("cpu"), time.perf_counter())
    return run_cell(ctx, traffic)


TINY = dict(batch=2, height=16, width=24, distinct_batches=2, warmup_forwards=1,
            check_forwards=2, reference_block=2)


@pytest.mark.parametrize("fault", [None, "answer_altered", "half_left_out"])
def test_swinir_cell_fault_comes_out_not_correct(fault, monkeypatch):
    if fault == "answer_altered":
        _altered_answer(monkeypatch)
    elif fault == "half_left_out":
        _half_batch_served(monkeypatch)
    out = _run("swinir_l.batch256", **TINY)
    assert out.correct == (fault is None), [(c.value, c.limit) for c in out.checks]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_float32_cell_refuses_a_bfloat16_program(dtype):
    out = _run("x4plus.batch256_f32", dtype=dtype, **dict(TINY, batch=4, height=16, width=20,
                                                          reference_block=4))
    assert out.correct == (dtype == "float32"), [(c.value, c.limit) for c in out.checks]


def test_swinir_float8_control_comes_out_not_correct():
    """At full depth on tiny inputs on the CPU: the float8 control and both
    planted faults read above the cell's limit."""
    cfg = _json("configs", "swinir_l_realsr_x4.json")
    traffic = dict(_json("traffic", "swin_batch256.json"), **dict(TINY, check_forwards=1))
    limits = _json("limits", "swinir_l.batch256.json")["limits"]
    ctx = Context("swinir_l.batch256", cfg, traffic, limits, 2 ** 31 + 91, 0.0, False,
                  torch.device("cpu"), time.perf_counter())
    numbers = swin_control(ctx)
    assert all(n["out_err_ratio"] > limits["out_err_ratio"] for n in numbers.values()), numbers
