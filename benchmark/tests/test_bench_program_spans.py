"""The readers of the program's spans (``program_spans.py`` and the four
metrics on it): each reads exactly the window of a requests run, gives no
number where the window does not line up with the driver's service times
or the program keeps no spans, and on the requests cell's own schedule the
pixel shares come out at their closed forms."""

import json
from collections import deque

import numpy as np
import pytest
import torch

from benchmark import run as bench_run
from benchmark.drivers.requests import is_tiled, schedule
from benchmark.harness import Outcome
from benchmark.tests.conftest import ROOT
from real_esrgan_tpu_torch.serve import SRPipeline
from real_esrgan_tpu_torch.utils import profiling

TRAFFIC = json.load(open(ROOT / "benchmark" / "traffic" / "requests.json"))
READERS = ["serve.host_ms_p50.requests", "tiling.host_ms_p50.requests",
           "serve.useful_px_share.requests", "tiling.useful_px_share.requests"]


@pytest.fixture
def ring(monkeypatch):
    fresh = deque(maxlen=profiling.RING_SIZE)
    monkeypatch.setattr(profiling, "RING", fresh)
    return fresh


def _record(tiled: bool, host_ms: float, profiled: bool = False, name: str = "serve.upscale"):
    """A finished request: ``host_ms`` of host work and 10 ms waiting; its
    pixels tell which part of the run it belongs to."""
    wait_ns = 10 ** 7
    px_run = int(host_ms * 1000)
    return profiling.Record(0, name, profiled, 0, int(host_ms * 1e6) + wait_ns, False,
                            {"tiling.wait" if tiled else "serve.wait": wait_ns, "x.prepare": 1},
                            px_useful=px_run // 2, px_run=px_run, tiles=2 if tiled else 0)


def _outcome(window):
    out = Outcome(attempted=len(window))
    out.values.update(service_s_tiled=[0.1 for r in window if r.tiled],
                      service_s_untiled=[0.02 for r in window if not r.tiled])
    return out


def _read(name, outcome):
    return bench_run.metric_reader(name)(outcome, None)


def test_each_reader_reads_exactly_the_window(ring):
    warmups = [_record(i % 3 == 0, 500.0 + i) for i in range(12)]
    window = [_record(t, ms) for t, ms in [(False, 2.0), (True, 7.0), (False, 4.0),
                                           (False, 3.0), (True, 9.0), (True, 8.0)]]
    profiled = [_record(i % 2 == 0, 900.0 + i, profiled=True) for i in range(5)]
    stray = [_record(False, 700.0, name="tiling.canvas")]  # another root, not a request
    ring.extend(warmups + window[:3] + stray + window[3:] + profiled)
    out = _outcome(window)
    assert _read("serve.host_ms_p50.requests", out) == pytest.approx(3.0)
    assert _read("tiling.host_ms_p50.requests", out) == pytest.approx(8.0)
    # px_useful is half of px_run, rounded down, in every record
    untiled_run = 2000 + 4000 + 3000
    assert _read("serve.useful_px_share.requests", out) == pytest.approx(
        100.0 * (1000 + 2000 + 1500) / untiled_run)
    assert _read("tiling.useful_px_share.requests", out) == pytest.approx(
        100.0 * (3500 + 4500 + 4000) / (7000 + 9000 + 8000))


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("fault", ["one_request_more", "one_service_time_less",
                                   "too_few_records", "no_program_spans"])
def test_a_misaligned_window_gives_no_number(ring, monkeypatch, name, fault):
    window = [_record(t, 2.0 + i) for i, t in enumerate([False, True, False, True])]
    ring.extend(window)
    out = _outcome(window)
    assert _read(name, out) is not None
    if fault == "one_request_more":
        out.attempted += 1  # the window then starts one record early, in no warm-up
    elif fault == "one_service_time_less":  # of the reader's kind of request
        out.values["service_s_tiled" if name.startswith("tiling") else "service_s_untiled"].pop()
    elif fault == "too_few_records":
        ring.popleft()
    else:  # a program without the recorder, as before the spans were added
        monkeypatch.delattr(profiling, "requests")
    assert _read(name, out) is None


def test_the_schedules_pixel_shares_are_their_closed_forms(ring):
    """Every request of the requests cell's 51 s schedule through the
    program's ``SRPipeline.upscale`` at the cell's serving geometry, the
    generator replaced by the identity at x1 (the counters depend on the
    geometry alone): untiled 26,799,259 of 30,350,336 pixels run are the
    images', tiled 19,257,390 of 73,598,976."""
    # one channel of a blank photograph: the sizes are the schedule's, the
    # memory a third
    source = np.broadcast_to(np.zeros((1, 1, 1), np.uint8), (640, 640, 1))
    requests = schedule(TRAFFIC, 2 ** 31 + 5, 51, source)
    pipe = SRPipeline(device="cpu", upscale_factor=1, num_rrdb=1, bfloat16=False,
                      **TRAFFIC["pipeline"])
    pipe.model = torch.nn.Identity()
    pipe.models = [pipe.model]
    for _, image in requests:
        pipe.upscale(image)
    tiled = [is_tiled(pipe, image) for _, image in requests]
    out = Outcome(attempted=len(requests))
    out.values.update(service_s_tiled=[0.1] * sum(tiled),
                      service_s_untiled=[0.02] * (len(tiled) - sum(tiled)))
    assert (len(requests), sum(tiled)) == (561, 124)
    records = profiling.requests()
    assert sum(r.px_useful for r in records if not r.tiled) == 26_799_259
    assert sum(r.px_run for r in records if r.tiled) == 73_598_976
    assert round(_read("serve.useful_px_share.requests", out), 2) == 88.30
    assert round(_read("tiling.useful_px_share.requests", out), 2) == 26.17
    for name in ("serve.host_ms_p50.requests", "tiling.host_ms_p50.requests"):
        assert _read(name, out) > 0
