"""The requests cell's schedule: deterministic, the same sizes and arrivals
for every seed with the seed's own images, the stated size distribution and
tiled share."""

import json
import math

import numpy as np

from benchmark.drivers.requests import schedule
from benchmark.harness import image_source
from benchmark.tests.conftest import ROOT

TRAFFIC = json.load(open(ROOT / "benchmark" / "traffic" / "requests.json"))


def _shape(sched):
    return [(round(t, 12), img.shape) for t, img in sched]


def test_deterministic():
    image = image_source()
    a, b = schedule(TRAFFIC, 2 ** 31 + 99, 40, image), schedule(TRAFFIC, 2 ** 31 + 99, 40, image)
    assert _shape(a) == _shape(b)
    assert all(np.array_equal(x[1], y[1]) for x, y in zip(a, b))


def test_every_seed_the_same_schedule_other_images():
    image = image_source()
    a, b = schedule(TRAFFIC, 1, 40, image), schedule(TRAFFIC, 3_000_000_007, 40, image)
    assert len(a) == len(b) == round(TRAFFIC["rate_per_s"] * 40)
    assert _shape(a) == _shape(b)
    assert not any(np.array_equal(x[1], y[1]) for x, y in zip(a, b))


def test_size_distribution_and_tiled_share():
    traffic = dict(TRAFFIC, rate_per_s=50.0)
    sched = schedule(traffic, 12345, 40, image_source())
    h = np.array([img.shape[0] for _, img in sched])
    w = np.array([img.shape[1] for _, img in sched])
    assert h.min() >= traffic["side_min"] and h.max() <= traffic["side_max"]
    # log-uniform: the median side is the geometric mean of the range
    assert abs(np.median(np.log(h)) - 0.5 * math.log(96 * 640)) < 0.02
    tiled = np.mean(np.maximum(h, w) > traffic["pipeline"]["tile_threshold"])
    assert 0.19 < tiled < 0.25  # 1 - (ln(512/96) / ln(640/96))^2 = 0.221
    gaps = np.diff([0.0] + [t for t, _ in sched])
    assert abs(gaps.mean() * traffic["rate_per_s"] - 1) < 0.01
    assert all(img.dtype == np.float32 and 0 <= img.min() and img.max() <= 1 for _, img in sched)
