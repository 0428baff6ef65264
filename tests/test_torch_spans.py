"""The port's request spans and work counters (``utils/profiling.py``): how
spans nest and close, the records that ``SRPipeline.upscale`` and the tiling
functions leave on a tiny CPU pipeline, the bounded ring, and the
``torch.profiler`` ranges that spans open only while a profiler is active."""

import math
import threading
from collections import deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from real_esrgan_tpu_torch.parallel.tiling import pad_for_tiles, tile_grid, tiled_canvas, \
    tiled_upscale
from real_esrgan_tpu_torch.serve import SRPipeline, no_grad_forward
from real_esrgan_tpu_torch.utils import profiling

torch.set_num_threads(2)

UNTILED = ("serve.prepare", "serve.launch", "serve.wait", "serve.finish")
# a tiled request's stages that do not overlap, and the two spans around them
TILED = ("tiling.prepare", "tiling.batch", "tiling.stitch", "tiling.wait", "tiling.finish")
TILED_AROUND = ("tiling.upscale", "tiling.canvas")


@pytest.fixture(autouse=True)
def ring(monkeypatch):
    """A ring of this test's own, so records of other tests do not show."""
    fresh = deque(maxlen=profiling.RING_SIZE)
    monkeypatch.setattr(profiling, "RING", fresh)
    return fresh


@pytest.fixture(scope="module")
def pipelines():
    """Tiny f32 pipelines of one RRDB at two serving geometries."""
    return {geometry: SRPipeline(device="cpu", num_rrdb=1, bfloat16=False, **dict(geometry))
            for geometry in GEOMETRIES}


GEOMETRIES = [
    (("bucket", 32), ("tile_threshold", 128), ("tile", 64), ("tile_overlap", 8),
     ("tile_batch", 8)),
    (("bucket", 8), ("tile_threshold", 64), ("tile", 40), ("tile_overlap", 4),
     ("tile_batch", 3)),
]


def test_spans_nest_and_share_the_request(ring):
    with profiling.span("root") as root:
        with profiling.span("child") as child:
            with profiling.span("grandchild") as grandchild:
                pass
        with profiling.span("child"):
            pass
    with profiling.span("next") as other:
        pass
    assert root.parent is None and child.parent is root and grandchild.parent is child
    assert root.record is child.record is grandchild.record and other.record is not root.record
    first, second = ring
    assert (first.name, second.name) == ("root", "next") and first is root.record
    assert first.id != second.id
    assert set(first.stages) == {"child", "grandchild"} and second.stages == {}
    assert first.stages["grandchild"] == grandchild.end_ns - grandchild.start_ns
    assert first.stages["child"] >= first.stages["grandchild"]
    assert (first.start_ns, first.end_ns) == (root.start_ns, root.end_ns)
    assert first.duration_ns >= first.stages["child"]
    assert not first.failed and not first.profiled


@pytest.mark.parametrize("depth", [0, 1, 2], ids=["root", "child", "grandchild"])
def test_a_span_closes_on_an_exception_and_fails_the_record(ring, depth):
    names = ["root", "child", "grandchild"][:depth + 1]

    def nested(level):
        with profiling.span(names[level]):
            if level == depth:
                raise ValueError("stage failed")
            nested(level + 1)

    with pytest.raises(ValueError):
        nested(0)
    (record,) = ring
    assert record.failed and record.name == "root" and set(record.stages) == set(names[1:])
    with profiling.span("after") as after:  # nothing is left open
        pass
    assert after.parent is None and not ring[-1].failed


def test_counters_add_to_the_open_request(ring):
    profiling.add(px_run=5)  # outside a span: nothing
    with profiling.span("outer"):
        profiling.add(px_run=3, tiles=1)
        with profiling.span("inner"):
            profiling.add(px_run=4, px_useful=2)
        with pytest.raises(AttributeError):
            profiling.add(no_such_counter=1)
    (record,) = ring
    assert (record.px_run, record.px_useful, record.tiles, record.tiled) == (7, 2, 1, 1)
    assert set(record.stages) == {"inner"}


@pytest.mark.parametrize("shape", [(1, 8, 12, 3), (3, 16, 8, 3)], ids=["one", "three"])
def test_the_generators_call_counts_its_input_pixels(pipelines, ring, shape):
    pipe = pipelines[GEOMETRIES[1]]
    batch = torch.zeros(shape)
    pipe.apply(batch)  # no request open: no record, nothing counted
    no_grad_forward(pipe.model)(batch)
    assert len(ring) == 0
    with profiling.span("r"):
        pipe.apply(batch)
        no_grad_forward(pipe.model)(batch)
    (record,) = ring
    n, h, w, _ = shape
    assert record.px_run == 2 * n * h * w and record.px_useful == 0


def test_each_thread_opens_its_own_request(ring):
    seen = []

    def work():
        with profiling.span("thread") as s:
            seen.append(s.parent)

    with profiling.span("main"):
        worker = threading.Thread(target=work)
        worker.start()
        worker.join(timeout=30)
    assert not worker.is_alive() and seen == [None]
    assert sorted(r.name for r in ring) == ["main", "thread"]
    assert all(r.stages == {} for r in ring)


def test_the_ring_is_bounded(ring):
    for _ in range(profiling.RING_SIZE + 3):
        with profiling.span("r"):
            pass
    records = profiling.requests()
    assert len(records) == profiling.RING_SIZE == ring.maxlen
    assert records[-1].id - records[0].id == profiling.RING_SIZE - 1


def _image(h, w, seed=0):
    return np.random.default_rng(seed).random((h, w, 3)).astype(np.float32)


# (geometry, shape, tiled): each geometry serves one image whole and one in tiles
CASES = [(0, (50, 70), False), (0, (130, 140), True), (1, (20, 33), False),
         (1, (70, 90), True)]


@pytest.mark.parametrize("geometry,shape,tiled", CASES,
                         ids=["bucket32", "tiles64", "bucket8", "tiles40"])
def test_upscale_leaves_one_record(pipelines, ring, geometry, shape, tiled):
    g = dict(GEOMETRIES[geometry])
    pipe = pipelines[GEOMETRIES[geometry]]
    h, w = shape
    out = pipe.upscale(_image(h, w))
    assert out.shape == (4 * h, 4 * w, 3)
    (record,) = ring
    assert record.name == "serve.upscale" and not record.failed and not record.profiled
    assert record.tiled == int(tiled) and record.px_useful == h * w
    children = TILED if tiled else UNTILED
    assert set(record.stages) == set(children + (TILED_AROUND if tiled else ()))
    assert sum(record.stages[name] for name in children) <= record.duration_ns
    if tiled:
        assert record.stages["tiling.canvas"] <= record.stages["tiling.upscale"]
        ny, nx, _ = tile_grid(h, w, g["tile"], g["tile_overlap"])
        assert record.tiles == ny * nx
        assert record.px_run == ny * nx * g["tile"] ** 2
    else:
        b = g["bucket"]
        assert record.px_run == math.ceil(h / b) * b * math.ceil(w / b) * b
        assert record.tiles == 0


@pytest.mark.parametrize("entry", ["tiled_upscale", "tiled_canvas"])
def test_a_direct_tiling_call_opens_its_own_root(ring, entry):
    image = _image(70, 90)
    ny, nx, _ = tile_grid(70, 90, 40, 4)
    identity = no_grad_forward(torch.nn.Identity())  # counts the tiles' pixels
    if entry == "tiled_upscale":
        tiled_upscale(identity, image, scale=1, tile=40, overlap=4, tile_batch=4)
        stages = TILED + ("tiling.canvas",)
    else:
        padded = torch.from_numpy(np.ascontiguousarray(pad_for_tiles(image, 40, 4)))
        tiled_canvas(identity, padded, ny, nx, 40, 4, 4, scale=1)
        stages = ("tiling.batch", "tiling.stitch")
    (record,) = ring
    assert record.name == entry.replace("tiled_", "tiling.")
    assert set(record.stages) == set(stages)
    assert (record.tiles, record.px_run) == (9, 9 * 40 * 40)
    assert record.px_useful == (70 * 90 if entry == "tiled_upscale" else 0)


def test_no_profiler_no_record_function(pipelines, ring, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    pipe = pipelines[GEOMETRIES[1]]
    pipe.upscale(_image(20, 33))
    pipe.upscale(_image(70, 90))
    assert [r.failed for r in ring] == [False, False]


def test_under_the_profiler_spans_are_annotations_and_the_record_is_flagged(pipelines, ring):
    pipe = pipelines[GEOMETRIES[1]]
    pipe.upscale(_image(20, 33))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.upscale(_image(20, 33))
        pipe.upscale(_image(70, 90))
    pipe.upscale(_image(20, 33))
    annotations = {e.name for e in prof.events() if e.is_user_annotation}
    assert {"serve.upscale", *UNTILED, *TILED, *TILED_AROUND} <= annotations
    assert [r.profiled for r in ring] == [False, True, True, False]
