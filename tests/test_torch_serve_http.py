"""The port's HTTP front end against the JAX one (scripts/serve_http.py):
both load one .npz of a seeded 1-RRDB generator and serve in float32 on the
CPU.  The port's PNG is its own SRPipeline's output quantised the same way,
bit for bit, and within 1 level of 8 bits of the JAX server's PNG (at least
99.9% of values equal): the two frameworks sum in other orders, so a value
near a quantisation step may land on the other side.  Then the health and
stats endpoints (the stats read from the request spans) and the 400, 404
and 500 answers."""

import io
import json
import os
import socket
import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

from real_esrgan_tpu_torch.models import Generator
from real_esrgan_tpu_torch.scripts import serve_http
from real_esrgan_tpu_torch.train.checkpoint import save_params_npz
from real_esrgan_tpu_torch.utils import profiling
from real_esrgan_tpu_torch.utils.imgio import decode_png, encode_png

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))

import serve_http as jax_serve_http  # noqa: E402

torch.set_num_threads(2)


def _serve(handler):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server = ThreadingHTTPServer(("127.0.0.1", port), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{port}"


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    weights = str(tmp_path_factory.mktemp("weights") / "g1.npz")
    model = Generator(num_rrdb=1, generator=torch.Generator().manual_seed(7))
    save_params_npz(weights, model.state_dict(), dtype=np.float32)
    port_handler = serve_http.build_app(weights, num_rrdb=1, bfloat16=False, warmup_size=16,
                                        device="cpu")
    jax_handler = jax_serve_http.build_app(weights, num_rrdb=1, bfloat16=False, warmup_size=0)
    port_server, port_url = _serve(port_handler)
    jax_server, jax_url = _serve(jax_handler)
    yield {"port": port_url, "jax": jax_url, "handler": port_handler}
    port_server.shutdown()
    jax_server.shutdown()


def _post(url, data, path="/upscale"):
    req = urllib.request.Request(url + path, data=data, method="POST")
    return urllib.request.urlopen(req, timeout=300)


def _get(url, path):
    return json.loads(urllib.request.urlopen(url + path, timeout=30).read())


def _image(shape, seed) -> np.ndarray:
    return (np.random.default_rng(seed).random((*shape, 3)) * 255).astype(np.uint8)


@pytest.mark.parametrize("shape", [(24, 32), (40, 21)], ids=["24x32", "40x21"])
def test_png_matches_the_pipeline_and_the_jax_server(servers, shape):
    img = _image(shape, sum(shape))
    body = encode_png(img)
    resp = _post(servers["port"], body)
    assert resp.status == 200 and resp.headers["Content-Type"] == "image/png"
    assert float(resp.headers["X-Latency-Seconds"]) > 0
    ours = decode_png(resp.read())
    assert ours.shape == (4 * shape[0], 4 * shape[1], 3)

    pipeline = servers["handler"].pipeline_ref
    expected = serve_http.quantize(pipeline.upscale(img.astype(np.float32) / 255.0))
    np.testing.assert_array_equal(ours, expected)

    ref = np.asarray(Image.open(io.BytesIO(_post(servers["jax"], body).read())).convert("RGB"))
    diff = np.abs(ours.astype(np.int16) - ref)
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999


def test_a_jpeg_upload_decodes_as_the_jax_server_decodes_it(servers):
    buf = io.BytesIO()
    Image.fromarray(_image((16, 16), 3)).save(buf, format="JPEG", quality=90)
    ours = decode_png(_post(servers["port"], buf.getvalue()).read())
    ref = np.asarray(Image.open(io.BytesIO(_post(servers["jax"], buf.getvalue()).read())))
    assert ours.shape == ref.shape == (64, 64, 3)
    assert np.abs(ours.astype(np.int16) - ref).max() <= 1


def test_health_and_stats(servers):
    _post(servers["port"], encode_png(_image((8, 8), 1)))
    health = _get(servers["port"], "/healthz")
    assert health["status"] == "ok" and health["device"] == "cpu"
    stats = _get(servers["port"], "/stats")
    assert stats["count"] == health["served"] >= 1
    assert 0 < stats["p50_s"] <= stats["p95_s"]
    assert stats["mean_s"] > 0


def test_stats_give_each_stage_of_the_front_ends_requests(servers):
    _post(servers["port"], encode_png(_image((12, 10), 5)))
    stages = _get(servers["port"], "/stats")["stages"]
    assert {"http.request", "http.decode", "http.lock_wait", "serve.upscale", "serve.prepare",
            "serve.launch", "serve.wait", "serve.finish", "http.encode"} <= set(stages)
    assert all(0 <= s["p50_s"] <= s["p95_s"] for s in stages.values())
    assert stages["serve.upscale"]["p95_s"] <= stages["http.request"]["p95_s"]


APP = object()


def _record(name, upscale_ns, lock_ns=0, failed=False, owner=APP):
    stages = {"http.lock_wait": lock_ns, "http.decode": 5}
    if upscale_ns is not None:
        stages["serve.upscale"] = upscale_ns
    return profiling.Record(0, name, False, 0, 10 ** 10, failed, stages, owner=owner)


def test_stats_count_only_requests_the_front_end_upscaled():
    records = [_record("http.request", 3 * 10 ** 8, 10 ** 8),
               _record("http.request", 2 * 10 ** 8),
               _record("http.request", 10 ** 9, failed=True),   # a 500
               _record("http.request", None),                   # a 400
               _record("http.request", 10 ** 9, owner=object()),  # another app's
               _record("serve.upscale", 10 ** 9, owner=None)]   # outside the front end
    stats = serve_http.request_stats(records, APP)
    assert (stats["count"], stats["p50_s"], stats["p95_s"], stats["mean_s"]) == (2, 0.2, 0.4, 0.3)
    assert stats["stages"]["serve.upscale"] == {"p50_s": 0.2, "p95_s": 0.3}
    assert stats["stages"]["http.request"] == {"p50_s": 10.0, "p95_s": 10.0}
    assert serve_http.request_stats([], APP) == {"count": 0, "stages": {}}


def test_stats_leave_out_requests_of_the_rest_of_the_process(servers):
    """Records that another front end in the process, or a bare pipeline,
    left in the shared ring do not count in this app's ``/stats``."""
    _post(servers["port"], encode_png(_image((8, 8), 2)))
    with profiling.span("http.request"):  # another app's request, in this process
        with profiling.span("serve.upscale"):
            pass
    servers["handler"].pipeline_ref.upscale(np.zeros((8, 8, 3), np.float32))
    stats = _get(servers["port"], "/stats")
    assert stats["count"] == _get(servers["port"], "/healthz")["served"] >= 1


@pytest.mark.parametrize("latencies,p50,p95", [([0.3, 0.1], 0.1, 0.3), ([0.2], 0.2, 0.2),
                                               (list(range(100, 0, -1)), 50, 95),
                                               (list(range(1, 21)), 10, 19)],
                         ids=["two", "one", "hundred", "twenty"])
def test_stats_are_nearest_rank_percentiles(latencies, p50, p95):
    stats = serve_http.latency_stats(latencies)
    assert (stats["count"], stats["p50_s"], stats["p95_s"]) == (len(latencies), p50, p95)
    assert serve_http.latency_stats([]) == {"count": 0}


def test_bad_image_is_400(servers):
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(servers["port"], b"this is not an image")
    assert err.value.code == 400


@pytest.mark.parametrize("method", ["GET", "POST"])
def test_unknown_path_is_404(servers, method):
    with pytest.raises(urllib.error.HTTPError) as err:
        if method == "POST":
            _post(servers["port"], b"x", path="/nope")
        else:
            urllib.request.urlopen(servers["port"] + "/nope", timeout=30)
    assert err.value.code == 404


def test_a_failed_upscale_is_500(servers, monkeypatch):
    def boom(image):
        raise RuntimeError("out of memory")

    monkeypatch.setattr(servers["handler"].pipeline_ref, "upscale", boom)
    served = _get(servers["port"], "/healthz")["served"]
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(servers["port"], encode_png(_image((8, 8), 2)))
    assert err.value.code == 500
    assert "out of memory" in json.loads(err.value.read())["error"]
    assert _get(servers["port"], "/healthz")["served"] == served


def test_the_forward_runs_without_autograd_in_the_handler_thread(servers, monkeypatch):
    pipeline = servers["handler"].pipeline_ref
    modes = []
    real = pipeline.upscale

    def recording(image):
        modes.append(torch.is_grad_enabled())
        return real(image)

    monkeypatch.setattr(pipeline, "upscale", recording)
    torch.set_grad_enabled(True)
    _post(servers["port"], encode_png(_image((8, 8), 4)))
    assert modes == [False]
