"""HTTP serving front end for the SR pipeline: the port of
``scripts/serve_http.py``, over the port's ``serve.SRPipeline`` (bucketed
shapes for small inputs, overlap tiles over every local GPU for large ones).

    python -m real_esrgan_tpu_torch.scripts.serve_http \\
        --weights assets/inenv10_esrnet_ema.npz --port 8080        # on the GPUs
    python -m real_esrgan_tpu_torch.scripts.serve_http --cpu --no-bfloat16 ...
    python -m real_esrgan_tpu_torch.scripts.serve_http --arch swinir_l \\
        --weights 003_realSR_BSRGAN_DFOWMFC_s64w8_SwinIR-L_x4_GAN.pth       # SwinIR-L
    curl -s -X POST --data-binary @lr.png localhost:8080/upscale > sr.png
    curl -s localhost:8080/healthz

Endpoints:
  POST /upscale   image bytes (png/jpeg) in, ``x4`` PNG out
  GET  /healthz   JSON liveness + device type + served-request counter
  GET  /stats     JSON latency stats (count/mean/p50/p95, seconds) and each
                  stage's p50/p95 (``stages``)

Inference is serialised behind a lock (one forward at a time keeps device
memory bounded); decoding and encoding run in the handler threads.  The
forward runs under ``torch.no_grad`` in the handler's thread (grad mode is
a thread's own), so the RDB kernel, which has no backward, serves it.

Each request is a root span ``http.request`` (``utils/profiling.py``) with
the children ``http.decode``, ``http.lock_wait`` (the queue behind the
lock), ``SRPipeline.upscale``'s spans and ``http.encode``, its record
owned by the app.  ``/stats`` reads the app's own records among those that
the process's ring of requests holds (the last 4,096): the latency is
``http.lock_wait`` plus ``serve.upscale``, which ends in a copy to the host
and so waits for the device.  ``--warmup-size`` runs one forward at
start-up, so the kernels are built before the first request arrives.  PNG
bodies are decoded and encoded by ``utils/imgio.py`` (zlib and numpy); other
formats need PIL.
"""

from __future__ import annotations

import argparse
import io
import json
import math
import statistics
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from real_esrgan_tpu_torch.serve import ARCHS, SRPipeline
from real_esrgan_tpu_torch.utils import profiling
from real_esrgan_tpu_torch.utils.imgio import decode_png, encode_png


def build_app(weights: str = "", upscale_factor: int = 4, num_rrdb: int = 23,
              bfloat16: bool = True, warmup_size: int = 0, device=None, arch: str = "rrdbnet"):
    """Returns a BaseHTTPRequestHandler class bound to one loaded pipeline of
    the network ``arch``, on ``device`` (``"cpu"``), or by default on every
    local GPU."""
    pipeline = SRPipeline(weights_path=weights, upscale_factor=upscale_factor,
                          num_rrdb=num_rrdb, bfloat16=bfloat16, device=device, arch=arch)
    lock = threading.Lock()
    served = [0]
    app = object()  # owns this app's records in the process's ring of requests

    if warmup_size:
        with torch.no_grad():
            pipeline.upscale(np.zeros((warmup_size, warmup_size, 3), np.float32))

    class Handler(BaseHTTPRequestHandler):
        pipeline_ref = pipeline  # test hook

        def log_message(self, fmt, *args):  # quiet: stats live in /stats
            pass

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok", "device": pipeline.device.type,
                                 "served": served[0]})
            elif self.path == "/stats":
                self._json(200, request_stats(profiling.requests(), app))
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/upscale":
                self._json(404, {"error": "unknown path"})
                return
            with profiling.span("http.request") as root:
                root.record.owner = app
                self._upscale(root.record)

        def _upscale(self, record: profiling.Record) -> None:
            try:
                with profiling.span("http.decode"):
                    size = int(self.headers.get("Content-Length", 0))
                    lr = decode_image(self.rfile.read(size)).astype(np.float32) / 255.0
            except Exception as exc:
                self._json(400, {"error": f"bad image: {exc}"})
                return
            try:
                with profiling.span("http.lock_wait"):
                    lock.acquire()
                try:
                    with torch.no_grad():
                        sr = pipeline.upscale(lr)
                    served[0] += 1
                finally:
                    lock.release()
            except Exception as exc:
                # an HTTP 500 beats a dropped connection (a degenerate-but-
                # decodable input, or device OOM on a huge upload, lands here)
                record.failed = True
                self._json(500, {"error": f"upscale failed: {exc}"})
                return
            with profiling.span("http.encode"):
                body = encode_png(quantize(sr))
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Latency-Seconds", f"{latency_s(record):.4f}")
            self.end_headers()
            self.wfile.write(body)

    return Handler


def latency_s(record: profiling.Record) -> float:
    """A request's latency: the wait for the lock and ``SRPipeline.upscale``."""
    return (record.stages.get("http.lock_wait", 0) + record.stages.get("serve.upscale", 0)) / 1e9


def request_stats(records, owner) -> dict:
    """``/stats`` over the requests among ``records`` that the app ``owner``
    upscaled: ``latency_stats`` of their latencies, and ``stages``, the
    nearest-rank p50 and p95 seconds of each span name (the root
    ``http.request`` and its children)."""
    served = [r for r in records if r.owner is owner and r.name == "http.request"
              and not r.failed and "serve.upscale" in r.stages]
    stats = latency_stats([latency_s(r) for r in served])
    by_name: dict = {}
    for r in served:
        by_name.setdefault(r.name, []).append(r.duration_ns / 1e9)
        for name, ns in r.stages.items():
            by_name.setdefault(name, []).append(ns / 1e9)
    stats["stages"] = {name: {k: v for k, v in latency_stats(times).items()
                              if k in ("p50_s", "p95_s")}
                       for name, times in sorted(by_name.items())}
    return stats


def latency_stats(latencies) -> dict:
    """``/stats``: the count, the mean and the nearest-rank p50 and p95 (the
    ``ceil(q * n)``-th smallest), in seconds.  (The JAX server takes
    ``int(0.95 * n) - 1`` for p95, one rank low wherever ``0.95 * n`` is not
    whole: with two requests its p95 is the faster one.)"""
    lat = sorted(latencies)
    stats = {"count": len(lat)}
    if lat:
        rank = lambda q: lat[max(0, math.ceil(q * len(lat)) - 1)]  # noqa: E731
        stats.update(mean_s=round(statistics.fmean(lat), 4), p50_s=round(rank(0.5), 4),
                     p95_s=round(rank(0.95), 4))
    return stats


def decode_image(raw: bytes) -> np.ndarray:
    """Uploaded bytes -> (H, W, 3) uint8 RGB: a PNG by the port's own
    decoder, any other format by PIL where it is installed."""
    if raw.startswith(b"\x89PNG"):
        return decode_png(raw)
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))


def quantize(sr: np.ndarray) -> np.ndarray:
    """An SR image in [0, 1] as the uint8 the server's PNG holds."""
    return (np.clip(sr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--weights", default="")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--upscale-factor", type=int, default=4)
    p.add_argument("--num-rrdb", type=int, default=23)
    p.add_argument("--arch", choices=ARCHS, default="rrdbnet",
                   help="the network: Real-ESRGAN's RRDBNet, or SwinIR-L (x4)")
    p.add_argument("--no-bfloat16", action="store_true")
    p.add_argument("--warmup-size", type=int, default=256,
                   help="run one forward of this input size at start-up (0 = off)")
    p.add_argument("--cpu", action="store_true", help="serve on the CPU")
    a = p.parse_args(argv)

    handler = build_app(a.weights, a.upscale_factor, a.num_rrdb, not a.no_bfloat16,
                        a.warmup_size, device="cpu" if a.cpu else None, arch=a.arch)
    server = ThreadingHTTPServer((a.host, a.port), handler)
    print(f"serving x{a.upscale_factor} SR ({a.arch}) on http://{a.host}:{a.port} on "
          f"{handler.pipeline_ref.device} (weights: {a.weights or 'random init'})", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
