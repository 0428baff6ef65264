"""Port serving surface against the JAX package on the CPU: SRPipeline
(bucketed and tiled), tiled_upscale, the inference CLI, and the PNG codec.

f32, one RRDB, the geometry of tests/test_serve.py; the port's weights are
the JAX pipeline's random init carried across.  Bound 1e-4 on [0, 1] outputs;
the CLIs write 8-bit PNGs, which may differ by 1 level where f32 round-off
crosses a quantisation step.
"""

import os
import struct
import subprocess
import sys
import zlib

import cv2
import jax
import numpy as np
import pytest
import torch

from real_esrgan_tpu.parallel.tiling import tiled_upscale as jax_tiled_upscale
from real_esrgan_tpu.serve import SRPipeline as JaxSRPipeline
from real_esrgan_tpu_torch.inference import build_parser, main
from real_esrgan_tpu_torch.models.convert import state_dict_from_jax_params
from real_esrgan_tpu_torch.parallel.tiling import tiled_upscale
from real_esrgan_tpu_torch.serve import SRPipeline
from real_esrgan_tpu_torch.utils.imgio import read_png, write_png

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREE = os.path.join(ROOT, "tests", "data", "tree_lr.png")
WEIGHTS = os.path.join(ROOT, "assets", "inenv10_esrnet_ema.npz")
GEOMETRY = dict(num_rrdb=1, bfloat16=False, tile_threshold=128, tile=64,
                tile_overlap=8, tile_batch=8)


@pytest.fixture(scope="module")
def pipelines():
    jax_pipe = JaxSRPipeline(weights_path="", **GEOMETRY)
    port = SRPipeline(weights_path="", device="cpu", **GEOMETRY)
    port.model.load_state_dict(state_dict_from_jax_params(jax.device_get(jax_pipe.params)))
    return jax_pipe, port


@pytest.mark.parametrize("shape", [(50, 70), (64, 64), (130, 140)],
                         ids=["bucketed", "bucket_aligned", "tiled"])
def test_pipeline_matches_jax(pipelines, shape):
    jax_pipe, port = pipelines
    img = np.random.default_rng(sum(shape)).random((*shape, 3)).astype(np.float32)
    out = port.upscale(img)
    assert out.shape == (4 * shape[0], 4 * shape[1], 3)
    np.testing.assert_allclose(out, jax_pipe.upscale(img), atol=1e-4, rtol=0)


def test_tiled_upscale_matches_jax_with_a_partial_last_batch(pipelines):
    jax_pipe, port = pipelines
    img = np.random.default_rng(7).random((70, 90, 3)).astype(np.float32)
    geometry = dict(scale=4, tile=40, overlap=4, tile_batch=3)  # 3x3 tiles: 3 batches
    out = tiled_upscale(port.apply, img, device="cpu", **geometry)
    ref = jax_tiled_upscale(jax_pipe._apply, jax_pipe.params, img, **geometry)
    assert out.shape == (280, 360, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_batch_api(pipelines):
    _, port = pipelines
    rng = np.random.default_rng(5)
    outs = port.upscale_batch([rng.random((20, 30, 3)).astype(np.float32),
                               rng.random((33, 20, 3)).astype(np.float32)])
    assert [o.shape for o in outs] == [(80, 120, 3), (132, 80, 3)]


def test_cli_cpu_matches_jax_cli(tmp_path):
    src = str(tmp_path / "lr.png")
    write_png(src, read_png(TREE)[100:124, 200:232])
    common = ["--inputs_path", src, "--weights_path", WEIGHTS, "--cpu"]
    jax_out, port_out = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    subprocess.run([sys.executable, "inference.py", *common, "--output_path", jax_out],
                   cwd=ROOT, check=True, capture_output=True, timeout=300)
    run = subprocess.run([sys.executable, "-m", "real_esrgan_tpu_torch.inference", *common,
                          "--output_path", port_out],
                         cwd=ROOT, check=True, capture_output=True, text=True, timeout=300)
    assert "on cpu" in run.stdout
    a = cv2.cvtColor(cv2.imread(jax_out), cv2.COLOR_BGR2RGB).astype(int)
    b = read_png(port_out).astype(int)
    assert a.shape == b.shape == (96, 128, 3)
    assert np.abs(a - b).max() <= 1


def test_cli_without_cpu_flag_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the CLI runs there")
    args = build_parser().parse_args(["--inputs_path", TREE, "--weights_path", "",
                                      "--output_path", str(tmp_path / "o.png")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SRPipeline(num_rrdb=1)


def test_read_png_matches_cv2_and_write_png_roundtrips(tmp_path):
    ref = cv2.cvtColor(cv2.imread(TREE), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(read_png(TREE), ref)
    img = np.random.default_rng(0).integers(0, 256, (17, 23, 3), dtype=np.uint8)
    path = str(tmp_path / "w.png")
    write_png(path, img)
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB), img)


def _encode_png(img: np.ndarray, ftype: int) -> bytes:
    """Independent PNG encoder that filters every scanline with ``ftype``."""
    h, w, _ = img.shape
    rows = img.reshape(h, w * 3).astype(np.int64)
    prev = np.zeros(w * 3, np.int64)
    raw = bytearray()
    for cur in rows:
        a = np.concatenate([np.zeros(3, np.int64), cur[:-3]])
        c = np.concatenate([np.zeros(3, np.int64), prev[:-3]])
        b = prev
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = [np.zeros_like(cur), a, b, (a + b) // 2,
                np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))][ftype]
        raw.append(ftype)
        raw += ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
def test_read_png_undoes_every_filter_type(tmp_path, ftype):
    img = np.random.default_rng(ftype).integers(0, 256, (9, 11, 3), dtype=np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_encode_png(img, ftype))
    np.testing.assert_array_equal(read_png(str(path)), img)
