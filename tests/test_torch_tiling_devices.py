"""Tile batches spread over several devices (``parallel/tiling.py``,
``serve.SRPipeline(devices=...)``), on the CPU: two "devices" that are both
the CPU, each with its own replica of the network.

The output over N devices equals one device's bit for bit in float32 (a
tile's output does not depend on its batch neighbours); ``tile_batch`` is
rounded to a multiple of the device count as the JAX package rounds it to
its mesh; each batch is cut into equal chunks, one a device, the tail batch
as evenly as its tiles allow.
"""

import numpy as np
import pytest
import torch

from real_esrgan_tpu_torch.parallel.tiling import tiled_upscale
from real_esrgan_tpu_torch.serve import SRPipeline

SMALL = dict(num_rrdb=1, bfloat16=False, tile=48, tile_overlap=8, tile_batch=4,
             tile_threshold=40)


def _image(h, w, seed=0):
    return np.random.default_rng(seed).random((h, w, 3)).astype(np.float32)


def _recording(log, name, scale=4):
    """An apply function that records (name, batch size) and upscales by
    nearest neighbour plus the tile's own mean, so a wrong tile or a tile
    mixed with its neighbours shows in the output."""
    def fn(tiles):
        log.append((name, tiles.shape[0]))
        up = tiles.repeat_interleave(scale, 1).repeat_interleave(scale, 2)
        return up + tiles.mean(dim=(1, 2, 3), keepdim=True)
    return fn


@pytest.mark.parametrize("shape", [(80, 112), (100, 60), (200, 170)])
def test_two_devices_equal_one_bit_for_bit(shape):
    """SRPipeline's tiled requests, f32, one replica against two (3x4, 4x2
    and 7x6 tiles of core 32: an odd count in the first and last)."""
    image = _image(*shape, seed=sum(shape))
    one = SRPipeline(device="cpu", **SMALL)
    two = SRPipeline(devices=["cpu", "cpu"], **SMALL)
    assert len(two.models) == 2 and two.models[0] is not two.models[1]
    assert np.array_equal(one.upscale(image), two.upscale(image))


def test_each_device_runs_its_own_chunk_of_every_batch():
    log = []
    image = _image(80, 112)  # 3 x 4 = 12 tiles of core 32
    fns = [_recording(log, "a"), _recording(log, "b")]
    out = tiled_upscale(fns, image, tile=48, overlap=8, tile_batch=4, devices=["cpu", "cpu"])
    assert log == [("a", 2), ("b", 2)] * 3
    ref = tiled_upscale(_recording([], "one"), image, tile=48, overlap=8, tile_batch=4)
    assert np.array_equal(out, ref)


@pytest.mark.parametrize("n_dev, tile_batch, rounded", [(2, 5, 4), (3, 8, 6), (2, 1, 2),
                                                         (4, 4, 4)])
def test_tile_batch_rounds_to_the_device_count(n_dev, tile_batch, rounded):
    log = []
    image = _image(200, 170)  # 7 x 6 = 42 tiles
    fns = [_recording(log, i) for i in range(n_dev)]
    tiled_upscale(fns, image, tile=48, overlap=8, tile_batch=tile_batch,
                  devices=["cpu"] * n_dev)
    assert sum(n for _, n in log) == 42
    full = [n for _, n in log[:n_dev]]
    assert full == [rounded // n_dev] * n_dev


def test_an_odd_tail_batch_splits_as_evenly_as_it_can():
    log = []
    image = _image(80, 80)  # 3 x 3 = 9 tiles: batches of 4, 4 and 1
    fns = [_recording(log, "a"), _recording(log, "b")]
    out = tiled_upscale(fns, image, tile=48, overlap=8, tile_batch=4, devices=["cpu", "cpu"])
    assert log == [("a", 2), ("b", 2), ("a", 2), ("b", 2), ("a", 1)]
    ref = tiled_upscale(_recording([], "one"), image, tile=48, overlap=8, tile_batch=4)
    assert np.array_equal(out, ref)


def test_one_apply_function_serves_every_device():
    log = []
    image = _image(80, 112)
    fn = _recording(log, "shared")
    out = tiled_upscale(fn, image, tile=48, overlap=8, tile_batch=4, devices=["cpu", "cpu"])
    assert len(log) == 6
    assert np.array_equal(out, tiled_upscale(fn, image, tile=48, overlap=8, tile_batch=4))


def test_apply_functions_must_match_the_devices():
    with pytest.raises(ValueError, match="2 apply functions for 3 devices"):
        tiled_upscale([_recording([], 0), _recording([], 1)], _image(64, 64),
                      devices=["cpu"] * 3)


def test_device_still_means_one_device():
    pipe = SRPipeline(device="cpu", **SMALL)
    assert pipe.devices == [torch.device("cpu")] and pipe.device == torch.device("cpu")
    assert len(pipe.models) == 1 and pipe.model is pipe.models[0]
