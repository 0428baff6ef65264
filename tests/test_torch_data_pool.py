"""The device-resident pool against the JAX package's on the CPU:
``build_pool_array`` stacks the same bytes and refuses the same sets (over
budget, an image not ``hr_size``-square), ``DevicePoolLoader`` gathers the
JAX loader's batches byte for byte over two epochs and the threaded
loader's at crop = image size, and ``make_train_loader`` follows the JAX
trainer's chain (mirroring tests/test_device_pool.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from real_esrgan_tpu.data import DevicePoolLoader as JaxPoolLoader
from real_esrgan_tpu.data import build_pool_array as jax_build_pool_array
from real_esrgan_tpu.data import dataset as jax_dataset
from real_esrgan_tpu_torch import config as run_config
from real_esrgan_tpu_torch.configuration import PipelineGeometry
from real_esrgan_tpu_torch.data import dataset, grain_loader, native_loader
from real_esrgan_tpu_torch.data.device_pool import DevicePoolLoader, build_pool_array
from real_esrgan_tpu_torch.data.prefetcher import CPUPrefetcher, DevicePrefetcher
from real_esrgan_tpu_torch.train_realesrnet import SyntheticHRDataset, make_train_loader
from real_esrgan_tpu_torch.utils.imgio import write_png

HR = 48
GEO = PipelineGeometry(hr_size=HR, crop_size=32, scale=4)


@pytest.fixture(scope="module")
def square_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("square")
    rng = np.random.default_rng(4)
    for i in range(10):
        write_png(str(d / f"sq{i:02d}.png"), (rng.random((HR, HR, 3)) * 255).astype(np.uint8))
    return d


class _FixedDataset:
    def __init__(self, n, size=16, jitter=()):
        self.n, self.size, self.jitter = n, size, set(jitter)

    def __len__(self):
        return self.n

    def _decode(self, i):
        s = self.size + (4 if i in self.jitter else 0)
        return np.full((s, s, 3), i, np.uint8)


def test_pool_and_batches_equal_the_jax_pools(square_dir):
    ours_pool = build_pool_array(dataset.TrainImageDataset(str(square_dir), HR), HR, 1 << 30)
    ref_pool = jax_build_pool_array(jax_dataset.TrainImageDataset(str(square_dir), HR), HR,
                                    1 << 30)
    assert ours_pool.shape == (10, HR, HR, 3) and ours_pool.dtype == np.uint8
    assert np.array_equal(ours_pool, ref_pool)
    ours = DevicePoolLoader(ours_pool, 4, seed=3, device="cpu")
    ref = JaxPoolLoader(ref_pool, 4, seed=3)
    assert len(ours) == len(ref) == 2  # the ragged tail of 2 dropped
    for epoch in range(2):
        a, b = list(ours), [np.asarray(x) for x in ref]
        assert len(a) == 2
        for x, y in zip(a, b):
            assert isinstance(x, torch.Tensor) and x.dtype == torch.uint8
            assert np.array_equal(x.numpy(), y), epoch
    assert ours.epoch == 2
    assert ours.index_bytes == 2 * 2 * 4 * 8  # only int64 index vectors


def test_pool_equals_the_threaded_loader_at_crop_equal_to_the_image(square_dir):
    ds = dataset.TrainImageDataset(str(square_dir), HR)
    pool = DevicePoolLoader(build_pool_array(ds, HR, 1 << 30), 4, seed=8, device="cpu")
    threads = dataset.ThreadedLoader(ds, 4, num_workers=2, seed=8)
    for _ in range(2):
        for x, y in zip(pool, threads):
            assert np.array_equal(x.numpy(), y)


def test_the_pool_refuses_over_budget_and_ragged_sets():
    pool = build_pool_array(_FixedDataset(10), 16, budget_bytes=1 << 30)
    assert [int(pool[i, 0, 0, 0]) for i in range(10)] == list(range(10))
    assert build_pool_array(_FixedDataset(10), 16, budget_bytes=10 * 16 * 16 * 3 - 1) is None
    assert build_pool_array(_FixedDataset(10, jitter=(3,)), 16, budget_bytes=1 << 30) is None
    assert build_pool_array(_FixedDataset(0), 16, budget_bytes=1 << 30) is None
    # the JAX pool refuses the same sets
    assert jax_build_pool_array(_FixedDataset(10, jitter=(3,)), 16, 1 << 30) is None


def test_prefetchers_pass_pool_batches_through():
    pool = build_pool_array(_FixedDataset(8), 16, budget_bytes=1 << 30)
    loader = DevicePoolLoader(pool, 4, seed=0, device="cpu")
    gathered = list(loader)
    loader.epoch = 0
    pf = DevicePrefetcher(loader, "cpu")
    moved = list(pf)
    assert all(a is not None and torch.equal(a, b) for a, b in zip(moved, gathered))
    assert pf.h2d_bytes == 0
    loader.epoch = 0
    cpu = CPUPrefetcher(loader)
    assert len(cpu) == 2
    first = cpu.next()
    assert torch.equal(first, gathered[0]) and cpu.next() is not None and cpu.next() is None
    cpu.reset()
    assert cpu.next() is not None


def test_make_train_loader_follows_the_jax_chain(square_dir, tmp_path, capsys):
    cfg = run_config.train_esrnet
    synthetic = SyntheticHRDataset(HR, length=8)
    assert isinstance(make_train_loader(synthetic, 4, cfg, GEO, "cpu"), DevicePoolLoader)
    assert "device-resident pool" in capsys.readouterr().out

    files = dataset.TrainImageDataset(str(square_dir), HR)
    cfg0 = dataclasses.replace(cfg, device_pool_budget_bytes=0)
    host = make_train_loader(files, 4, cfg0, GEO, "cpu")
    want = native_loader.NativeThreadedLoader if native_loader.available() \
        else dataset.ThreadedLoader
    assert type(host) is want

    threads = make_train_loader(files, 4, dataclasses.replace(cfg, loader="threads"), GEO, "cpu")
    assert type(threads) is dataset.ThreadedLoader
    assert "Python threaded loader" in capsys.readouterr().out

    forced = make_train_loader(files, 4, dataclasses.replace(cfg0, loader="device"), GEO, "cpu")
    assert isinstance(forced, DevicePoolLoader)  # budget 0 under "device": no limit
    with pytest.raises(ValueError):
        make_train_loader(synthetic, 4, dataclasses.replace(cfg, loader="device",
                                                            device_pool_budget_bytes=64),
                          GEO, "cpu")
    ragged = tmp_path / "ragged"
    ragged.mkdir()
    write_png(str(ragged / "a.png"), np.zeros((HR + 4, HR, 3), np.uint8))
    write_png(str(ragged / "b.png"), np.zeros((HR, HR, 3), np.uint8))
    ragged_ds = dataset.TrainImageDataset(str(ragged), HR)
    with pytest.raises(ValueError):
        make_train_loader(ragged_ds, 1, dataclasses.replace(cfg, loader="device"), GEO, "cpu")
    assert not isinstance(make_train_loader(ragged_ds, 1, cfg, GEO, "cpu"), DevicePoolLoader)

    stream = make_train_loader(files, 4, dataclasses.replace(cfg, loader="grain",
                                                             num_workers=0), GEO, "cpu")
    assert isinstance(stream, grain_loader.GrainLoader)
    assert "grain-contract stream loader" in capsys.readouterr().out
    with pytest.raises(ValueError, match="unknown loader"):
        make_train_loader(files, 4, dataclasses.replace(cfg, loader="tfdata"), GEO, "cpu")


def test_auto_falls_back_to_threads_when_native_does_not_build(square_dir, monkeypatch,
                                                               capsys):
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_error", "png.h: No such file or directory")
    cfg = dataclasses.replace(run_config.train_esrnet, device_pool_budget_bytes=0)
    loader = make_train_loader(dataset.TrainImageDataset(str(square_dir), HR), 4, cfg, GEO,
                               "cpu")
    assert type(loader) is dataset.ThreadedLoader
    assert "Native loader unavailable (png.h: No such file" in capsys.readouterr().out
