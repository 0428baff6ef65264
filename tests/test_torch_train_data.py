"""The port's training data path against the JAX package's on the CPU: the
``ThreadedLoader`` yields the JAX loader's batches, equal in every byte, over
two epochs, from the same PNG directory (images larger than the crop, and
smaller ones that both reflect-pad); the evaluation datasets give the same
arrays; the prefetcher hands the batches over unchanged.
"""

import numpy as np
import pytest
import torch

from real_esrgan_tpu.data import dataset as jax_dataset
from real_esrgan_tpu_torch.data import dataset
from real_esrgan_tpu_torch.data.prefetcher import DevicePrefetcher
from real_esrgan_tpu_torch.utils.imgio import write_png

HR_SIZE = 48


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("train")
    rng = np.random.default_rng(3)
    shapes = [(64, 80), (48, 48), (50, 97), (40, 60), (30, 30), (72, 64), (48, 52), (99, 50),
              (64, 64), (56, 70), (45, 90)]
    for i, (h, w) in enumerate(shapes):
        write_png(str(d / f"im{i:02d}.png"), (rng.random((h, w, 3)) * 255).astype(np.uint8))
    return d


@pytest.mark.parametrize("workers", [1, 3])
def test_threaded_loader_yields_the_jax_loaders_batches(png_dir, workers):
    ours = dataset.ThreadedLoader(dataset.TrainImageDataset(str(png_dir), HR_SIZE), 4,
                                  num_workers=workers, seed=5)
    ref = jax_dataset.ThreadedLoader(jax_dataset.TrainImageDataset(str(png_dir), HR_SIZE), 4,
                                     num_workers=2, seed=5)
    assert len(ours) == len(ref) == 2
    for epoch in range(2):
        a, b = list(ours), list(ref)
        assert len(a) == len(b) == 2
        for x, y in zip(a, b):
            assert x.dtype == np.uint8 and x.shape == (4, HR_SIZE, HR_SIZE, 3)
            assert np.array_equal(x, y), epoch
    assert ours.epoch == ref.epoch == 2


def test_epochs_differ_and_a_new_loader_starts_at_epoch_zero(png_dir):
    """The JAX loader's resume behaviour, kept: ``epoch`` counts this
    loader's own passes, so a fresh loader replays epoch 0's shuffle."""
    ds = dataset.TrainImageDataset(str(png_dir), HR_SIZE)
    first = dataset.ThreadedLoader(ds, 4, num_workers=2, seed=5)
    e0, e1 = list(first), list(first)
    assert not np.array_equal(e0[0], e1[0])
    again = list(dataset.ThreadedLoader(ds, 4, num_workers=2, seed=5))
    assert all(np.array_equal(x, y) for x, y in zip(e0, again))


def test_sharded_loader_matches_jax(png_dir):
    for shard in (0, 1):
        ours = dataset.ThreadedLoader(dataset.TrainImageDataset(str(png_dir), HR_SIZE), 2,
                                      seed=1, shard_id=shard, num_shards=2)
        ref = jax_dataset.ThreadedLoader(jax_dataset.TrainImageDataset(str(png_dir), HR_SIZE),
                                         2, seed=1, shard_id=shard, num_shards=2)
        assert all(np.array_equal(x, y) for x, y in zip(list(ours), list(ref)))


def test_eval_datasets_match_jax(png_dir, tmp_path):
    ours = dataset.ValidImageDataset(str(png_dir), 32, 4)
    ref = jax_dataset.ValidImageDataset(str(png_dir), 32, 4)
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert np.array_equal(a["hr"], b["hr"])
        np.testing.assert_allclose(a["lr"], b["lr"], atol=1e-6)
    pairs = dataset.TestImageDataset(str(png_dir), str(png_dir))
    ref_pairs = jax_dataset.TestImageDataset(str(png_dir), str(png_dir))
    for key in ("lr", "hr"):
        assert np.array_equal(pairs[0][key], ref_pairs[0][key])
    valid, test = dataset.build_eval_datasets(str(tmp_path / "none"), str(png_dir),
                                              str(tmp_path / "none"), 32, 4)
    assert valid == [] and test == []


def test_only_png_files_are_read(tmp_path):
    (tmp_path / "a.jpg").write_bytes(b"not read")
    with pytest.raises(ValueError, match="PNG"):
        dataset.TrainImageDataset(str(tmp_path), HR_SIZE).load(0, np.random.default_rng(0))
    with pytest.raises(FileNotFoundError):
        dataset.TrainImageDataset(str(tmp_path / "empty_missing"), HR_SIZE)


def test_prefetcher_hands_the_batches_over(png_dir):
    loader = dataset.ThreadedLoader(dataset.TrainImageDataset(str(png_dir), HR_SIZE), 4,
                                    num_workers=2, seed=5)
    batches = list(loader)
    loader.epoch = 0
    moved = list(DevicePrefetcher(loader, "cpu"))
    assert len(moved) == len(batches)
    for t, b in zip(moved, batches):
        assert isinstance(t, torch.Tensor) and t.dtype == torch.uint8
        assert np.array_equal(t.numpy(), b)
