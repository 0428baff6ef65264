"""The port's decode cache against the JAX package's on the CPU:
``TrainImageDataset(cache_bytes=...)`` keeps decoded images first fit with no
eviction, a dataset over its budget caches its head and decodes its tail,
crops stay random per call, and the cached ``ThreadedLoader`` yields the JAX
loader's batches byte for byte over two epochs.
"""

import numpy as np
import pytest

from real_esrgan_tpu.data import dataset as jax_dataset
from real_esrgan_tpu_torch.data import dataset
from real_esrgan_tpu_torch.utils.imgio import write_png

HR_SIZE = 48
SHAPES = [(64, 80), (48, 48), (50, 97), (40, 60), (30, 30), (72, 64), (48, 52), (96, 50),
          (64, 64)]


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cached")
    rng = np.random.default_rng(11)
    for i, (h, w) in enumerate(SHAPES):
        write_png(str(d / f"im{i:02d}.png"), (rng.random((h, w, 3)) * 255).astype(np.uint8))
    return d


def decoded_bytes(h, w):
    return max(h, HR_SIZE) * max(w, HR_SIZE) * 3  # small images are padded first


@pytest.mark.parametrize("budget", ["all", "head", "none"])
def test_cached_loader_yields_the_jax_loaders_batches(png_dir, budget):
    cache_bytes = {"all": 1 << 30, "head": decoded_bytes(*SHAPES[0]) + decoded_bytes(*SHAPES[1]),
                   "none": 0}[budget]
    ours_ds = dataset.TrainImageDataset(str(png_dir), HR_SIZE, cache_bytes=cache_bytes)
    ref_ds = jax_dataset.TrainImageDataset(str(png_dir), HR_SIZE, cache_bytes=cache_bytes)
    if budget == "head":  # fill the head first, in file order, in both
        for i in range(len(SHAPES)):
            ours_ds._decode(i), ref_ds._decode(i)
    ours = dataset.ThreadedLoader(ours_ds, 4, num_workers=3, seed=9)
    ref = jax_dataset.ThreadedLoader(ref_ds, 4, num_workers=2, seed=9)
    for epoch in range(2):
        a, b = list(ours), list(ref)
        assert len(a) == len(b) == 2
        for x, y in zip(a, b):
            assert x.dtype == np.uint8 and x.shape == (4, HR_SIZE, HR_SIZE, 3)
            assert np.array_equal(x, y), (budget, epoch)
    assert sorted(ours_ds._cache) == sorted(ref_ds._cache)
    entries, used = ours_ds.cache_stats()
    assert used == sum(img.nbytes for img in ref_ds._cache.values())
    assert entries == {"all": len(SHAPES), "head": 2, "none": 0}[budget]
    if budget == "head":
        assert sorted(ours_ds._cache) == [0, 1]


def test_a_cached_image_is_the_decoded_one_and_crops_stay_random(png_dir):
    cold = dataset.TrainImageDataset(str(png_dir), HR_SIZE)
    warm = dataset.TrainImageDataset(str(png_dir), HR_SIZE, cache_bytes=1 << 30)
    first = warm._decode(5)
    assert warm._decode(5) is first  # served from the cache
    assert np.array_equal(first, cold._decode(5))
    assert cold.cache_stats() == (0, 0)
    crops = {warm.load(5, np.random.default_rng(s)).tobytes() for s in range(6)}
    assert len(crops) > 1  # a 72 x 64 image has 25 x 17 offsets for a crop of 48


def test_first_fit_without_eviction(png_dir):
    """An image larger than the budget left is skipped, and a smaller one
    decoded later still fits: first fit, nothing evicted."""
    big, small = decoded_bytes(*SHAPES[2]), decoded_bytes(*SHAPES[4])
    ds = dataset.TrainImageDataset(str(png_dir), HR_SIZE, cache_bytes=small + big // 2)
    ds._decode(4)   # fits: small
    ds._decode(2)   # does not fit what is left
    ds._decode(1)   # 48 x 48 fits
    assert decoded_bytes(*SHAPES[1]) <= big // 2 < big
    assert sorted(ds._cache) == [1, 4]
    before = dict(ds._cache)
    for i in range(len(SHAPES)):
        ds._decode(i)
    assert all(ds._cache[k] is v for k, v in before.items())
