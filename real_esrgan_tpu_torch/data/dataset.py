"""Host-side datasets and a threaded batch loader: the port of
real_esrgan_tpu/data/dataset.py.

* ``TrainImageDataset`` yields uint8 HR crops of ``hr_size``: the
  degradation runs on the device, so the host only decodes and crops.
* ``ValidImageDataset`` centre-crops and makes the MATLAB-bicubic LR pair.
* ``TestImageDataset`` pairs an LR and an HR directory.
* ``ThreadedLoader`` shuffles, decodes in threads and yields
  (batch, hr_size, hr_size, 3) uint8 arrays, dropping the ragged tail.

Images are PNGs decoded by ``utils/imgio.read_png``, which gives the pixels
``cv2.imread`` gives; a file of any other format raises.  The shuffle is
``default_rng(seed + epoch)`` and each crop's RNG ``default_rng((seed,
epoch, index))``, the JAX loader's, so the batches are its batches byte for
byte.  As in the JAX loader, ``ThreadedLoader.epoch`` counts the loader's own
passes from 0, and a resumed run does not set it.  ``TrainImageDataset``
keeps decoded images in RAM up to ``cache_bytes`` (first fit, no eviction),
so an epoch after the first decodes only what did not fit.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from real_esrgan_tpu_torch.ops.resize import matlab_resize
from real_esrgan_tpu_torch.utils.imgio import read_png

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp", ".tif", ".tiff", ".ppm", ".gif")


def _list_images(directory: str) -> List[str]:
    names = sorted(f for f in os.listdir(directory) if f.lower().endswith(_IMG_EXTS))
    if not names:
        raise FileNotFoundError(f"No images found in {directory}")
    return [os.path.join(directory, f) for f in names]


def _read_rgb(path: str) -> np.ndarray:
    if not path.lower().endswith(".png"):
        raise ValueError(f"{path}: the port's datasets read PNG files only")
    return read_png(path)


class TrainImageDataset:
    """Yields uint8 RGB HR crops of exactly ``hr_size``; an image smaller
    than that is reflect-101 padded up to it (bottom and right).

    ``cache_bytes`` > 0 keeps decoded (padded, uncropped) images in RAM:
    first fit with no eviction, so a dataset over its budget caches its head
    and decodes its tail.  Crops stay random per call."""

    def __init__(self, image_dir: str, hr_size: int, cache_bytes: int = 0):
        self.files = _list_images(image_dir)
        self.hr_size = hr_size
        self._cache: Dict[int, np.ndarray] = {}
        self._cache_left = cache_bytes
        self._cache_lock = threading.Lock()

    def __len__(self):
        return len(self.files)

    def cache_stats(self) -> Tuple[int, int]:
        """(entries, bytes) of the decode cache."""
        with self._cache_lock:
            return len(self._cache), sum(img.nbytes for img in self._cache.values())

    def _decode(self, index: int) -> np.ndarray:
        cached = self._cache.get(index)
        if cached is not None:
            return cached
        img = _read_rgb(self.files[index])
        h, w = img.shape[:2]
        s = self.hr_size
        if h < s or w < s:
            img = np.pad(img, ((0, max(0, s - h)), (0, max(0, s - w)), (0, 0)), mode="reflect")
        with self._cache_lock:  # loader threads decode at once
            if index not in self._cache and img.nbytes <= self._cache_left:
                self._cache_left -= img.nbytes
                self._cache[index] = img
        return img

    def load(self, index: int, rng: np.random.Generator) -> np.ndarray:
        img = self._decode(index)
        h, w = img.shape[:2]
        s = self.hr_size
        top = int(rng.integers(0, h - s + 1))
        left = int(rng.integers(0, w - s + 1))
        return img[top:top + s, left:left + s]


class ValidImageDataset:
    """Centre-crop HR + MATLAB-bicubic LR pairs, float32 in [0, 1]."""

    def __init__(self, image_dir: str, crop_size: int, scale: int):
        self.files = _list_images(image_dir)
        self.crop_size = crop_size
        self.scale = scale

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        img = _read_rgb(self.files[index]).astype(np.float32) / 255.0
        h, w = img.shape[:2]
        s = min(self.crop_size, (min(h, w) // self.scale) * self.scale)
        top, left = (h - s) // 2, (w - s) // 2
        hr = img[top:top + s, left:left + s]
        lr = matlab_resize(torch.from_numpy(np.ascontiguousarray(hr)), 1.0 / self.scale).numpy()
        return {"lr": lr, "hr": hr}


class TestImageDataset:
    """Paired LR/HR directory reader (same file names), float32 in [0, 1]."""

    def __init__(self, lr_dir: str, hr_dir: str):
        self.lr_files = _list_images(lr_dir)
        self.hr_files = [os.path.join(hr_dir, os.path.basename(f)) for f in self.lr_files]

    def __len__(self):
        return len(self.lr_files)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        def read(path):
            return _read_rgb(path).astype(np.float32) / 255.0

        return {"lr": read(self.lr_files[index]), "hr": read(self.hr_files[index])}


def build_eval_datasets(valid_dir: str, test_lr_dir: str, test_hr_dir: str, crop_size: int,
                        scale: int):
    """Per-epoch evaluation datasets; a missing directory gives an empty one
    and a printed warning, so the run goes on without that evaluation."""
    if os.path.isdir(valid_dir):
        valid_ds = ValidImageDataset(valid_dir, crop_size, scale)
    else:
        valid_ds = []
        print(f"Validation dir `{valid_dir}` not found - skipping the "
              f"per-epoch valid NIQE eval.")
    if os.path.isdir(test_lr_dir) and os.path.isdir(test_hr_dir):
        test_ds = TestImageDataset(test_lr_dir, test_hr_dir)
    else:
        test_ds = []
        print(f"Test pair dirs `{test_lr_dir}` / `{test_hr_dir}` not found - "
              f"skipping the per-epoch test NIQE eval.")
    return valid_ds, test_ds


class ThreadedLoader:
    """Shuffling, batching loader with decode worker threads.

    ``shard_id``/``num_shards``: every shard draws the same shuffle and takes
    a disjoint, equal-length stride of it."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 4, seed: int = 0,
                 prefetch: int = 4, shard_id: int = 0, num_shards: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self.shard_id = shard_id
        self.num_shards = max(1, num_shards)
        self.epoch = 0

    def __len__(self):
        return (len(self.dataset) // self.num_shards) // self.batch_size

    def __iter__(self) -> Iterator[np.ndarray]:
        n = len(self.dataset)
        epoch = self.epoch
        order = np.random.default_rng(self.seed + epoch).permutation(n)
        self.epoch += 1
        usable = ((n // self.num_shards) // self.batch_size) * self.batch_size
        order = order[self.shard_id::self.num_shards][:usable]

        index_q: "queue.Queue" = queue.Queue()
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch * self.batch_size)
        for pos, idx in enumerate(order):
            index_q.put((pos, int(idx)))
        for _ in range(self.num_workers):
            index_q.put(None)

        def worker():
            while True:
                item = index_q.get()
                if item is None:
                    out_q.put(None)
                    return
                pos, idx = item
                # the crop RNG is keyed by (seed, epoch, sample index), so a
                # batch does not depend on the threads' schedule
                rng = np.random.default_rng((self.seed, epoch, idx))
                try:
                    out_q.put((pos, self.dataset.load(idx, rng)))
                except Exception as exc:  # raised in the consumer
                    out_q.put(exc)

        for _ in range(self.num_workers):
            threading.Thread(target=worker, daemon=True).start()

        # reassembled in shuffled order, not in completion order
        finished, next_pos = 0, 0
        pending: Dict[int, np.ndarray] = {}
        batch: List[np.ndarray] = []
        while finished < self.num_workers and next_pos < usable:
            item = out_q.get()
            if item is None:
                finished += 1
                continue
            if isinstance(item, Exception):
                raise item
            pos, arr = item
            pending[pos] = arr
            while next_pos in pending:
                batch.append(pending.pop(next_pos))
                next_pos += 1
                if len(batch) == self.batch_size:
                    yield np.stack(batch)
                    batch = []
