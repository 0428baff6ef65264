"""Device-resident training pool: the port of real_esrgan_tpu/data/device_pool.py.

The host loaders (``ThreadedLoader``, ``NativeThreadedLoader``,
``GrainLoader``) decode a fresh uint8 batch every step and copy it to the
device.  A set of prepared crops never changes between epochs, and it is
small beside the card's memory: InEnv10 is 450 x 400x400x3 uint8 = 216 MB.
``DevicePoolLoader`` uploads the stacked set once, as one uint8 tensor on the
caller's device, and gathers each batch there with ``index_select``.  Per
step only the int64 index vector crosses to the device (8 bytes an image),
and the step path decodes nothing on the host.

The sampling is ``ThreadedLoader``'s: a permutation seeded by ``seed +
epoch``, the ragged tail dropped.  The pool is one deterministic decode, so
it takes only sets whose images are all ``hr_size``-square, where the host
loaders' random crop is the whole image and nothing is lost; the geometric
augmentation stays random, on the device, inside the degradation.

Data parallel (one rank a GPU): every rank holds the whole pool, as the JAX
loader replicates it over its mesh, draws the same global order and gathers
its own ``shard_slice`` of each global batch, so the ranks' batches together
are the one-GPU batch, and 8 bytes an image of the rank's share cross to
each card a step.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from real_esrgan_tpu_torch.parallel.mesh import shard_slice


def build_pool_array(dataset, hr_size: int, budget_bytes: int) -> Optional[np.ndarray]:
    """``dataset`` decoded into one (N, hr_size, hr_size, 3) uint8 stack, or
    None (the caller takes a host loader) when the stack would exceed
    ``budget_bytes`` or any image is not exactly ``hr_size``-square: a larger
    image means the host loader's per-epoch random crop matters, and a pool
    would freeze one crop of it."""
    n = len(dataset)
    if n == 0 or n * hr_size * hr_size * 3 > budget_bytes:
        return None
    rng = np.random.default_rng(0)
    decode = getattr(dataset, "_decode", None)
    images = []
    for i in range(n):
        img = decode(i) if decode is not None else dataset.load(i, rng)
        if img.shape != (hr_size, hr_size, 3) or img.dtype != np.uint8:
            return None
        images.append(img)
    return np.stack(images)


class DevicePoolLoader:
    """Epoch iterator over uint8 batches gathered on ``device`` from the pool
    uploaded there once: rank ``rank`` of ``world`` takes its (batch_size /
    world, hr, hr, 3) share of each global batch of ``batch_size``.

    ``index_bytes`` counts the bytes of the index vectors sent to the device,
    the only host-to-device traffic a step."""

    def __init__(self, pool: np.ndarray, batch_size: int, seed: int = 0, device="cuda",
                 rank: int = 0, world: int = 1):
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0
        self.device = torch.device(device)
        self.share = shard_slice(batch_size, rank, world)
        self._n = pool.shape[0]
        self.pool = torch.from_numpy(np.ascontiguousarray(pool)).to(self.device)
        self.index_bytes = 0

    def __len__(self):
        return self._n // self.batch_size

    def __iter__(self) -> Iterator[torch.Tensor]:
        order = np.random.default_rng(self.seed + self.epoch).permutation(self._n)
        self.epoch += 1
        for start in range(0, len(self) * self.batch_size, self.batch_size):
            batch = order[start:start + self.batch_size]
            idx = torch.from_numpy(batch[self.share].astype(np.int64))
            if self.device.type == "cuda":
                idx = idx.pin_memory()  # so the copy does not wait for the stream
            self.index_bytes += idx.nbytes
            yield self.pool.index_select(0, idx.to(self.device, non_blocking=True))
