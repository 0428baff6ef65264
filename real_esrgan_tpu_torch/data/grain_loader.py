"""A deterministic, resumable, sharded stream of HR crop batches: the port of
real_esrgan_tpu/data/grain_loader.py, keeping its names and its contract on
``torch.utils.data`` instead of ``grain``.

The JAX package builds this loader on Google's ``grain``, whose import
brings in ``jax``; the port imports no JAX, so it keeps grain's contract and
not grain:

* **One global stream.**  Pass p over the n records is a permutation seeded
  by (seed, p); each shard takes the stride ``shard_id::num_shards`` of the
  first ``(n // num_shards) * num_shards`` records of each pass (grain's
  ``drop_remainder``), and its batches are consecutive runs of ``batch``
  records of the shard's stream, across pass boundaries.  ``len()`` is
  ``len(files) // (batch * num_shards)`` batches, the steps of a trainer
  epoch; each epoch takes the next ``len()`` batches of the stream.
* **Each record's crop is JAX ``_CropSource``'s**: the PNG through
  ``read_png``, a small image reflect-padded, the offset drawn from
  ``default_rng((seed, record_key))``.  A record's crop is the JAX loader's
  byte for byte, in whatever worker or run it is made.
* **Resumable**: ``get_state()`` / ``set_state()`` round-trip the stream
  position as bytes; ``save_loader_state`` / ``restore_loader_state`` keep
  it beside the epoch checkpoint in the JAX file format
  (``loader_state_p{rank}.bin``, an 8-byte little-endian epoch tag first).
* **Worker processes**: ``num_workers`` ``spawn``-started processes of a
  ``torch.utils.data.DataLoader`` decode and crop outside the trainer's GIL;
  the batches come back in stream order.

The order of records is not grain's ``IndexSampler``'s: grain's shuffle
cannot be reproduced without grain.  The crops, the sharding and the resume
semantics are the same.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, List

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset, Sampler

from real_esrgan_tpu_torch.data.dataset import _read_rgb

_STATE_VERSION = 1
# seconds to wait for one batch from the worker processes: 48 crops take them
# well under a second, so a wait this long is a hung or dead worker
WORKER_TIMEOUT_S = 300


class _CropSource(Dataset):
    """Record k -> one uint8 HR crop, deterministic in (seed, k): the offset
    comes from the record key, not from a worker's RNG."""

    def __init__(self, files, hr_size: int, seed: int):
        self._files = list(files)
        self.hr_size = hr_size
        self.seed = seed

    def __len__(self) -> int:
        return len(self._files)

    def __getitem__(self, record_key: int) -> np.ndarray:
        img = _read_rgb(self._files[record_key % len(self._files)])
        h, w, _ = img.shape
        s = self.hr_size
        if h < s or w < s:  # reflect-pad small images (the dataset's contract)
            img = np.pad(img, ((0, max(0, s - h)), (0, max(0, s - w)), (0, 0)), mode="reflect")
            h, w, _ = img.shape
        rng = np.random.default_rng((self.seed, record_key))
        y0 = int(rng.integers(0, h - s + 1))
        x0 = int(rng.integers(0, w - s + 1))
        return np.ascontiguousarray(img[y0:y0 + s, x0:x0 + s])


class _StreamSampler(Sampler):
    """The record keys of one shard's batches, from batch ``start`` on,
    without end."""

    def __init__(self, n: int, batch: int, seed: int, shard_id: int, num_shards: int,
                 start: int):
        self.n, self.batch, self.seed, self.start = n, batch, seed, start
        self.shard_id, self.num_shards = shard_id, num_shards
        self.per_pass = n // num_shards

    def shard_pass(self, p: int) -> np.ndarray:
        order = np.random.default_rng((self.seed, p)).permutation(self.n)
        return order[:self.per_pass * self.num_shards][self.shard_id::self.num_shards]

    def __iter__(self) -> Iterator[List[int]]:
        record = self.start * self.batch
        p, keys = None, None
        while True:
            out = []
            for r in range(record, record + self.batch):
                if r // self.per_pass != p:
                    p = r // self.per_pass
                    keys = self.shard_pass(p)
                out.append(int(keys[r % self.per_pass]))
            record += self.batch
            yield out


def _stack(crops) -> torch.Tensor:
    # a tensor comes back from a worker through shared memory, an array by pickle
    return torch.from_numpy(np.stack(crops))


class GrainLoader:
    """Deterministic sharded HR-crop batch loader over ``torch.utils.data``."""

    def __init__(self, files, batch: int, hr_size: int, num_workers: int = 4, seed: int = 0,
                 shard_id: int = 0, num_shards: int = 1):
        num_shards = max(1, num_shards)
        if len(files) // num_shards < 1:
            raise ValueError(f"{len(files)} records cannot feed {num_shards} shards")
        self.batch = batch
        self.num_workers = num_workers
        self._steps = max(1, len(files) // (batch * num_shards))
        self._source = _CropSource(files, hr_size, seed)
        self._key = {"version": _STATE_VERSION, "n": len(files), "batch": batch,
                     "hr_size": hr_size, "seed": seed, "shard_id": shard_id,
                     "num_shards": num_shards}
        self._position = 0  # batches of the shard's stream handed out
        self._it = None

    def __len__(self) -> int:
        return self._steps

    def _start(self) -> None:
        k = self._key
        sampler = _StreamSampler(k["n"], self.batch, k["seed"], k["shard_id"],
                                 k["num_shards"], self._position)
        workers = dict(num_workers=self.num_workers, multiprocessing_context="spawn",
                       timeout=WORKER_TIMEOUT_S) if self.num_workers > 0 else {}
        self._it = iter(DataLoader(self._source, batch_sampler=sampler, collate_fn=_stack,
                                   **workers))

    def __iter__(self) -> Iterator[np.ndarray]:
        # one persistent stream; each trainer epoch takes len(self) batches of it
        if self._it is None:
            self._start()
        for _ in range(self._steps):
            batch = next(self._it)
            self._position += 1
            yield batch.numpy()

    def close(self) -> None:
        """Stops the worker processes; the next iteration starts them again
        at the same stream position."""
        self._it = None  # the DataLoader iterator shuts its workers down when freed

    def get_state(self) -> bytes:
        return json.dumps({**self._key, "position": self._position}).encode()

    def set_state(self, state: bytes) -> None:
        saved = json.loads(state.decode())
        position = saved.pop("position")
        if saved != self._key:
            raise ValueError(f"loader state is for another stream: {saved} (this loader: "
                             f"{self._key})")
        self.close()
        self._position = int(position)


def _state_path(samples_dir: str, process_index: int) -> str:
    return os.path.join(samples_dir, f"loader_state_p{process_index}.bin")


def save_loader_state(loader, samples_dir: str, epoch: int, process_index: int = 0) -> None:
    """Persists ``loader``'s stream position, tagged with the epoch it
    belongs to; a no-op for loaders without ``get_state`` (the threaded,
    native and pool loaders reseed per epoch and need nothing)."""
    if not hasattr(loader, "get_state"):
        return
    path = _state_path(samples_dir, process_index)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(int(epoch).to_bytes(8, "little") + loader.get_state())
    os.replace(tmp, path)


def restore_loader_state(loader, samples_dir: str, epoch: int,
                         process_index: int = 0) -> bool:
    """Restores the stream position saved for ``epoch``, the resumed run's
    first epoch.  False (the stream starts from record 0) when the loader is
    stateless, no state file exists or its epoch tag is another epoch's."""
    if not hasattr(loader, "set_state") or epoch <= 0:
        return False
    path = _state_path(samples_dir, process_index)
    if not os.path.exists(path):
        return False
    with open(path, "rb") as f:
        blob = f.read()
    if int.from_bytes(blob[:8], "little") != epoch:
        print(f"WARNING: {path} is for a different epoch than the resumed "
              f"checkpoint; the data stream restarts from record 0.")
        return False
    loader.set_state(blob[8:])
    return True
