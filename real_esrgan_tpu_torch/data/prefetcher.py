"""Host -> device batch prefetcher: a minimal port of
real_esrgan_tpu/data/prefetcher.py.

A background thread pulls the next batch from the loader while the step
runs; each batch is put in pinned host memory (on a CUDA target) and copied
with ``non_blocking=True``, so the copy overlaps the device's work.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch


class DevicePrefetcher:
    def __init__(self, iterable: Iterable, device, buffer_size: int = 2):
        self.iterable = iterable
        self.device = torch.device(device)
        self.buffer_size = buffer_size

    def _host(self, batch) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(batch)) if isinstance(batch, np.ndarray) \
            else batch
        return t.pin_memory() if self.device.type == "cuda" else t

    def __iter__(self) -> Iterator[torch.Tensor]:
        q: "queue.Queue" = queue.Queue(maxsize=self.buffer_size)
        sentinel = object()

        def producer():
            try:
                for batch in self.iterable:
                    q.put(self._host(batch))
            except Exception as exc:
                q.put(exc)
            q.put(sentinel)

        threading.Thread(target=producer, daemon=True).start()
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, Exception):
                raise item
            yield item.to(self.device, non_blocking=True)
