"""Host -> device batch prefetchers: the port of
real_esrgan_tpu/data/prefetcher.py, after the reference's ``CUDAPrefetcher``
and ``CPUPrefetcher``.

``DevicePrefetcher`` pulls the next batch from the loader in a background
thread while the step runs.  On a CUDA target the thread puts each batch in
pinned host memory and issues its copy on a side ``torch.cuda.Stream``; the
consumer's stream waits on the side stream before the batch is used, and the
batch is recorded on the consumer's stream, so the caching allocator cannot
hand its memory out again while that stream may still read it.  The copy of
batch N+1 thus overlaps the step of batch N.  A batch that already lies on
the target device (``DevicePoolLoader``'s) passes straight through.  On the
CPU the thread moves nothing.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from real_esrgan_tpu_torch.parallel.mesh import local_device


class CPUPrefetcher:
    """The loader's batches as they come, through ``next()`` (None at the end
    of the epoch) and ``reset()``: the reference's ``CPUPrefetcher`` API."""

    def __init__(self, iterable: Iterable):
        self.iterable = iterable
        self._it = iter(iterable)

    def __len__(self):
        return len(self.iterable)

    def next(self):
        return next(self._it, None)

    def reset(self):
        self._it = iter(self.iterable)


class DevicePrefetcher:
    """Yields the loader's batches as uint8 tensors on ``device``, by default
    the rank's own GPU (``parallel.mesh.local_device``).

    ``h2d_bytes`` counts the bytes this prefetcher copied to the device (0
    for batches that were there already)."""

    def __init__(self, iterable: Iterable, device=None, buffer_size: int = 2):
        self.iterable = iterable
        self.device = torch.device(device) if device is not None else local_device()
        self.buffer_size = buffer_size
        self.h2d_bytes = 0

    def __len__(self):
        return len(self.iterable)

    def _on_device(self, batch) -> bool:
        return isinstance(batch, torch.Tensor) and batch.device.type == self.device.type \
            and (self.device.index is None or batch.device.index == self.device.index)

    def __iter__(self) -> Iterator[torch.Tensor]:
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None
        q: "queue.Queue" = queue.Queue(maxsize=self.buffer_size)
        sentinel = object()
        stop = threading.Event()  # the consumer has gone: the producer ends too

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                for batch in self.iterable:
                    if self._on_device(batch):
                        item = (batch, False)
                    else:
                        host = torch.from_numpy(np.ascontiguousarray(batch)) \
                            if isinstance(batch, np.ndarray) else batch
                        if cuda:
                            host = host.pin_memory()
                            with torch.cuda.stream(side):
                                item = (host.to(self.device, non_blocking=True), True)
                            self.h2d_bytes += host.nbytes
                        else:
                            item = (host, False)
                    if not put(item):
                        return
            except Exception as exc:  # raised in the consumer
                put(exc)
                return
            put(sentinel)

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    return
                if isinstance(item, Exception):
                    raise item
                batch, copied = item
                if copied:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_stream(side)
                    batch.record_stream(current)
                yield batch
        finally:
            stop.set()
