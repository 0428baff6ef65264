"""ctypes bindings for the native C++ decode + crop loader: the port of
real_esrgan_tpu/data/native_loader.py, over the same ``native/loader.cpp``.

The source is compiled with ``g++`` (``native/Makefile``'s flags, against
the system's libpng and libjpeg) on first use into a shared library under
``real_esrgan_tpu_torch/_build/`` (listed in ``.gitignore``), whose name
carries a hash of the source, the flags and the host.  The build runs under
an ``fcntl`` lock and writes a temporary file that ``os.replace`` moves into
place, so processes that start at once build it once and never load half a
file.  ``available()`` is False, and ``unavailable_reason()`` keeps the
compiler's message, where the build fails (no ``png.h`` or ``jpeglib.h``,
no ``g++``); the trainers then take the next loader of their chain.

``NativeBatchLoader`` decodes n files and crops each in a C++ thread pool
outside the GIL, with its own decoded-image RAM cache;
``NativeThreadedLoader`` is an epoch iterator over it with
``ThreadedLoader``'s shuffle and shards.  A crop's offset comes from the
C++ ``mt19937_64`` seeded by the batch seed and the position in the batch,
so it is not ``ThreadedLoader``'s crop unless the crop is the whole image.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import queue
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "loader.cpp"
BUILD_DIR = _PKG / "_build"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")
LDLIBS = ("-lpng", "-ljpeg", "-lpthread")

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    # -march=native: a library built on another host may not run on this one
    digest.update(" ".join((*CXXFLAGS, *LDLIBS, platform.machine(), platform.node())).encode())
    return BUILD_DIR / f"native_loader-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compiles ``native/loader.cpp`` unless a current build exists; raises
    with the compiler's output on error."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native_loader.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not lib.exists():  # another process may have built it meanwhile
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            proc = subprocess.run([os.environ.get("CXX", "g++"), *CXXFLAGS, str(SOURCE),
                                   *LDLIBS, "-o", str(tmp)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                first = next((line for line in proc.stdout.splitlines() if "error" in line),
                             f"exit code {proc.returncode}")
                raise RuntimeError(f"g++ failed for {SOURCE.name}: {first.strip()}\n{proc.stdout}")
            os.replace(tmp, lib)
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _error
    with _lib_lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.TimeoutExpired) as exc:
            _error = str(exc)
            return None
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [ctypes.c_int]
        lib.loader_destroy.restype = None
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
        lib.loader_decode_crop_batch.restype = ctypes.c_int
        lib.loader_decode_crop_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint8)]
        lib.loader_set_cache_budget.restype = None
        lib.loader_set_cache_budget.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.loader_cache_stats.restype = None
        lib.loader_cache_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
                                           ctypes.POINTER(ctypes.c_uint64)]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """Why the library could not be built or loaded (None when it was)."""
    _load()
    return _error


class NativeBatchLoader:
    """Decodes n image files and random-crops each into one uint8 batch, in C++."""

    def __init__(self, num_threads: int = 8, cache_bytes: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_error}")
        self._lib = lib
        self._pool = lib.loader_create(num_threads)
        if cache_bytes > 0:
            lib.loader_set_cache_budget(self._pool, cache_bytes)

    def close(self) -> None:
        if getattr(self, "_pool", None):
            self._lib.loader_destroy(self._pool)
            self._pool = None

    __del__ = close

    def decode_crop_batch(self, paths: List[str], crop: int, seed: int) -> np.ndarray:
        if self._pool is None:
            raise RuntimeError("NativeBatchLoader is closed")
        if crop <= 0:
            raise ValueError(f"crop must be positive, got {crop}")
        n = len(paths)
        out = np.empty((n, crop, crop, 3), np.uint8)
        c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        rc = self._lib.loader_decode_crop_batch(
            self._pool, c_paths, n, crop, seed & (2 ** 64 - 1),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc != 0:
            raise IOError(f"native decode failed for {paths[-rc - 1]}")
        return out

    def cache_stats(self) -> Tuple[int, int]:
        """(entries, bytes) of the C++ decoded-image cache."""
        entries, used = ctypes.c_uint64(0), ctypes.c_uint64(0)
        self._lib.loader_cache_stats(self._pool, ctypes.byref(entries), ctypes.byref(used))
        return int(entries.value), int(used.value)


class NativeThreadedLoader:
    """Epoch iterator over HR files through the C++ pool: ``ThreadedLoader``'s
    shuffle (``default_rng(seed + epoch)``), shards and dropped tail, with a
    producer thread ``prefetch`` batches ahead."""

    def __init__(self, files: List[str], batch_size: int, crop: int, num_threads: int = 8,
                 seed: int = 0, prefetch: int = 2, shard_id: int = 0, num_shards: int = 1,
                 cache_bytes: int = 0):
        self.files = list(files)
        self.batch_size = batch_size
        self.crop = crop
        self.seed = seed
        self.prefetch = prefetch
        self.shard_id = shard_id
        self.num_shards = max(1, num_shards)
        self.epoch = 0
        self.native = NativeBatchLoader(num_threads, cache_bytes=cache_bytes)

    def __len__(self):
        return (len(self.files) // self.num_shards) // self.batch_size

    def cache_stats(self) -> Tuple[int, int]:
        return self.native.cache_stats()

    def __iter__(self):
        n = len(self.files)
        # every shard draws the same shuffle and takes a disjoint, equal-length stride
        full_order = np.random.default_rng(self.seed + self.epoch).permutation(n)
        self.epoch += 1
        usable = ((n // self.num_shards) // self.batch_size) * self.batch_size
        order = full_order[self.shard_id::self.num_shards][:usable]

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer():
            try:
                for i in range(0, usable, self.batch_size):
                    paths = [self.files[j] for j in order[i:i + self.batch_size]]
                    q.put(self.native.decode_crop_batch(
                        paths, self.crop, self.seed * 1_000_003 + self.epoch * 97 + i))
            except Exception as exc:  # raised in the consumer
                q.put(exc)
            q.put(sentinel)

        threading.Thread(target=producer, daemon=True).start()
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, Exception):
                raise item
            yield item
