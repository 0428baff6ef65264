"""zstd decompression through the port's own decoder, ``csrc/zstd_decode.cpp``
(RFC 8878, decode only), bound with ctypes.

The decoder is host code: ``g++ -O2`` builds it at first use into
``real_esrgan_tpu_torch/_build/`` (``utils/native_build.py``).  A failed
build raises with the compiler's message; there is no other decoder to fall
back on.  It also exports CRC-32C, which OCDBT's nodes carry.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

from real_esrgan_tpu_torch.utils import native_build

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "zstd_decode.cpp"
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")

ERRORS = {
    -2: "malformed zstd data",
    -3: "decoded data larger than expected",
    -4: "content checksum mismatch",
    -5: "frame needs a dictionary, which is not supported",
    -6: "zstd data ends inside a frame",
    -7: "decoded size differs from the frame's declared size",
}
_DST_SMALL = -3

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """The decoder, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native_build.build(SOURCE, native_build.BUILD_DIR,
                                                     "zstd_decode", CXXFLAGS)))
            lib.zstd_content_size.restype = lib.zstd_decompress.restype = ctypes.c_longlong
            lib.zstd_content_size.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
            lib.zstd_decompress.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                            ctypes.c_size_t]
            lib.crc32c.restype = ctypes.c_uint32
            lib.crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
            _lib = lib
        return _lib


def _raise(code: int) -> None:
    raise ValueError(f"zstd: {ERRORS.get(code, f'error {code}')}")


def decompress(data: bytes, size: Optional[int] = None) -> bytes:
    """The content of the zstd frames in ``data`` (skippable frames are
    skipped).  ``size``: the expected decoded size, where the frames may not
    declare theirs.  Raises ``ValueError`` on malformed input."""
    lib = library()
    data = bytes(data)
    declared = lib.zstd_content_size(data, len(data))
    if declared < -1:
        _raise(declared)
    cap = declared if declared >= 0 else (size if size is not None else max(4 * len(data), 1 << 16))
    while True:
        out = ctypes.create_string_buffer(max(cap, 1))
        n = lib.zstd_decompress(data, len(data), out, cap)
        if n >= 0:
            return ctypes.string_at(out, n)
        if n != _DST_SMALL or declared >= 0 or size is not None:
            _raise(n)
        cap *= 4


def crc32c(data: bytes) -> int:
    return library().crc32c(bytes(data), len(data))
