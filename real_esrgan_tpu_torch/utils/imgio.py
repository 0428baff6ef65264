"""Image IO and array conversion helpers (NHWC, RGB, [0, 1] float): the
port's copy of real_esrgan_tpu/utils/imgio.py.

cv2 is imported only inside the functions that need it.  ``read_png`` and
``write_png`` need only zlib and numpy (8-bit RGB, non-interlaced), so a
machine without cv2 or PIL can still read and write the usual PNG; the
``*_image_rgb`` helpers use them for ``.png`` paths.
"""

from __future__ import annotations

import os
import re
import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters (types 0-4)."""
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(height):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1)
        pos += stride + 1
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: running sum per channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint64)
            cur = (cur % 256).astype(np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """8-bit RGB non-interlaced PNG -> (H, W, 3) uint8, with zlib and numpy."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"not a PNG file: {path}")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"PNG without IHDR: {path}")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color != 2 or interlace != 0:
        raise ValueError(f"{path}: read_png takes 8-bit RGB non-interlaced PNGs "
                         f"(got depth {depth}, color type {color}, interlace {interlace})")
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, width * 3, 3)
    return rows.reshape(height, width, 3)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """(H, W, 3) uint8 -> 8-bit RGB PNG, with zlib and numpy."""
    arr = np.ascontiguousarray(image, np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {arr.shape}")
    h, w, _ = arr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def load_image_rgb(path: str) -> np.ndarray:
    """Read an image file -> (H, W, 3) float32 RGB in [0, 1]."""
    if path.lower().endswith(".png"):
        return read_png(path).astype(np.float32) / 255.0
    import cv2

    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    if bgr is None:
        raise FileNotFoundError(f"Cannot read image: {path}")
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0


def save_image_rgb(path: str, image: np.ndarray) -> None:
    """Write (H, W, 3) float RGB in [0, 1] (or uint8) to disk."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
    if path.lower().endswith(".png"):
        write_png(path, arr)
        return
    import cv2

    cv2.imwrite(path, cv2.cvtColor(arr, cv2.COLOR_RGB2BGR))


def image_to_array(image: np.ndarray, range_norm: bool = False) -> np.ndarray:
    """(H, W, C) [0,1] -> (1, H, W, C) float32, optionally scaled to [-1, 1]."""
    arr = np.asarray(image, np.float32)[None]
    if range_norm:
        arr = arr * 2.0 - 1.0
    return arr


def array_to_image(array: np.ndarray, range_norm: bool = False) -> np.ndarray:
    """(1, H, W, C) or (H, W, C) float -> (H, W, C) uint8."""
    arr = np.asarray(array)
    if arr.ndim == 4:
        arr = arr[0]
    if range_norm:
        arr = (arr + 1.0) / 2.0
    return np.clip(arr * 255.0, 0, 255).astype(np.uint8)


def natsorted_files(directory: str):
    """Natural-sorted image files; non-image entries are skipped."""
    exts = (".png", ".jpg", ".jpeg", ".bmp", ".webp", ".tif", ".tiff", ".ppm", ".gif")

    def key(name):
        return [int(t) if t.isdigit() else t.lower()
                for t in re.split(r"(\d+)", name)]

    names = [f for f in os.listdir(directory) if f.lower().endswith(exts)]
    return [os.path.join(directory, f) for f in sorted(names, key=key)]
