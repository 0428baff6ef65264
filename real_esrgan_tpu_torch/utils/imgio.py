"""Image IO and array conversion helpers (NHWC, RGB, [0, 1] float): the
port's copy of real_esrgan_tpu/utils/imgio.py.

cv2 is imported only inside the functions that need it.  ``read_png`` and
``write_png`` (over ``decode_png`` and ``encode_png``, which work on bytes)
need only zlib and numpy, so a machine without cv2 or PIL can
still read the usual PNG (grey, palette, RGB, with or without alpha, 8 or
16 bits, non-interlaced) and write an 8-bit RGB one.  ``load_image_rgb``
reads through cv2 where it imports, else a PNG through ``read_png``;
``save_image_rgb`` writes a ``.png`` through ``write_png``.
"""

from __future__ import annotations

import os
import re
import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples a pixel for each PNG colour type, and the bit depths read_png takes
_PNG_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (8, 16), 2: (8, 16), 3: (8,), 4: (8, 16), 6: (8, 16)}


def _diagonal_view(a: np.ndarray, height: int, width: int) -> np.ndarray:
    """The (height, width, k) view of a (D, H, k) array whose element (y, x)
    is a[y + x, y]: the image read along its anti-diagonals."""
    st = a.strides
    return np.lib.stride_tricks.as_strided(a, (height, width, a.shape[2]),
                                           (st[0] + st[1], st[0], st[2]))


def _unfilter_rows(filt: np.ndarray, types: np.ndarray) -> np.ndarray:
    """Filters None (0), Sub (1) and Up (2) only: each run of rows of one
    type at once, Sub as a running sum along the rows, Up down them."""
    height = filt.shape[0]
    p = np.zeros((height + 1,) + filt.shape[1:], np.int16)  # a zero row above the image
    r0 = 0
    while r0 < height:
        ftype, r1 = int(types[r0]), r0 + 1
        while r1 < height and types[r1] == ftype:
            r1 += 1
        block = filt[r0:r1]
        if ftype == 0:
            p[r0 + 1:r1 + 1] = block
        elif ftype == 1:
            p[r0 + 1:r1 + 1] = np.cumsum(block, axis=1, dtype=np.int32) & 0xFF
        else:
            p[r0 + 1:r1 + 1] = (p[r0] + np.cumsum(block, axis=0, dtype=np.int32)) & 0xFF
        r0 = r1
    return p[1:]


def _unfilter_wavefront(filt: np.ndarray, types: np.ndarray) -> np.ndarray:
    """Every filter type, the row's type picked per pixel.

    Byte lane k of pixel (y, x) depends on lane k of (y, x - 1), (y - 1, x)
    and (y - 1, x - 1), so all pixels on one anti-diagonal d = y + x are
    computed in one vector step: H + W - 1 steps.  The image is skewed so
    that a diagonal is a contiguous row: ``ft[d, y]`` is the filtered pixel
    (y, d - y), and ``ot[d + 2, y + 1]`` its output, beside a zero row
    (y = -1) and two zero diagonals; positions with x outside the image are
    never written and read as the zeros PNG puts left of the image."""
    height, width, bpp = filt.shape
    diagonals = height + width - 1
    ft = np.zeros((diagonals, height, bpp), np.int16)
    _diagonal_view(ft, height, width)[...] = filt
    ot = np.zeros((diagonals + 2, height + 1, bpp), np.int16)
    masks = [(types == t)[:, None] for t in range(5)]
    counts = [[0] + np.cumsum(m[:, 0]).tolist() for m in masks]
    for d in range(diagonals):
        y0, y1 = max(0, d - width + 1), min(height - 1, d) + 1
        a, b, c = ot[d + 1, y0 + 1:y1 + 1], ot[d + 1, y0:y1], ot[d, y0:y1]  # left, up, up-left
        present = [counts[t][y1] > counts[t][y0] for t in range(5)]
        preds = [0, a, b, None, None]
        if present[3]:
            preds[3] = (a + b) >> 1
        if present[4]:
            bc, ac = b - c, a - c
            pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
            preds[4] = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        kinds = [t for t in range(5) if present[t]]
        if len(kinds) == 1:
            pred = preds[kinds[0]]
        else:
            pred = np.select([masks[t][y0:y1] for t in kinds], [preds[t] for t in kinds])
        np.bitwise_and(ft[d, y0:y1] + pred, 0xFF, out=ot[d + 2, y0 + 1:y1 + 1])
    return _diagonal_view(ot[2:, 1:], height, width).copy()


def _unfilter(raw: bytes, height: int, width: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters (types 0-4) -> (H, W, bpp) uint8.
    Without Average (3) or Paeth (4) rows, runs of rows go at once
    (``_unfilter_rows``); with them, an anti-diagonal wavefront
    (``_unfilter_wavefront``)."""
    stride = width * bpp
    if len(raw) < height * (stride + 1):
        raise ValueError("PNG image data is shorter than its header says")
    data = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(height, stride + 1)
    types = data[:, 0]
    if height and int(types.max()) > 4:
        raise ValueError(f"bad PNG filter type {int(types.max())}")
    filt = data[:, 1:].reshape(height, width, bpp).astype(np.int16)
    if (types >= 3).any():
        return _unfilter_wavefront(filt, types).astype(np.uint8)
    return _unfilter_rows(filt, types).astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """PNG file -> (H, W, 3) uint8 RGB: ``decode_png`` of its bytes."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB, with zlib and numpy: what
    ``cv2.imread(path, IMREAD_COLOR)`` gives after its BGR -> RGB flip.

    Takes colour types 0 (grey), 2 (RGB), 3 (palette), 4 (grey + alpha) and
    6 (RGBA) at bit depth 8, and at 16 where the type allows it.  Grey
    becomes three equal channels, alpha is dropped (not composited), and a
    16-bit sample keeps its high byte, as cv2 maps it.  Anything else
    (interlaced, bit depth 1, 2 or 4) raises a ``ValueError`` that names
    the colour type, bit depth and interlace; ``path`` names the source in
    errors."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"not a PNG file: {path}")
    pos, idat, header, palette = 8, [], None, None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"PNG without IHDR: {path}")
    width, height, depth, color, _, _, interlace = header
    if depth not in _PNG_DEPTHS.get(color, ()) or interlace != 0:
        raise ValueError(f"{path}: read_png takes non-interlaced PNGs of colour type 0, 2, 4 "
                         f"or 6 at bit depth 8 or 16, or 3 at bit depth 8; got colour type "
                         f"{color}, bit depth {depth}, interlace {interlace}")
    samples = _PNG_SAMPLES[color]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), height, width, samples * depth // 8)
    if depth == 16:
        pixels = pixels[..., 0::2]  # the high byte of each big-endian sample
    if color == 3:
        if palette is None or (pixels.size and int(pixels.max()) >= len(palette)):
            raise ValueError(f"{path}: palette index outside the PLTE chunk")
        return palette[pixels[..., 0]]
    if color in (0, 4):
        return np.repeat(pixels[..., :1], 3, axis=2)
    return np.ascontiguousarray(pixels[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """(H, W, 3) uint8 -> 8-bit RGB PNG file (``encode_png``)."""
    data = encode_png(image)
    with open(path, "wb") as f:
        f.write(data)


def encode_png(image: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> the bytes of an 8-bit RGB PNG, with zlib and numpy."""
    arr = np.ascontiguousarray(image, np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {arr.shape}")
    h, w, _ = arr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * 3)], axis=1)
    return (_PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def load_image_rgb(path: str) -> np.ndarray:
    """Read an image file -> (H, W, 3) float32 RGB in [0, 1], through cv2
    where it imports, as the JAX package does; without cv2, a PNG through
    ``read_png``, which returns what cv2 would."""
    try:
        import cv2
    except ImportError:
        if path.lower().endswith(".png"):
            return read_png(path).astype(np.float32) / 255.0
        raise
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
