"""The port's PNG reader (real_esrgan_tpu_torch/utils/imgio.py) against the
JAX package's ``load_image_rgb``, which reads through cv2.

The PNGs are written two ways:

* by cv2, with each of its row filters (None, Sub, Up, Average, Paeth) and
  its adaptive choice: grey, RGB and RGBA at 8 and 16 bits;
* by a small numpy encoder in this file, which cycles the five filter types
  row by row, for every colour type and bit depth ``read_png`` takes: cv2
  cannot write grey + alpha or palette PNGs, and here each file is sure to
  hold every filter type.

``read_png`` and the port's ``load_image_rgb`` must equal the JAX function
array for array, exactly.  Interlaced and sub-byte PNGs raise, naming their
format.  A 2048 x 1080 PNG written with the Paeth filter reads in under
0.5 s.
"""

import struct
import time
import zlib

import cv2
import numpy as np
import pytest

from real_esrgan_tpu.utils.imgio import load_image_rgb as jax_load_image_rgb
from real_esrgan_tpu_torch.utils import imgio
from real_esrgan_tpu_torch.utils.imgio import load_image_rgb, read_png

SIGNATURE = b"\x89PNG\r\n\x1a\n"
SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
CV2_FILTERS = {"none": cv2.IMWRITE_PNG_FILTER_NONE, "sub": cv2.IMWRITE_PNG_FILTER_SUB,
               "up": cv2.IMWRITE_PNG_FILTER_UP, "avg": cv2.IMWRITE_PNG_FILTER_AVG,
               "paeth": cv2.IMWRITE_PNG_FILTER_PAETH, "all": cv2.IMWRITE_PNG_ALL_FILTERS}


def image(h, w, channels, depth, seed=0):
    """A smooth gradient with noise (so the filters matter), (h, w, channels)
    of uint8 or uint16."""
    rng = np.random.default_rng(seed)
    top = 255 if depth == 8 else 65535
    y, x = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    base = np.stack([(y * (k + 1) + x * (channels - k)) % 1.0 for k in range(channels)], -1)
    noisy = base * 0.8 * top + rng.integers(0, top // 5, (h, w, channels))
    return noisy.astype(np.uint8 if depth == 8 else np.uint16)


def paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_row(ftype, row, prev, bpp):
    """PNG filter ``ftype`` applied to one scanline of bytes (int arrays)."""
    left = np.concatenate([np.zeros(bpp, int), row[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, int), prev[:-bpp]])
    pred = [np.zeros_like(row), left, prev, (left + prev) // 2, paeth(left, prev, upleft)][ftype]
    return (row - pred) % 256


def chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + \
        struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def encode(samples, color, depth, palette=None, interlace=0):
    """A PNG of ``samples`` (h, w, channels; uint8, or uint16 at depth 16),
    row y filtered with type y % 5; with ``interlace``, Adam7 with filter 0."""
    h, w = samples.shape[:2]
    if depth == 16:
        raw_bytes = samples.astype(">u2").view(np.uint8).reshape(h, -1)
    else:
        raw_bytes = samples.astype(np.uint8).reshape(h, -1)
    bpp = SAMPLES[color] * depth // 8
    if interlace:
        passes = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
                  (1, 0, 2, 2), (0, 1, 1, 2)]
        pixels = raw_bytes.reshape(h, w, bpp)
        lines = [b"\x00" + row.tobytes() for x0, y0, dx, dy in passes
                 for row in pixels[y0::dy, x0::dx].reshape(-1, len(pixels[0, x0::dx]) * bpp)
                 if row.size]
    else:
        prev, lines = np.zeros(raw_bytes.shape[1], int), []
        for y in range(h):
            row = raw_bytes[y].astype(int)
            lines.append(bytes([y % 5]) + filter_row(y % 5, row, prev, bpp).astype(np.uint8).tobytes())
            prev = row
    out = SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + chunk(b"IDAT", zlib.compress(b"".join(lines), 6)) + chunk(b"IEND", b"")


def filter_types(path):
    """The set of row filter types in a non-interlaced PNG file."""
    data = open(path, "rb").read()
    w, h, depth, color = struct.unpack(">IIBB", data[16:26])
    idat, pos = b"", 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = 1 + w * SAMPLES[color] * depth // 8
    return {raw[y * stride] for y in range(h)}


def assert_reads_like_jax(path):
    want = jax_load_image_rgb(path)
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.astype(np.float32) / 255.0, want)
    np.testing.assert_array_equal(load_image_rgb(path), want)


CV2_CASES = [("grey8", (), 8), ("rgb8", (3,), 8), ("rgba8", (4,), 8),
             ("grey16", (), 16), ("rgb16", (3,), 16), ("rgba16", (4,), 16)]


@pytest.mark.parametrize("filt", list(CV2_FILTERS))
@pytest.mark.parametrize("name,channels,depth", CV2_CASES, ids=[c[0] for c in CV2_CASES])
def test_cv2_written_png_reads_like_jax(tmp_path, name, channels, depth, filt):
    samples = image(37, 53, (channels or (1,))[0], depth, seed=len(name))
    samples = samples[..., 0] if not channels else samples
    path = str(tmp_path / f"{name}_{filt}.png")
    assert cv2.imwrite(path, samples, [cv2.IMWRITE_PNG_FILTER, CV2_FILTERS[filt]])
    if filt != "all":
        assert filter_types(path) <= {0, {"none": 0, "sub": 1, "up": 2, "avg": 3,
                                          "paeth": 4}[filt]}
    assert_reads_like_jax(path)


ENCODED_CASES = [("grey8", 0, 8), ("grey16", 0, 16), ("rgb8", 2, 8), ("rgb16", 2, 16),
                 ("palette8", 3, 8), ("grey_alpha8", 4, 8), ("grey_alpha16", 4, 16),
                 ("rgba8", 6, 8), ("rgba16", 6, 16)]


@pytest.mark.parametrize("h,w", [(23, 31), (1, 9), (7, 1)], ids=["23x31", "one_row", "one_col"])
@pytest.mark.parametrize("name,color,depth", ENCODED_CASES, ids=[c[0] for c in ENCODED_CASES])
def test_every_filter_type_and_colour_type_reads_like_jax(tmp_path, name, color, depth, h, w):
    palette = None
    if color == 3:
        rng = np.random.default_rng(3)
        palette = rng.integers(0, 256, (40, 3))
        samples = rng.integers(0, 40, (h, w, 1))
    else:
        samples = image(h, w, SAMPLES[color], depth, seed=color)
    path = str(tmp_path / f"{name}.png")
    with open(path, "wb") as f:
        f.write(encode(samples, color, depth, palette))
    assert filter_types(path) == set(range(min(h, 5)))
    assert_reads_like_jax(path)


def test_the_written_files_hold_every_filter_type(tmp_path):
    """The adaptive cv2 file and the encoder's files between them cover
    filters 0-4, mixed row by row."""
    path = str(tmp_path / "enc.png")
    with open(path, "wb") as f:
        f.write(encode(image(10, 12, 3, 8), 2, 8))
    assert filter_types(path) == {0, 1, 2, 3, 4}
    assert_reads_like_jax(path)


def test_interlaced_png_raises_naming_its_format(tmp_path):
    samples = image(11, 13, 3, 8)
    path = str(tmp_path / "adam7.png")
    with open(path, "wb") as f:
        f.write(encode(samples, 2, 8, interlace=1))
    np.testing.assert_array_equal(jax_load_image_rgb(path),
                                  samples.astype(np.float32) / 255.0)  # a valid Adam7 file
    with pytest.raises(ValueError, match=r"colour type 2, bit depth 8, interlace 1"):
        read_png(path)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_sub_byte_depth_raises_naming_its_format(tmp_path, depth):
    path = str(tmp_path / "grey.png")
    with open(path, "wb") as f:
        f.write(SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", 8, 2, depth, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(2 * (1 + depth)))) + chunk(b"IEND", b""))
    with pytest.raises(ValueError, match=rf"colour type 0, bit depth {depth}, interlace 0"):
        read_png(path)


def test_load_image_rgb_reads_through_cv2_and_without_it(tmp_path, monkeypatch):
    """With cv2 the port reads like JAX for any path; without cv2 a PNG goes
    through read_png and gives the same array, and another file raises."""
    samples = image(9, 14, 4, 8)
    png = str(tmp_path / "a.png")
    cv2.imwrite(png, samples)
    bmp = str(tmp_path / "a.bmp")
    cv2.imwrite(bmp, samples[..., :3])
    np.testing.assert_array_equal(load_image_rgb(bmp), jax_load_image_rgb(bmp))
    want = jax_load_image_rgb(png)
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)  # import cv2 -> ImportError
    np.testing.assert_array_equal(load_image_rgb(png), want)
    with pytest.raises(ImportError):
        load_image_rgb(bmp)


def test_round_trip_through_write_png(tmp_path):
    rgb = image(17, 29, 3, 8)
    path = str(tmp_path / "w.png")
    imgio.write_png(path, rgb)
    np.testing.assert_array_equal(read_png(path), rgb)
    assert_reads_like_jax(path)


def test_paeth_png_of_2048x1080_reads_in_under_half_a_second(tmp_path):
    rgb = image(1080, 2048, 3, 8, seed=5)
    path = str(tmp_path / "paeth.png")
    assert cv2.imwrite(path, rgb, [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_FILTER_PAETH])
    assert filter_types(path) == {4}
    read_png(path)  # warm: imports, allocator
    t0 = time.perf_counter()
    got = read_png(path)
    seconds = time.perf_counter() - t0
    np.testing.assert_array_equal(got, rgb[..., ::-1])  # cv2 wrote BGR
    assert seconds < 0.5, f"read_png took {seconds:.3f} s"
