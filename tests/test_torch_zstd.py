"""The port's zstd decoder (``csrc/zstd_decode.cpp`` through
``utils/zstd.py``) against the ``zstandard`` package's compressor as the
oracle, bit for bit: levels -5, 1, 3 and 19, with and without the content
checksum and the content size, on inputs of 0 B, 1 B, 128 KiB + 1 (several
blocks), a constant run (RLE blocks), random bytes (raw blocks), text
(matches and repeat offsets), float32 weights (Huffman literals), and
several frames back to back with a skippable frame between them.
Truncated and bit-flipped frames raise; CRC-32C against its published check
value.  The build is the port's own g++ build into ``_build/``.
"""

import os

import numpy as np
import pytest

from real_esrgan_tpu_torch.utils import native_build, zstd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVELS = (-5, 1, 3, 19)


def _inputs():
    rng = np.random.default_rng(0)
    weights = np.load(os.path.join(ROOT, "assets", "inenv10_esrnet_ema.npz"))[
        "trunk_0/rdb1/conv5/kernel"]
    return {
        "empty": b"",
        "one_byte": b"x",
        "several_blocks": rng.integers(0, 256, 128 * 1024 + 1, dtype=np.uint8).tobytes(),
        "constant": b"\x07" * 300_000,
        "text": b"".join(b"line %d: the quick brown fox jumps over the lazy dog\n" % (i % 97)
                         for i in range(6000)),
        "float32_weights": weights.astype(np.float32).tobytes(),
        "float32_normal": rng.standard_normal(150_000).astype(np.float32).tobytes(),
        "small_alphabet": rng.integers(0, 5, 200_000, dtype=np.uint8).tobytes(),
    }


INPUTS = _inputs()


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("checksum", [True, False])
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_decodes_what_zstandard_encodes(name, checksum, level):
    zs = pytest.importorskip("zstandard")
    data = INPUTS[name]
    for content_size in (True, False):
        frame = zs.ZstdCompressor(level=level, write_checksum=checksum,
                                  write_content_size=content_size).compress(data)
        assert zstd.decompress(frame) == data
        assert zstd.decompress(frame, len(data)) == data


def test_a_large_float32_frame_and_its_rate():
    """40 MB of float32 normals in one frame (about 320 blocks of Huffman
    literals); both decoders' rates printed (pytest -s), no timing assert."""
    zs = pytest.importorskip("zstandard")
    import time
    data = np.random.default_rng(3).standard_normal(10_000_000).astype(np.float32).tobytes()
    frame = zs.ZstdCompressor(level=1).compress(data)
    t0 = time.perf_counter()
    assert zstd.decompress(frame) == data
    ours = time.perf_counter() - t0
    t0 = time.perf_counter()
    zs.ZstdDecompressor().decompress(frame)
    theirs = time.perf_counter() - t0
    print(f"40 MB float32 frame: the port's decoder {len(data) / ours / 1e6:.0f} MB/s, "
          f"zstandard {len(data) / theirs / 1e6:.0f} MB/s")


def test_frames_back_to_back_and_skippable_frames():
    zs = pytest.importorskip("zstandard")
    parts = [INPUTS["text"], INPUTS["one_byte"], INPUTS["float32_weights"], INPUTS["empty"]]
    frames = [zs.ZstdCompressor(level=lvl, write_checksum=True).compress(p)
              for lvl, p in zip((1, 19, 3, -5), parts)]
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    joined = frames[0] + skippable + frames[1] + frames[2] + skippable + frames[3]
    assert zstd.decompress(joined) == b"".join(parts)


def test_a_streamed_frame_without_a_content_size():
    """``zstandard``'s stream writer leaves the content size out, so the
    decoder grows its output."""
    zs = pytest.importorskip("zstandard")
    import io
    sink = io.BytesIO()
    with zs.ZstdCompressor(level=3).stream_writer(sink, closefd=False) as writer:
        writer.write(INPUTS["float32_normal"])
    assert zstd.decompress(sink.getvalue()) == INPUTS["float32_normal"]


def test_truncated_and_corrupted_frames_raise():
    zs = pytest.importorskip("zstandard")
    data = INPUTS["text"] + INPUTS["float32_weights"]
    frame = zs.ZstdCompressor(level=3, write_checksum=True).compress(data)
    for cut in (0, 3, 4, 5, 9, len(frame) // 2, len(frame) - 4, len(frame) - 1):
        with pytest.raises(ValueError, match="zstd"):
            zstd.decompress(frame[:cut])
    with pytest.raises(ValueError, match="checksum"):
        bad = bytearray(frame)
        bad[-1] ^= 0x80  # the checksum itself
        zstd.decompress(bytes(bad))
    with pytest.raises(ValueError, match="zstd"):
        zstd.decompress(b"\x00" * 64)


def test_a_flipped_bit_never_passes_the_checksum():
    """With the checksum on, every one of 300 single-bit flips of a frame
    either raises or, where it falls in padding the decoder ignores,
    decodes the original content."""
    zs = pytest.importorskip("zstandard")
    data = INPUTS["float32_weights"][:40_000]
    frame = zs.ZstdCompressor(level=19, write_checksum=True).compress(data)
    rng = np.random.default_rng(2)
    raised = 0
    for position in rng.integers(4, len(frame), 300):
        bad = bytearray(frame)
        bad[position] ^= 1 << int(rng.integers(0, 8))
        try:
            assert zstd.decompress(bytes(bad)) == data
        except ValueError:
            raised += 1
    assert raised >= 290


def test_crc32c_check_value():
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd.crc32c(b"") == 0


def test_the_decoder_is_built_under_the_ports_build_dir():
    lib = native_build.library_path(zstd.SOURCE, native_build.BUILD_DIR, "zstd_decode",
                                    zstd.CXXFLAGS)
    zstd.library()
    assert lib.exists() and lib.parent.name == "_build"
    assert zstd.SOURCE.name == "zstd_decode.cpp" and zstd.SOURCE.parent.name == "csrc"


def test_a_failed_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    """No other decoder is taken where the build fails."""
    source = tmp_path / "zstd_decode.cpp"
    source.write_text("#include <no_such_header_for_this_test.h>\n")
    monkeypatch.setattr(zstd, "SOURCE", source)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(zstd, "_lib", None)
    with pytest.raises(RuntimeError, match="no_such_header_for_this_test.h"):
        zstd.decompress(b"\x28\xb5\x2f\xfd")
    assert [p.name for p in (tmp_path / "build").iterdir()] == ["zstd_decode.lock"]
