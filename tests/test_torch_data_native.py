"""The port's native C++ loader (ctypes over ``native/loader.cpp``, built
under ``real_esrgan_tpu_torch/_build/``) on the CPU: both of its loaders
against the JAX package's on the same files and seed, byte for byte; the
whole image at crop = image size; cache hits and budget; reflect-pad of a
small image; a missing file; the locked build.  Each test skips inside
itself where the library does not build here (no libpng or libjpeg headers).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from real_esrgan_tpu_torch.data import dataset, native_loader
from real_esrgan_tpu_torch.utils.imgio import read_png, write_png

ROOT = Path(__file__).resolve().parent.parent
SHAPES = [(64, 80), (48, 48), (50, 97), (72, 64), (96, 60), (64, 64), (80, 56), (60, 90)]


def need_native():
    if not native_loader.available():
        pytest.skip(f"native loader does not build here: {native_loader.unavailable_reason()}")


def need_jax_native():
    from real_esrgan_tpu.data import native_loader as jax_native

    if not jax_native.available():
        pytest.skip("the JAX package's native loader does not build here")
    return jax_native


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(21)
    for i, (h, w) in enumerate(SHAPES):
        write_png(str(d / f"n{i:02d}.png"), (rng.random((h, w, 3)) * 255).astype(np.uint8))
    return sorted(str(p) for p in d.iterdir())


def test_both_loaders_equal_the_jax_packages(files):
    need_native()
    jax_native = need_jax_native()
    ours = native_loader.NativeThreadedLoader(files, 3, 40, num_threads=3, seed=6,
                                              cache_bytes=1 << 24)
    ref = jax_native.NativeThreadedLoader(files, 3, 40, num_threads=2, seed=6)
    assert len(ours) == len(ref) == 2
    for epoch in range(2):
        a, b = list(ours), list(ref)
        assert len(a) == 2
        for x, y in zip(a, b):
            assert x.dtype == np.uint8 and x.shape == (3, 40, 40, 3)
            assert np.array_equal(x, y), epoch
    one = native_loader.NativeBatchLoader(2).decode_crop_batch(files[:4], 32, seed=123)
    assert np.array_equal(one, jax_native.NativeBatchLoader(2).decode_crop_batch(
        files[:4], 32, seed=123))
    used = {int(i) for e in range(2) for i in np.random.default_rng(6 + e).permutation(8)[:6]}
    assert ours.cache_stats()[0] == len(used)  # every image the two epochs read, once


def test_whole_image_at_crop_equal_to_the_image(tmp_path):
    """A crop of a square image's size is the image, so the native loader,
    the threaded loader and the decoded PNG agree at any seed."""
    need_native()
    rng = np.random.default_rng(2)
    for i in range(6):
        write_png(str(tmp_path / f"s{i}.png"), (rng.random((56, 56, 3)) * 255).astype(np.uint8))
    paths = sorted(str(p) for p in tmp_path.iterdir())
    out = native_loader.NativeBatchLoader(2).decode_crop_batch(paths, 56, seed=99)
    assert all(np.array_equal(out[i], read_png(p)) for i, p in enumerate(paths))
    native = native_loader.NativeThreadedLoader(paths, 2, 56, num_threads=2, seed=4)
    threads = dataset.ThreadedLoader(dataset.TrainImageDataset(str(tmp_path), 56), 2, seed=4)
    for _ in range(2):
        for x, y in zip(native, threads):
            assert np.array_equal(x, y)


def test_decoded_cache_hits_and_budget(files):
    need_native()
    cold = native_loader.NativeBatchLoader(2)
    cold.decode_crop_batch(files[:1], 48, seed=0)
    assert cold.cache_stats() == (0, 0)
    warm = native_loader.NativeBatchLoader(2, cache_bytes=1 << 20)
    first = warm.decode_crop_batch([files[0], files[0]], 48, seed=0)
    entries, used = warm.cache_stats()
    assert entries == 1 and 64 * 80 * 3 <= used < 1 << 20
    second = warm.decode_crop_batch([files[0], files[0]], 48, seed=0)  # from the cache
    assert np.array_equal(first, second)
    assert np.array_equal(second, cold.decode_crop_batch([files[0], files[0]], 48, seed=0))
    tiny = native_loader.NativeBatchLoader(2, cache_bytes=100)  # over budget: nothing kept
    tiny.decode_crop_batch(files[:1], 48, seed=0)
    assert tiny.cache_stats() == (0, 0)


def test_reflect_pad_of_a_small_image(tmp_path):
    need_native()
    small = (np.arange(30 * 36 * 3) % 251).astype(np.uint8).reshape(30, 36, 3)
    path = str(tmp_path / "small.png")
    write_png(path, small)
    out = native_loader.NativeBatchLoader(1).decode_crop_batch([path], 40, seed=1)[0]
    # reflect-101 at the bottom and right, as TrainImageDataset pads
    want = np.pad(small, ((0, 10), (0, 4), (0, 0)), mode="reflect")
    assert np.array_equal(out, want)


def test_a_missing_file_raises_and_names_it(files):
    need_native()
    loader = native_loader.NativeBatchLoader(2)
    with pytest.raises(IOError, match="no_such_image.png"):
        loader.decode_crop_batch([files[0], "/no/such/dir/no_such_image.png"], 32, seed=0)
    loader.close()
    with pytest.raises(RuntimeError, match="closed"):
        loader.decode_crop_batch(files[:1], 32, seed=0)


BUILD_ONE = """
import subprocess, sys
from pathlib import Path
from real_esrgan_tpu_torch.data import native_loader
native_loader.BUILD_DIR = Path(sys.argv[1])
run = subprocess.run
def counted(*args, **kwargs):
    print("compiled", flush=True)
    return run(*args, **kwargs)
native_loader.subprocess.run = counted
print(native_loader.build())
"""


def test_processes_that_start_at_once_build_once(tmp_path):
    """Four processes build into an empty directory at once: the lock lets
    one compile, the others load its library; no temporary file is left."""
    need_native()
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_ONE, str(tmp_path)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    assert sum(out.count("compiled") for out, _ in outs) == 1
    built = {out.strip().splitlines()[-1] for out, _ in outs}
    assert len(built) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [Path(built.pop()).name, "native_loader.lock"])


def test_the_library_is_built_under_the_ports_build_dir():
    """The port compiles the JAX package's source as it is, into its own
    build directory, never into native/."""
    need_native()
    assert native_loader.SOURCE == ROOT / "native" / "loader.cpp"
    assert native_loader.library_path().parent == ROOT / "real_esrgan_tpu_torch" / "_build"


def test_a_build_that_fails_is_unavailable_with_the_compilers_reason(tmp_path, monkeypatch):
    """Where a header is missing (as png.h is on a machine without libpng's
    headers), available() is False, the reason names the missing header, and
    the loader refuses to start; nothing is left in the build directory but
    the lock."""
    source = tmp_path / "loader.cpp"
    source.write_text("#include <no_such_header_for_this_test.h>\n")
    monkeypatch.setattr(native_loader, "SOURCE", source)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_error", None)
    assert not native_loader.available()
    reason = native_loader.unavailable_reason()
    assert "no_such_header_for_this_test.h" in reason.splitlines()[0]
    with pytest.raises(RuntimeError, match="native loader unavailable"):
        native_loader.NativeBatchLoader(1)
    assert [p.name for p in (tmp_path / "build").iterdir()] == ["native_loader.lock"]
