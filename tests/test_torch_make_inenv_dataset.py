"""The port's ``tools/make_inenv_dataset.py`` against the JAX tool on the same
seeded synthetic sources, ``TEXTURE_SRCS`` monkeypatched in both as
``tests/test_make_inenv_dataset.py`` does (a splittable texture, one too
small to split, a missing path).

Both write the same file names; every crop and held-out region decodes to
the same pixels (the JAX tool round-trips cv2's BGR, the port reads and
writes RGB); the eval pairs' GT images are identical and their LR images
agree on at least 99.9% of the 8-bit values, none off by more than one level
(``tests/test_torch_make_lr.py``'s bound: the two MATLAB-bicubic resizes sum
in other orders).  The hopper source given as a JPEG without cv2 stops the
tool with a message naming ``--hopper``.
"""

import builtins
import os
import sys

import numpy as np
import pytest

from real_esrgan_tpu_torch.tools import make_inenv_dataset as port_mk
from real_esrgan_tpu_torch.utils.imgio import read_png, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools import make_inenv_dataset as jax_mk  # noqa: E402

FLAGS = ["--textures", "--texture-step", "112", "--tree-step", "256", "--hopper-step", "56",
         "--hopper-repeat", "2"]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    root = tmp_path_factory.mktemp("inenv")
    rng = np.random.default_rng(0)

    def synth(name, h, w):
        path = str(root / name)
        write_png(path, rng.integers(0, 255, (h, w, 3), np.uint8))
        return path

    tree, hopper = synth("tree.png", 1024, 2048), synth("hopper.png", 600, 512)
    textures = [("bigtex", synth("tex_big.png", 700, 512)),
                ("smalltex", synth("tex_small.png", 512, 512)),
                ("missing", str(root / "nope.png"))]
    mp = pytest.MonkeyPatch()
    for module in (jax_mk, port_mk):
        mp.setattr(module, "TEXTURE_SRCS", textures)
    try:
        jax_mk.main(["--out", str(root / "jax"), "--tree", tree, "--hopper", hopper, *FLAGS])
        port_mk.main(["--out", str(root / "port"), "--tree", tree, "--hopper", hopper,
                      "--cpu", *FLAGS])
    finally:
        mp.undo()
    return root


def _files(root, sub):
    return sorted(os.listdir(root / sub))


@pytest.mark.parametrize("sub", ["train", "eval_src", "eval/GTmod4", "eval/LRbicx4"])
def test_same_files(built, sub):
    assert _files(built / "port", sub) == _files(built / "jax", sub)
    assert _files(built / "port", sub)


@pytest.mark.parametrize("sub", ["train", "eval_src", "eval/GTmod4"])
def test_same_pixels(built, sub):
    for name in _files(built / "jax", sub):
        np.testing.assert_array_equal(read_png(str(built / "port" / sub / name)),
                                      read_png(str(built / "jax" / sub / name)), err_msg=name)


def test_crops_come_from_their_regions(built):
    """Spot checks against the sources: the texture's held-out strip is its
    top 256 rows and its first crop starts below it; the small texture
    trains only; the missing one is skipped."""
    src = read_png(str(built / "tex_big.png"))
    port = built / "port"
    np.testing.assert_array_equal(read_png(str(port / "eval_src" / "bigtex_heldout.png")),
                                  src[:256])
    train = _files(port, "train")
    first = next(n for n in train if n.startswith("bigtex"))
    np.testing.assert_array_equal(read_png(str(port / "train" / first)), src[256:656, 0:400])
    assert "smalltex_heldout.png" not in _files(port, "eval_src")
    assert any(n.startswith("smalltex_") for n in train)
    assert not any(n.startswith("missing") for n in train)
    assert sum(n.startswith("hopper_r") for n in train) == 2 * 3  # columns 0, 56, 112


def test_eval_lr_values_agree(built):
    equal, total, worst = 0, 0, 0
    for name in _files(built / "jax", "eval/LRbicx4"):
        ours = read_png(str(built / "port" / "eval" / "LRbicx4" / name)).astype(np.int16)
        ref = read_png(str(built / "jax" / "eval" / "LRbicx4" / name)).astype(np.int16)
        assert ours.shape == ref.shape
        equal += int((ours == ref).sum())
        total += ours.size
        worst = max(worst, int(np.abs(ours - ref).max()))
    assert equal / total >= 0.999 and worst <= 1


def test_a_jpeg_without_cv2_names_the_flag(tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    tree = str(tmp_path / "tree.png")
    write_png(tree, np.zeros((1024, 2048, 3), np.uint8))
    with pytest.raises(SystemExit, match="--hopper"):
        port_mk.main(["--out", str(tmp_path / "ds"), "--tree", tree,
                      "--hopper", str(tmp_path / "photo.jpg"), "--cpu"])
    assert not os.path.exists(tmp_path / "ds")
