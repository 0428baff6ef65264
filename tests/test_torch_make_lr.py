"""The port's ``scripts/make_lr.py`` against the JAX script on seeded images:
the mod-cropped GT images decode to the same bytes, and the MATLAB-bicubic LR
images agree on at least 99.9% of their 8-bit values, none off by more than
one level (float32 sums in another order can land a value on the other side
of a quantisation step).  The two scripts' PNG encoders differ (cv2 against
zlib), so the files are compared as decoded pixels."""

import os
import sys

import numpy as np
import pytest
from PIL import Image

from real_esrgan_tpu_torch.scripts import make_lr
from real_esrgan_tpu_torch.utils.imgio import read_png

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))

import make_lr as jax_make_lr  # noqa: E402

SHAPES = {"a.png": (61, 83), "b10.png": (48, 48), "b2.png": (97, 130), "tiny.png": (3, 40)}


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("make_lr")
    gt_dir = root / "gt"
    gt_dir.mkdir()
    for i, (name, shape) in enumerate(SHAPES.items()):
        img = (np.random.default_rng(i).random((*shape, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(gt_dir / name)
    jax_make_lr.main(["--gt-dir", str(gt_dir), "--output-dir", str(root / "jax"), "--cpu"])
    make_lr.main(["--gt-dir", str(gt_dir), "--output-dir", str(root / "port"), "--cpu"])
    return root


def test_same_pairs_are_written(outputs):
    for kind in ("GTmod4", "LRbicx4"):
        names = sorted(os.listdir(outputs / "port" / kind))
        assert names == sorted(os.listdir(outputs / "jax" / kind))
        assert names == ["a.png", "b10.png", "b2.png"]  # tiny.png is under the scale


def test_gt_pixels_are_identical(outputs):
    for name in os.listdir(outputs / "jax" / "GTmod4"):
        ours = read_png(str(outputs / "port" / "GTmod4" / name))
        ref = read_png(str(outputs / "jax" / "GTmod4" / name))
        h, w = SHAPES[name]
        assert ours.shape == (h - h % 4, w - w % 4, 3)
        np.testing.assert_array_equal(ours, ref)


def test_lr_values_agree(outputs):
    equal, total = 0, 0
    for name in os.listdir(outputs / "jax" / "LRbicx4"):
        ours = read_png(str(outputs / "port" / "LRbicx4" / name)).astype(np.int16)
        ref = read_png(str(outputs / "jax" / "LRbicx4" / name)).astype(np.int16)
        h, w = SHAPES[name]
        assert ours.shape == ref.shape == (h // 4, w // 4, 3)
        assert np.abs(ours - ref).max() <= 1
        equal += int((ours == ref).sum())
        total += ours.size
    assert equal / total >= 0.999


def test_without_cpu_and_without_cuda_it_raises(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        make_lr.main(["--gt-dir", str(tmp_path), "--output-dir", str(tmp_path / "out")])
