"""The port's degraded-eval CLI, ``python -m
real_esrgan_tpu_torch.scripts.make_degraded_eval``, end to end on the CPU,
as tests/test_degraded_eval_cli.py drives the JAX one: aligned in-
distribution (LR, HR) pairs, scored by the port's ``eval_pair`` (the
``--bicubic`` no-model baseline too), and the same file names and shapes as
the JAX CLI writes from the same GT directory.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from real_esrgan_tpu_torch.scripts import eval_pair, make_degraded_eval
from real_esrgan_tpu_torch.utils.imgio import read_png, save_image_rgb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--seed", "3", "--hr-size", "64", "--crop-size", "32", "--batch-size", "4", "--cpu"]


@pytest.fixture(scope="module")
def gt_dir(tmp_path_factory):
    gt = tmp_path_factory.mktemp("degraded") / "gt"
    gt.mkdir()
    rng = np.random.default_rng(0)
    # one image yielding 2x2 tiles, one yielding a single tile
    save_image_rgb(str(gt / "big.png"), rng.uniform(size=(128, 128, 3)).astype(np.float32))
    save_image_rgb(str(gt / "small.png"), rng.uniform(size=(70, 64, 3)).astype(np.float32))
    return gt


@pytest.fixture(scope="module")
def pair_dirs(gt_dir):
    out = gt_dir.parent / "pairs"
    make_degraded_eval.main(["--gt-dir", str(gt_dir), "--output-dir", str(out), *ARGS])
    return out


def _area_downscale(hr: np.ndarray, factor: int) -> np.ndarray:
    h, w, c = hr.shape
    return hr.reshape(h // factor, factor, w // factor, factor, c).mean(axis=(1, 3))


def test_make_degraded_eval_writes_aligned_pairs(pair_dirs):
    lr_names = sorted(os.listdir(pair_dirs / "LRx4"))
    hr_names = sorted(os.listdir(pair_dirs / "GTmod4"))
    assert lr_names == hr_names == ["big_000.png", "big_001.png", "big_002.png", "big_003.png",
                                    "small_000.png"]
    for name in lr_names:
        lr = read_png(str(pair_dirs / "LRx4" / name))
        hr = read_png(str(pair_dirs / "GTmod4" / name))
        assert lr.shape == (8, 8, 3) and hr.shape == (32, 32, 3)
        # degradation happened: the LR is not a clean area downscale of the HR
        clean = _area_downscale(hr.astype(np.float64), 4)
        assert np.abs(lr.astype(np.float64) - clean).max() > 2


def test_same_files_and_shapes_as_the_jax_cli(gt_dir, pair_dirs, tmp_path):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import make_degraded_eval as jax_cli
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))
    jax_out = tmp_path / "jax_pairs"
    jax_cli.main(["--gt-dir", str(gt_dir), "--output-dir", str(jax_out), *ARGS])
    for sub in ("LRx4", "GTmod4"):
        names = sorted(os.listdir(jax_out / sub))
        assert names == sorted(os.listdir(pair_dirs / sub))
        for name in names:
            assert read_png(str(jax_out / sub / name)).shape == \
                read_png(str(pair_dirs / sub / name)).shape


def test_each_hr_crop_is_a_window_of_its_gt_tile(gt_dir, pair_dirs):
    """augment is off: every HR crop is a window of its GT tile on the LR
    grid (aligned to the scale), in the tile's orientation."""
    big = read_png(str(gt_dir / "big.png"))
    for idx, (y, x) in enumerate(((0, 0), (0, 64), (64, 0), (64, 64))):
        tile = big[y:y + 64, x:x + 64]
        hr = read_png(str(pair_dirs / "GTmod4" / f"big_{idx:03d}.png"))
        windows = [(t, l) for t in range(0, 33, 4) for l in range(0, 33, 4)
                   if np.abs(tile[t:t + 32, l:l + 32].astype(int) - hr.astype(int)).max() <= 1]
        assert windows, idx


def test_eval_pair_bicubic_baseline(pair_dirs, capsys):
    eval_pair.main(["--bicubic", "--lr-dir", str(pair_dirs / "LRx4"),
                    "--hr-dir", str(pair_dirs / "GTmod4"), "--cpu"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["which"] == "bicubic" and report["n"] == 5
    assert 5.0 < report["psnr_mean"] < 40.0


def test_eval_pair_requires_weights_without_bicubic(pair_dirs):
    with pytest.raises(SystemExit):
        eval_pair.main(["--lr-dir", str(pair_dirs / "LRx4"),
                        "--hr-dir", str(pair_dirs / "GTmod4"), "--cpu"])


def test_without_cpu_and_without_cuda_the_cli_raises(gt_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI runs on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_degraded_eval.main(["--gt-dir", str(gt_dir), "--output-dir", str(tmp_path / "o")])


def test_no_tiles_is_an_error(tmp_path):
    gt = tmp_path / "gt"
    gt.mkdir()
    save_image_rgb(str(gt / "tiny.png"), np.zeros((16, 16, 3), np.float32))
    with pytest.raises(SystemExit, match="no tiles"):
        make_degraded_eval.main(["--gt-dir", str(gt), "--output-dir", str(tmp_path / "o"), *ARGS])
