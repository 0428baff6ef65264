"""Port parity of real_esrgan_tpu_torch/metrics/niqe.py against
real_esrgan_tpu/metrics/niqe.py on the CPU, on tests/data/tree_sr.png.

Both packages compute the features in float32.  They differ in the 7x7
Gaussian filter (the port writes it as separable shifts and adds, JAX as one
convolution) and in summation order.  ``E[x^2] - mu^2`` on Y in [16, 235]
amplifies those last-digit differences, and alpha is read from a
0.001-step table whose r(alpha) column is nearly flat for large alpha, so
an alpha can move by a few steps.  Measured here on the 224^2 crop: max abs
feature difference 3.0e-3 (three table steps), all within atol 5e-3 /
rtol 2e-2, the bound tests/test_niqe.py holds JAX to against its float64
oracle.  The score of the whole image differs from JAX's by 8.2e-4 (bound
1e-3); JAX's own score is 3.8e-3 from that float64 oracle's.
"""

import importlib
import json
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_esrgan_tpu_torch.metrics.niqe import DEFAULT_MODEL_PATH, NIQE, niqe, niqe_features
from real_esrgan_tpu_torch.utils.imgio import load_image_rgb

# the package's __init__ rebinds the name ``niqe`` to the function
jax_niqe = importlib.import_module("real_esrgan_tpu.metrics.niqe")

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREE_SR = os.path.join(ROOT, "tests", "data", "tree_sr.png")
GOLDEN = os.path.join(ROOT, "tests", "data", "jax_niqe_tree_sr.json")


@pytest.fixture(scope="module")
def tree_sr():
    img = load_image_rgb(TREE_SR)
    assert img.shape == (1024, 2048, 3)
    return img


def centre_crop(img, size=224):
    top, left = (img.shape[0] - size) // 2, (img.shape[1] - size) // 2
    return np.ascontiguousarray(img[top:top + size, left:left + size])


def test_png_reader_gives_the_pixels_cv2_gives(tree_sr):
    ref = cv2.imread(TREE_SR)[:, :, ::-1].astype(np.float32) / 255.0
    np.testing.assert_array_equal(tree_sr, ref)


@pytest.mark.parametrize("crop_border", [4, 0])
def test_features_match_jax_on_the_centre_crop(tree_sr, crop_border):
    crop = centre_crop(tree_sr)[None]
    ours = niqe_features(torch.from_numpy(crop), crop_border, 96).numpy()
    ref = np.asarray(jax_niqe.niqe_features(jnp.asarray(crop), crop_border, 96))
    assert ours.shape == ref.shape == (1, 4, 36)
    np.testing.assert_allclose(ours, ref, atol=5e-3, rtol=2e-2)


def test_features_match_jax_on_a_batch_of_two(tree_sr):
    batch = np.stack([centre_crop(tree_sr), np.ascontiguousarray(tree_sr[100:324, 300:524])])
    ours = niqe_features(torch.from_numpy(batch), 4, 96).numpy()
    ref = np.asarray(jax_niqe.niqe_features(jnp.asarray(batch), 4, 96))
    assert ours.shape == ref.shape == (2, 4, 36)
    np.testing.assert_allclose(ours, ref, atol=5e-3, rtol=2e-2)
    # each image of a batch is scored as it is alone
    alone = niqe_features(torch.from_numpy(batch[1:]), 4, 96).numpy()
    np.testing.assert_allclose(ours[1:], alone, atol=1e-6, rtol=1e-6)


def test_block_order_is_column_major(tree_sr):
    """Block i of a 2-row, 3-column grid is (row i % 2, column i // 2)."""
    img = np.ascontiguousarray(tree_sr[200:392, 500:788])[None]  # 192 x 288: 2 x 3 blocks
    whole = niqe_features(torch.from_numpy(img), 0, 96).numpy()[0]
    ref = np.asarray(jax_niqe.niqe_features(jnp.asarray(img), 0, 96))[0]
    assert whole.shape == (6, 36)
    np.testing.assert_allclose(whole, ref, atol=5e-3, rtol=2e-2)
    # the full-scale alpha of each block separates the orders: column-major fits, row-major not
    assert np.abs(whole[:, 0] - ref[:, 0]).max() < 0.01
    row_major = ref.reshape(3, 2, 36).transpose(1, 0, 2).reshape(6, 36)
    assert np.abs(whole[:, 0] - row_major[:, 0]).max() > 0.05


def test_whole_image_score_matches_jax(tree_sr):
    ours = NIQE(crop_border=4, device="cpu")(tree_sr[None])[0]
    ref = jax_niqe.NIQE(crop_border=4)(tree_sr[None])[0]
    assert abs(ours - ref) < 1e-3, (ours, ref)
    assert abs(niqe(tree_sr, crop_border=4, device="cpu") - ours) < 1e-12


def test_score_features_matches_jax_on_the_same_features(tree_sr):
    feats = np.asarray(jax_niqe.niqe_features(jnp.asarray(centre_crop(tree_sr, 320)[None]), 4, 96))
    feats = np.concatenate([feats, feats[:, ::-1] * 1.01], axis=0)
    feats[1, 2, 5] = np.nan  # a NaN block is dropped from the covariance, not from the mean
    ours = NIQE(crop_border=4, device="cpu").score_features(feats)
    ref = jax_niqe.NIQE(crop_border=4).score_features(feats)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, atol=1e-12, rtol=0)


def test_mat_and_npz_models_agree(tree_sr):
    crop = centre_crop(tree_sr)[None]
    mat = NIQE(crop_border=0, model_path=DEFAULT_MODEL_PATH, device="cpu")
    npz = NIQE(crop_border=0, model_path=DEFAULT_MODEL_PATH.replace(".mat", ".npz"), device="cpu")
    np.testing.assert_array_equal(mat.mu_pris, jax_niqe.NIQE(crop_border=0).mu_pris)
    assert abs(mat(crop)[0] - npz(crop)[0]) < 1e-6


def test_one_block_image_scores_nan_in_both(tree_sr):
    small = np.ascontiguousarray(tree_sr[:110, :110])[None]  # one 96x96 block after the crop
    ours = NIQE(crop_border=4, device="cpu")(small)
    ref = jax_niqe.NIQE(crop_border=4)(small)
    assert np.isnan(ours).all() and np.isnan(ref).all()


def test_degenerate_blocks_give_what_jax_gives_and_do_not_raise():
    """An all-zero MSCN block, and one that holds a NaN, have NaN moment
    ratios: in both packages the NaN goes through argmin (which takes the
    table's first entry, alpha 0.2) and nothing raises."""
    rng = np.random.default_rng(3)
    blocks = rng.standard_normal((1, 4, 96, 96)).astype(np.float32)
    blocks[0, 1] = 0.0
    blocks[0, 3, 5, 7] = np.nan
    from real_esrgan_tpu_torch.metrics.niqe import _block_features, _tables
    ours = _block_features(torch.from_numpy(blocks), _tables(torch.device("cpu"))).numpy()[0]
    tables = tuple(jnp.asarray(t(), jnp.float32) for t in (
        jax_niqe._r_gam_table, jax_niqe._beta_factor_table, jax_niqe._mean_factor_table))
    ref = np.stack([np.asarray(jax_niqe._block_features(jnp.asarray(b), tables))
                    for b in blocks[0]])
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    np.testing.assert_allclose(ours, ref, atol=5e-3, rtol=2e-2)
    assert ours[1, 0] == ours[3, 0] == np.float32(0.2) and ours[0, 0] > 1.0


def test_tensor_input_and_default_device(tree_sr):
    crop = centre_crop(tree_sr)[None]
    metric = NIQE(crop_border=4, device="cpu")
    assert metric(torch.from_numpy(crop))[0] == metric(crop)[0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            NIQE()


def test_committed_jax_golden_is_current(tree_sr):
    """tests/data/jax_niqe_tree_sr.json holds JAX's score and per-feature
    block means for tree_sr.png (crop_border 4), for the check on the card,
    where there is no JAX.  It was written by this computation."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    feats = np.asarray(jax_niqe.niqe_features(jnp.asarray(tree_sr[None]), golden["crop_border"],
                                              golden["block_size"]))
    score = jax_niqe.NIQE(crop_border=golden["crop_border"]).score_features(feats)[0]
    assert list(feats.shape) == golden["features_shape"]
    assert abs(score - golden["score"]) < 1e-6
    np.testing.assert_allclose(np.nanmean(feats[0].astype(np.float64), axis=0),
                               golden["feature_means"], atol=1e-5, rtol=0)
    # and the port agrees with the golden as it must on the card
    ours = niqe_features(torch.from_numpy(tree_sr[None]), 4, 96).numpy()
    np.testing.assert_allclose(np.nanmean(ours[0].astype(np.float64), axis=0),
                               golden["feature_means"], atol=2e-3, rtol=2e-2)
