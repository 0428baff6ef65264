"""The port's host-side numpy twins (real_esrgan_tpu_torch/ops/host.py, numpy
and scipy only) against the JAX package's (cv2) and against the port's
batched ops, as tests/test_host_ref.py checks the JAX ones.
"""

import numpy as np
import pytest
import torch

from real_esrgan_tpu.ops import host as jhost
from real_esrgan_tpu_torch.ops import host as thost
from real_esrgan_tpu_torch.ops.filter2d import filter2d
from real_esrgan_tpu_torch.ops.usm import gaussian_kernel_1d, usm_sharpen

RNG = np.random.default_rng(11)


@pytest.mark.parametrize("ksize", [13, 51])
def test_usm_np_matches_jax_twin_and_the_batched_op(ksize):
    img = RNG.random((40, 40, 3)).astype(np.float32)
    ours = thost.usm_sharpen_np(img, ksize=ksize)
    np.testing.assert_allclose(ours, jhost.usm_sharpen_np(img, ksize=ksize), atol=2e-5)
    batched = usm_sharpen(torch.from_numpy(img[None]), gaussian_kernel_1d(ksize, 0.0))[0]
    np.testing.assert_allclose(ours, batched.numpy(), atol=2e-4)


@pytest.mark.parametrize("stage", [1, 2])
def test_filter2d_np_matches_cv2_and_the_batched_op(stage):
    img = RNG.random((32, 29, 3)).astype(np.float32)
    k = thost.sample_blur_kernel_np(3, stage=stage)
    assert k.shape == (21, 21)
    np.testing.assert_allclose(k.sum(), 1.0, atol=1e-5)
    ours = thost.filter2d_np(img, k)
    np.testing.assert_allclose(ours, jhost.filter2d_np(img, k), atol=2e-5)
    batched = filter2d(torch.from_numpy(img[None]), torch.from_numpy(k))[0]
    np.testing.assert_allclose(ours, batched.numpy(), atol=2e-5)


def test_sample_blur_kernel_np_is_the_pipelines_sampler():
    assert np.array_equal(thost.sample_blur_kernel_np(5), thost.sample_blur_kernel_np(5))
    assert not np.array_equal(thost.sample_blur_kernel_np(5), thost.sample_blur_kernel_np(6))


def test_noise_np_statistics_and_gray_luma():
    img = np.full((64, 64, 3), 0.5, np.float32)
    g = thost.add_gaussian_noise_np(img, sigma=20.0, rng=np.random.default_rng(0), clip=False)
    np.testing.assert_allclose((g - img).std(), 20.0 / 255.0, rtol=0.05)
    gray = thost.add_gaussian_noise_np(img, 20.0, gray_noise=True, rng=np.random.default_rng(1),
                                       clip=False)
    np.testing.assert_allclose(gray[..., 0], gray[..., 1], atol=1e-7)

    rich = (RNG.random((64, 64, 3)) * 0.8 + 0.1).astype(np.float32)
    p = thost.add_poisson_noise_np(rich, scale=1.0, rng=np.random.default_rng(2), clip=False)
    noise = p - rich
    assert 0.01 < noise.std() < 0.2
    np.testing.assert_allclose(noise.mean(), 0.0, atol=5e-3)
    # the gray path draws the same counts as the JAX twin (cv2's luma)
    ours = thost.add_poisson_noise_np(rich, gray_noise=True, rng=np.random.default_rng(3))
    ref = jhost.add_poisson_noise_np(rich, gray_noise=True, rng=np.random.default_rng(3))
    np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_finalize_np_matches_jax_twin():
    x = np.random.default_rng(4).normal(0.5, 0.6, (8, 8, 3)).astype(np.float32)
    for clip in (False, True):
        for rounds in (False, True):
            np.testing.assert_array_equal(thost._finalize_np(x, clip, rounds),
                                          jhost._finalize_np(x, clip, rounds))
