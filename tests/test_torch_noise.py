"""Port parity of real_esrgan_tpu_torch/ops/noise.py against
real_esrgan_tpu/ops/noise.py on the CPU.

The port's samplers take their standard normals as inputs.  Fed the normals
the JAX samplers draw from the same key (replayed with ``jax.random``), the
Gaussian and the approximate Poisson noise agree within 1e-6; the 8-bit
level counts agree exactly.  The exact Poisson sampler (torch.poisson) is
held to JAX's by its moments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_esrgan_tpu.ops import noise as jn
from real_esrgan_tpu_torch.ops import noise as tn

NOISE_TOL = 1e-6


def _images(seed=0, b=4, size=48):
    """Smooth gradients with dark and bright corners (Poisson rates from
    below 2 to above 200), a flat image with few levels, and random pixels."""
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0.0, 1.0, size, dtype=np.float32)
    img = np.empty((b, size, size, 3), np.float32)
    img[0] = ramp[None, :, None] * ramp[:, None, None]
    img[1] = 0.004 + 0.01 * ramp[None, :, None]
    img[2] = rng.random((size, size, 3))
    img[3:] = np.clip(0.5 + 0.2 * rng.standard_normal((b - 3, size, size, 3)), 0, 1)
    return img


def _normals(key, shape):
    """The colour and gray normals the JAX samplers draw from ``key``."""
    k_col, k_gray = jax.random.split(key)
    return (np.asarray(jax.random.normal(k_col, shape, jnp.float32)),
            np.asarray(jax.random.normal(k_gray, shape[:3] + (1,), jnp.float32)))


def test_unique_levels_count_exactly():
    img = np.concatenate([_images(1), np.zeros((1, 48, 48, 3), np.float32)])
    img[-1, 0, 0, 0], img[-1, 1, 1, 1] = 10 / 255.0, 100 / 255.0
    q = np.array(jnp.clip(jnp.round(img * 255.0), 0, 255) / 255.0)
    ref = np.asarray(jax.jit(jn._unique_levels)(q))
    ours = tn._unique_levels(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert ours[-1] == 3


def test_vals_from_unique_equal_jax_at_every_count():
    counts = np.arange(0, 257, dtype=np.int32)
    ref = np.asarray(jax.jit(jn._vals_from_unique)(counts))
    np.testing.assert_array_equal(tn._vals_from_unique(torch.from_numpy(counts)).numpy(), ref)


def test_gaussian_noise_on_the_same_normals():
    img = _images(2)
    key = jax.random.PRNGKey(4)
    sigma = np.array([1.0, 10.0, 30.0, 25.0], np.float32)
    gray = np.array([0.0, 1.0, 0.0, 1.0], np.float32)
    ref = np.asarray(jax.jit(jn.gaussian_noise)(key, img, sigma, gray))
    z, zg = _normals(key, img.shape)
    ours = tn.gaussian_noise(torch.from_numpy(img), torch.from_numpy(sigma),
                             torch.from_numpy(gray), torch.from_numpy(z), torch.from_numpy(zg))
    np.testing.assert_allclose(ours.numpy(), ref, atol=NOISE_TOL, rtol=0)
    np.testing.assert_allclose(ours.numpy()[1, ..., 0], ours.numpy()[1, ..., 2], atol=0)


@pytest.mark.parametrize("seed", [5, 6])
def test_poisson_noise_approx_on_the_same_normals(seed):
    """Both branches of the approximate sampler: the small-rate inverse CDF
    (the dark image's rates are below 2) and the Cornish-Fisher branch."""
    img = _images(seed)
    key = jax.random.PRNGKey(seed)
    scale = np.array([0.05, 1.0, 2.0, 3.0], np.float32)
    gray = np.array([0.0, 1.0, 1.0, 0.0], np.float32)
    ref = np.asarray(jax.jit(lambda k, x, s, g: jn.poisson_noise(k, x, s, g, True))(
        key, img, scale, gray))
    z, zg = _normals(key, img.shape)
    ours = tn.poisson_noise(torch.from_numpy(img), torch.from_numpy(scale),
                            torch.from_numpy(gray), True, torch.from_numpy(z),
                            torch.from_numpy(zg))
    np.testing.assert_allclose(ours.numpy(), ref, atol=NOISE_TOL, rtol=0)
    q = tn._quantize(torch.from_numpy(img))
    rates = q * tn._vals_from_unique(tn._unique_levels(q))[:, None, None, None]
    assert (rates[1] < 2.0).all() and (rates[2] >= 2.0).float().mean() > 0.9


def test_poisson_residual_branches_on_the_same_normals():
    """The residual alone over rates 0..300, half of them below 2."""
    rng = np.random.default_rng(8)
    rates = np.concatenate([rng.uniform(0, 2, 20000),
                            rng.uniform(2, 300, 20000)]).astype(np.float32)
    key = jax.random.PRNGKey(8)
    z = np.asarray(jax.random.normal(key, rates.shape, jnp.float32))
    ref = np.asarray(jax.jit(lambda k, r: jn._poisson_residual(k, r, True))(key, rates))
    ours = tn._poisson_residual(torch.from_numpy(rates), True, torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(ours, ref, atol=NOISE_TOL, rtol=0)


def _skew(x):
    x = x - x.mean()
    return (x ** 3).mean() / (x ** 2).mean() ** 1.5


def _exact_rates(image):
    """The colour and gray rates ``poisson_noise`` gives the exact sampler."""
    img_q, gray_q = tn._quantize(image), tn._quantize(tn.rgb_to_grayscale(image))
    return [q * tn._vals_from_unique(tn._unique_levels(q)).reshape(-1, 1, 1, 1)
            for q in (img_q, gray_q)]


def test_exact_poisson_matches_jax_moments():
    """torch.poisson against jax.random.poisson, and the port's approximate
    sampler against its exact one, in mean, variance and skewness, as
    tests/test_noise_jpeg.py::test_poisson_approx_matches_moments holds JAX's."""
    rng = np.random.default_rng(2)
    img = (rng.random((1, 128, 128, 3)) * 0.8 + 0.1).astype(np.float32)
    dark = np.full((1, 192, 192, 3), 8 / 255.0, np.float32)
    for image, skew_tol in ((img, 0.03), (dark, 0.08)):
        ref = np.asarray(jn.poisson_noise(jax.random.PRNGKey(7), jnp.asarray(image),
                                          jnp.ones(1), jnp.zeros(1), approx=False))
        # the sample's seed is 7: its counts are those torch.poisson draws from a
        # generator seeded 7, colour then gray; the approximate sampler's
        # normals follow them in that generator's stream
        exact = tn.poisson_noise(torch.from_numpy(image), torch.ones(1), torch.zeros(1),
                                 seeds=torch.tensor([7])).numpy()
        gen = torch.Generator().manual_seed(7)
        for rates in _exact_rates(torch.from_numpy(image)):
            torch.poisson(rates[0], generator=gen)
        z, zg = (torch.randn(s, generator=gen) for s in (image.shape, image.shape[:3] + (1,)))
        approx = tn.poisson_noise(torch.from_numpy(image), torch.ones(1), torch.zeros(1), True,
                                  z, zg).numpy()
        for ours in (exact, approx):
            np.testing.assert_allclose(ours.mean(), ref.mean(), atol=2e-3)
            np.testing.assert_allclose(ours.std(), ref.std(), rtol=0.05)
            np.testing.assert_allclose(_skew(ours), _skew(ref), atol=skew_tol)


def test_random_add_noise_clips_and_rounds():
    img = torch.from_numpy(np.random.default_rng(4).random((2, 16, 16, 3)).astype(np.float32))
    gen = torch.Generator().manual_seed(4)
    for out in (tn.random_add_gaussian_noise(gen, img, (1.0, 30.0), 0.4),
                tn.random_add_poisson_noise(gen, img, (0.05, 3.0), 0.4)):
        assert out.min() >= 0.0 and out.max() <= 1.0
    out = tn.random_add_gaussian_noise(gen, img, (1.0, 30.0), 0.4, rounds=True)
    np.testing.assert_allclose(out.numpy() * 255.0, np.round(out.numpy() * 255.0), atol=1e-4)


def test_finalize_matches_jax():
    x = np.random.default_rng(9).normal(0.5, 0.6, (3, 8, 8, 3)).astype(np.float32)
    for clip in (False, True):
        for rounds in (False, True):
            ref = np.asarray(jax.jit(lambda v: jn._finalize(v, clip, rounds))(x))
            np.testing.assert_array_equal(tn._finalize(torch.from_numpy(x), clip, rounds).numpy(),
                                          ref)
