"""Port parity: the PyTorch Generator against the JAX Generator on the CPU.

Weights are carried across from JAX (the committed ``assets/`` snapshot or a
random JAX init) so both packages run the same network; inputs come from
numpy.  f32 on the CPU: the bound is 1e-4 on [0, 1] outputs, the JAX tests'
f32 parity bound (conftest sets JAX matmul precision to "highest").
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_esrgan_tpu.models.rrdbnet import Generator as JaxGenerator
from real_esrgan_tpu.models.rrdbnet import pixel_unshuffle as jax_pixel_unshuffle
from real_esrgan_tpu.train.checkpoint import load_generator_params as jax_load
from real_esrgan_tpu_torch.models import Generator, pixel_unshuffle
from real_esrgan_tpu_torch.models.convert import state_dict_from_jax_params
from real_esrgan_tpu_torch.train.checkpoint import load_generator_params
from real_esrgan_tpu_torch.utils.imgio import read_png

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "assets", "inenv10_esrnet_ema.npz")
GOLDEN = os.path.join(ROOT, "tests", "data", "jax_sr_tree_crop67x93_f32.npy")
# rows 64:131, cols 128:221 of tests/data/tree_lr.png: a ragged 67x93 input
CROP = (slice(64, 131), slice(128, 221))


def tree_crop() -> np.ndarray:
    img = read_png(os.path.join(ROOT, "tests", "data", "tree_lr.png"))
    return img[CROP].astype(np.float32) / 255.0


def jax_golden_forward() -> np.ndarray:
    """JAX f32 x4 Generator, esrnet weights, on the tree crop: the golden
    output ``tests/data/jax_sr_tree_crop67x93_f32.npy`` holds."""
    params = jax_load(WEIGHTS)
    out = JaxGenerator(dtype=jnp.float32).apply({"params": params},
                                                jnp.asarray(tree_crop()[None]))
    return np.asarray(out[0])


def test_x4_full_depth_assets_weights_match_jax_golden():
    model = Generator(dtype=torch.float32, device="cpu").eval()
    model.load_state_dict(load_generator_params(WEIGHTS))
    with torch.no_grad():
        out = model(torch.from_numpy(tree_crop()[None]))[0].numpy()
    golden = np.load(GOLDEN)
    assert out.shape == golden.shape == (268, 372, 3)
    np.testing.assert_allclose(out, golden, atol=1e-4, rtol=0)


def test_golden_file_matches_jax():
    """The committed golden output cannot go stale: JAX recomputes it."""
    np.testing.assert_allclose(jax_golden_forward(), np.load(GOLDEN), atol=1e-5, rtol=0)


def _jax_and_port(scale, num_rrdb=2, clamp=True, packed=True, hw=(24, 32)):
    rng = np.random.default_rng(scale)
    x = rng.random((1, *hw, 3)).astype(np.float32)
    jmodel = JaxGenerator(upscale_factor=scale, num_rrdb=num_rrdb, clamp=clamp)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(scale), jnp.asarray(x))["params"])
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    model = Generator(upscale_factor=scale, num_rrdb=num_rrdb, clamp=clamp,
                      packed=packed, device="cpu").eval()
    model.load_state_dict(state_dict_from_jax_params(params))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    return out, ref


@pytest.mark.parametrize("scale,packed", [(4, True), (4, False), (2, True), (1, True)])
def test_scales_match_jax_with_weights_carried_across(scale, packed):
    out, ref = _jax_and_port(scale, packed=packed)
    assert out.shape == ref.shape == (1, 24 * scale, 32 * scale, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_clamp_false_returns_raw_output():
    raw, ref = _jax_and_port(4, clamp=False)
    np.testing.assert_allclose(raw, ref, atol=1e-4, rtol=0)
    clamped, _ = _jax_and_port(4, clamp=True)
    np.testing.assert_allclose(clamped, np.clip(raw, 0.0, 1.0), atol=1e-6, rtol=0)


def test_pixel_unshuffle_matches_jax():
    x = np.random.default_rng(0).random((2, 8, 12, 3)).astype(np.float32)
    for r in (1, 2, 4):
        np.testing.assert_array_equal(pixel_unshuffle(torch.from_numpy(x), r).numpy(),
                                      np.asarray(jax_pixel_unshuffle(jnp.asarray(x), r)))


def test_init_draws_from_the_explicit_generator():
    a = Generator(num_rrdb=1, generator=torch.Generator().manual_seed(3))
    b = Generator(num_rrdb=1, generator=torch.Generator().manual_seed(3))
    c = Generator(num_rrdb=1, generator=torch.Generator().manual_seed(4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["conv1.weight"], sc["conv1.weight"])
    assert not sa["trunk.0.rdb1.conv1.bias"].any()
    # the RDB init is kaiming_normal * 0.1: std sqrt(2 / fan_in) / 10
    std = sa["trunk.0.rdb1.conv5.weight"].std().item()
    assert abs(std - 0.1 * (2.0 / (9 * 192)) ** 0.5) < 2e-4
