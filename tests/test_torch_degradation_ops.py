"""Port parity of the deterministic degradation ops (real_esrgan_tpu_torch/
ops/{color,resize,filter2d,usm,diffjpeg,augment}.py) against the JAX
package's on the CPU, the JAX side jitted.

Bounds: float32 ops (colour, the three resize modes ragged and at the
extent, USM, the float32 filter) max abs 1e-5; the bf16 filter rounds where
JAX's does, so at least 99.99% of its values are equal and the rest one bf16
step (2^-8) apart; DiffJPEG (a coefficient near a rounding boundary can
round the other way) mean abs 1e-5, 99.9% of values within 1e-4, max 8/255;
the integer ops (crops, flips, rotations, the area resize's prefix sum)
exactly.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_esrgan_tpu.ops import augment as ja
from real_esrgan_tpu.ops import color as jc
from real_esrgan_tpu.ops import diffjpeg as jd
from real_esrgan_tpu.ops import resize as jr
from real_esrgan_tpu.ops import usm as ju
from real_esrgan_tpu_torch.ops import augment as ta
from real_esrgan_tpu_torch.ops import color as tc
from real_esrgan_tpu_torch.ops import diffjpeg as td
from real_esrgan_tpu_torch.ops import filter2d as tf
from real_esrgan_tpu_torch.ops import resize as tr
from real_esrgan_tpu_torch.ops import usm as tu

# the JAX package's ops/__init__.py exports the function filter2d under the
# module's name
jf = importlib.import_module("real_esrgan_tpu.ops.filter2d")

F32_TOL = 1e-5
BF16_STEP = 2.0 ** -8
T = torch.from_numpy


def _rand(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _smooth(shape, seed=0):
    """Random fields blurred by a box: compressible like a natural image."""
    x = _rand(shape, seed)
    for axis in (-3, -2):
        x = (x + np.roll(x, 1, axis) + np.roll(x, -1, axis)) / 3.0
    return (x * 0.8 + 0.1).astype(np.float32)


# ----------------------------------------------------------------- colour

@pytest.mark.parametrize("fn", ["rgb2ycbcr", "rgb2y", "bgr2ycbcr", "ycbcr2rgb", "ycbcr2bgr",
                                "rgb_to_grayscale"])
def test_color_matches_jax(fn):
    x = _rand((2, 9, 11, 3), 1)
    call = {"rgb2y": lambda m, v: m.rgb2ycbcr(v, only_y=True)}.get(
        fn, lambda m, v: getattr(m, fn)(v))
    ref = np.asarray(jax.jit(lambda v: call(jc, v))(x))
    ours = call(tc, T(x)).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=F32_TOL, rtol=0)


def test_expand_y_matches_jax():
    bgr = (np.random.default_rng(2).random((7, 5, 3)) * 255).astype(np.uint8)
    np.testing.assert_array_equal(tc.expand_y(bgr), jc.expand_y(bgr))


# ----------------------------------------------------------------- resize

@pytest.mark.parametrize("method", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("out_hw", [(37, 20), (64, 96), (24, 48)], ids=["down", "up", "mixed"])
@pytest.mark.parametrize("antialias", [False, True], ids=["plain", "antialias"])
def test_resize_fixed_matches_jax(method, out_hw, antialias):
    x = _rand((2, 48, 40, 3), 3)
    ref = np.asarray(jax.jit(lambda v: jr.resize_fixed(v, out_hw, method, antialias))(x))
    ours = tr.resize_fixed(T(x), out_hw, method, antialias).numpy()
    np.testing.assert_allclose(ours, ref, atol=F32_TOL, rtol=0)


def test_upsample_nearest_2x_matches_jax():
    x = _rand((2, 5, 7, 3), 4)
    np.testing.assert_array_equal(tr.upsample_nearest_2x(T(x)).numpy(),
                                  np.asarray(jr.upsample_nearest_2x(jnp.asarray(x))))


@pytest.mark.parametrize("n", [1, 5, 16, 17, 48, 257, 608])
def test_cumsum_sums_in_the_order_of_xla(n):
    """The area resize's prefix sum equals XLA's float32 cumsum bit for bit
    (torch.cumsum sums in float64 on the CPU)."""
    x = _rand((n, 3, 2), n)
    ref = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=0))(x))
    np.testing.assert_array_equal(tr.cumsum_f32(T(x), 0).numpy(), ref)
    ref1 = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=1))(x.transpose(1, 0, 2)))
    np.testing.assert_array_equal(tr.cumsum_f32(T(x.transpose(1, 0, 2).copy()), 1).numpy(), ref1)


# (in extent, out extent, out canvas) on an 80-pixel input canvas: down,
# up past the input canvas, ragged extents, identity, and the extent at
# the canvas edge
DYNAMIC_CASES = [(80, 57, 80), (80, 120, 128), (61, 23, 32), (37, 50, 64), (80, 80, 80),
                 (48, 48, 48), (23, 91, 96)]


@pytest.mark.parametrize("method", [0, 1, 2], ids=["area", "bilinear", "bicubic"])
@pytest.mark.parametrize("case", DYNAMIC_CASES, ids=[f"{a}-{b}-{c}" for a, b, c in DYNAMIC_CASES])
def test_resize_dynamic_matches_jax(method, case):
    """Batched, with traced extents on the JAX side, as the degradation calls
    it; rows and columns beyond the output extent included."""
    n_in, n_out, canvas = case
    x = _rand((3, 80, 80, 3), n_in + n_out)
    f = jax.jit(jax.vmap(lambda img, a, b: jr.resize_dynamic_static_method(
        img, (a, a), (b, b), (canvas, canvas), method)))
    ref = np.asarray(f(x, jnp.full((3,), n_in, jnp.int32), jnp.full((3,), n_out, jnp.int32)))
    ours = tr.resize_dynamic_static_method(T(x), (n_in, n_in), (n_out, n_out), (canvas, canvas),
                                           method).numpy()
    np.testing.assert_allclose(ours, ref, atol=F32_TOL, rtol=0)
    single = tr.resize_dynamic(T(x[0]), (n_in, n_in), (n_out, n_out), (canvas, canvas), method)
    np.testing.assert_array_equal(single.numpy(), ours[0])


def test_area_rows_beyond_the_extent_replicate_the_last_input_row():
    """Rows past the output extent average the last valid input row alone,
    so a later full-canvas blur never blends in zeros."""
    x = _rand((1, 40, 40, 3), 9)
    out = tr.resize_dynamic_static_method(T(x), (30, 30), (20, 20), (32, 32), 0).numpy()
    last = tr.resize_dynamic_static_method(T(x[:, 29:30]), (1, 30), (1, 20), (1, 32), 0).numpy()
    np.testing.assert_array_equal(out[:, 20:], np.broadcast_to(out[:, 20:21], (1, 12, 32, 3)))
    np.testing.assert_allclose(out[:, 20:21], last, atol=F32_TOL, rtol=0)


def test_final_resize_scale_is_taken_by_the_reciprocal_of_a_constant_extent():
    """Where the JAX program's output extent is a constant, XLA takes n_in /
    n_out as n_in * (1 / n_out); at 42 -> 40 the two differ in the last bit
    and shift an area window."""
    x = _rand((2, 48, 48, 3), 10)
    f = jax.jit(jax.vmap(lambda img, a: jr.resize_dynamic_static_method(
        img, (a, a), (40, 40), (40, 40), 0)))
    ref = np.asarray(f(x, jnp.full((2,), 42, jnp.int32)))
    ours = tr.resize_dynamic_static_method(T(x), (42, 42), (40, 40), (40, 40), 0,
                                           reciprocal_out=True).numpy()
    np.testing.assert_array_equal(ours, ref)
    divided = tr.resize_dynamic_static_method(T(x), (42, 42), (40, 40), (40, 40), 0).numpy()
    assert np.abs(divided - ref).max() > 1e-3


# --------------------------------------------------------------- filter2d

@pytest.mark.parametrize("per_sample", [False, True], ids=["shared", "per_sample"])
@pytest.mark.parametrize("k", [3, 7, 21])
def test_filter2d_f32_matches_jax(per_sample, k):
    x = _rand((3, 40, 33, 3), k)
    kernel = _rand((3, k, k) if per_sample else (k, k), k + 1)
    kernel /= kernel.sum(axis=(-2, -1), keepdims=True)
    ref = np.asarray(jax.jit(jf.filter2d)(x, kernel))
    ours = tf.filter2d(T(x), T(kernel)).numpy()
    np.testing.assert_allclose(ours, ref, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("per_sample", [False, True], ids=["shared", "per_sample"])
def test_filter2d_bf16_rounds_where_jax_rounds(per_sample):
    """Per-sample kernels (the degradation's): the output rounded to bf16 as
    JAX rounds it.  One kernel for the batch (a batch of one): XLA drops the
    output's rounding, and so does the port, so the float32 bound holds."""
    x = _smooth((4, 96, 96, 3), 12)
    kernel = _rand((4, 21, 21) if per_sample else (21, 21), 13) ** 4
    kernel /= kernel.sum(axis=(-2, -1), keepdims=True)
    ref = np.asarray(jax.jit(lambda v, w: jf.filter2d(v, w, compute_dtype=jnp.bfloat16))(x, kernel))
    ours = tf.filter2d(T(x), T(kernel), compute_dtype=torch.bfloat16)
    assert ours.dtype == torch.float32
    diff = np.abs(ours.numpy() - ref)
    if per_sample:
        assert (diff == 0).mean() >= 0.9999, (diff == 0).mean()
        assert diff.max() <= BF16_STEP
    else:
        assert diff.max() <= F32_TOL


def test_filter2d_rejects_an_even_kernel():
    with pytest.raises(ValueError, match="odd"):
        tf.filter2d(torch.zeros(1, 8, 8, 3), torch.ones(4, 4))


def test_filter2d_separable_matches_jax():
    x = _rand((2, 30, 26, 3), 14)
    k1d = ju.gaussian_kernel_1d(9, 0.0)
    ref = np.asarray(jax.jit(jf.filter2d_separable)(x, k1d))
    np.testing.assert_allclose(tf.filter2d_separable(T(x), T(k1d)).numpy(), ref, atol=F32_TOL)


# -------------------------------------------------------------------- USM

@pytest.mark.parametrize("ksize", [13, 50, 51])
def test_gaussian_kernel_and_blur_matrix_equal_jax(ksize):
    k = tu.gaussian_kernel_1d(ksize, 0.0)
    np.testing.assert_array_equal(k, ju.gaussian_kernel_1d(ksize, 0.0))
    for n in (1, 7, 64, 100):
        np.testing.assert_array_equal(tu._blur_matrix(n, k.tobytes()),
                                      ju._blur_matrix(n, k.tobytes()))


@pytest.mark.parametrize("size", [40, 128])
def test_usm_sharpen_matches_jax(size):
    x = _smooth((2, size, size, 3), size)
    k = ju.gaussian_kernel_1d(51, 0.0)
    ref = np.asarray(jax.jit(lambda v: ju.usm_sharpen(v, k, 0.5, 10.0))(x))
    ours = tu.usm_sharpen(T(x), k, 0.5, 10.0).numpy()
    np.testing.assert_allclose(ours, ref, atol=F32_TOL, rtol=0)
    blur = np.asarray(jax.jit(lambda v: ju.gaussian_blur_dense(v, k))(x))
    np.testing.assert_allclose(tu.gaussian_blur_dense(T(x), k).numpy(), blur, atol=F32_TOL)


# -------------------------------------------------------------- DiffJPEG

def _jpeg_close(ours: np.ndarray, ref: np.ndarray) -> None:
    diff = np.abs(ours - ref)
    assert diff.mean() <= 1e-5, diff.mean()
    assert (diff <= 1e-4).mean() >= 0.999, (diff <= 1e-4).mean()
    assert diff.max() <= 8 / 255, diff.max()


@pytest.mark.parametrize("quality", [30.0, 60.0, 90.0, 100.0])
def test_diffjpeg_matches_jax_at_a_fixed_quality(quality):
    x = _smooth((1, 64, 64, 3), 15)
    ref = np.asarray(jax.jit(jd.diff_jpeg)(x, jnp.float32(quality)))
    ours = td.diff_jpeg(T(x), quality).numpy()
    assert np.isfinite(ours).all()
    _jpeg_close(ours, ref)


@pytest.mark.parametrize("shape", [(2, 50, 37, 3), (2, 100, 100, 3), (1, 17, 8, 3)])
def test_diffjpeg_matches_jax_when_not_a_multiple_of_16(shape):
    x = _smooth(shape, shape[1])
    q = np.array([40.0, 90.0][:shape[0]], np.float32)
    ref = np.asarray(jax.jit(jd.diff_jpeg)(x, q))
    ours = td.diff_jpeg(T(x), T(q)).numpy()
    assert ours.shape == shape
    _jpeg_close(ours, ref)


def test_diffjpeg_per_sample_quality_and_differentiable_rounding():
    x = _smooth((2, 64, 64, 3), 16)
    q = np.array([30.0, 95.0], np.float32)
    ref = np.asarray(jax.jit(lambda v, w: jd.diff_jpeg(v, w, differentiable=True))(x, q))
    ours = td.diff_jpeg(T(x), T(q), differentiable=True).numpy()
    _jpeg_close(ours, ref)
    hard = td.diff_jpeg(T(x), T(q)).numpy()
    err = [float(np.mean((hard[i] - x[i]) ** 2)) for i in range(2)]
    assert err[1] < err[0]


def test_quality_to_factor_matches_jax_and_rescues_100():
    q = np.array([1.0, 10.0, 49.9, 50.0, 90.0, 99.7, 100.0], np.float32)
    ref = np.asarray(jax.jit(jd.quality_to_factor)(q))
    ours = td.quality_to_factor(T(q)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)
    assert ours[-1] == 0.005 and ours[-2] > 0


def test_diffjpeg_tables_equal_jax():
    np.testing.assert_array_equal(td._dct_matrix(), jd._dct_matrix())
    np.testing.assert_array_equal(td._idct_matrix(), jd._idct_matrix())
    np.testing.assert_array_equal(td._ALPHA, jd._ALPHA)


# ---------------------------------------------------------------- augment

def test_round_is_half_to_even_as_jax():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, 254.5], np.float32)
    np.testing.assert_array_equal(torch.round(T(x)).numpy(), np.asarray(jnp.round(x)))


@pytest.mark.parametrize("rot", range(4))
@pytest.mark.parametrize("hflip", [False, True])
@pytest.mark.parametrize("vflip", [False, True])
def test_apply_orientation_matches_jax(rot, hflip, vflip):
    x = _rand((1, 6, 6, 3), rot)
    ref = np.asarray(ja.apply_orientation(jnp.asarray(x[0]), jnp.int32(rot), jnp.bool_(hflip),
                                          jnp.bool_(vflip)))
    ours = ta.apply_orientation(T(x), torch.tensor([rot]), torch.tensor([hflip]),
                                torch.tensor([vflip])).numpy()
    np.testing.assert_array_equal(ours[0], ref)


def test_orientations_of_a_batch_are_per_sample():
    x = _rand((4, 5, 5, 3), 20)
    rot, hf, vf = torch.tensor([0, 1, 2, 3]), torch.tensor([0, 1, 0, 1]).bool(), \
        torch.tensor([1, 0, 0, 1]).bool()
    ours = ta.apply_orientation(T(x), rot, hf, vf).numpy()
    for i in range(4):
        ref = ja.apply_orientation(jnp.asarray(x[i]), jnp.int32(rot[i].item()),
                                   jnp.bool_(hf[i].item()), jnp.bool_(vf[i].item()))
        np.testing.assert_array_equal(ours[i], np.asarray(ref))


def test_center_crop_matches_jax():
    x = _rand((2, 11, 9, 3), 21)
    np.testing.assert_array_equal(ta.center_crop(T(x), 5).numpy(),
                                  np.asarray(ja.center_crop(jnp.asarray(x), 5)))


def test_paired_crop_at_jax_corners_matches_jax():
    """The crop of JAX's own LR-grid corners (replayed from its key) equals
    ``paired_random_crop`` on that key, and the pairs are aligned."""
    lr, hr = _rand((3, 16, 16, 3), 22), _rand((3, 64, 64, 3), 23)
    key = jax.random.PRNGKey(5)
    ref_lr, ref_hr = jax.jit(lambda k, a, b: ja.paired_random_crop(k, a, b, 32, 4))(key, lr, hr)
    k_t, k_l = jax.random.split(key)
    tops = np.asarray(jax.random.randint(k_t, (3,), 0, (64 - 32) // 4 + 1))
    lefts = np.asarray(jax.random.randint(k_l, (3,), 0, (64 - 32) // 4 + 1))
    ours_lr, ours_hr = ta.crop_pairs(T(lr), T(hr), torch.tensor(tops).long(),
                                     torch.tensor(lefts).long(), 32, 4)
    np.testing.assert_array_equal(ours_lr.numpy(), np.asarray(ref_lr))
    np.testing.assert_array_equal(ours_hr.numpy(), np.asarray(ref_hr))


def test_paired_random_crop_covers_every_corner():
    lr = torch.arange(16 * 16, dtype=torch.float32).reshape(1, 16, 16, 1).expand(4096, 16, 16, 1)
    hr = torch.zeros(4096, 64, 64, 1)
    out_lr, out_hr = ta.paired_random_crop(torch.Generator().manual_seed(0), lr, hr, 32, 4)
    assert out_lr.shape == (4096, 8, 8, 1) and out_hr.shape == (4096, 32, 32, 1)
    corners = out_lr[:, 0, 0, 0].long()
    assert set((corners // 16).tolist()) == set(range(9))
    assert set((corners % 16).tolist()) == set(range(9))
