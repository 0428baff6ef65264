"""Port parity of real_esrgan_tpu_torch/ops/resize.py against
real_esrgan_tpu/ops/resize.py on the CPU.

The resample matrices are built by the same numpy code, so they are equal
bit for bit.  ``matlab_resize`` is two float32 matrix products in both
packages; only the summation order differs, hence 1e-5 on inputs in [0, 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_esrgan_tpu.ops.resize import make_matlab_resize_matrix as jax_matrix
from real_esrgan_tpu.ops.resize import matlab_resize as jax_resize
from real_esrgan_tpu_torch.ops.resize import make_matlab_resize_matrix, matlab_resize, true_f32


@pytest.mark.parametrize("antialias", [True, False], ids=["antialias", "plain"])
@pytest.mark.parametrize("scale", [0.5, 0.25, 2, 4])
@pytest.mark.parametrize("length", [7, 48, 97])
def test_resize_matrix_equals_jax(length, scale, antialias):
    out_length = int(np.ceil(length * scale))
    ours = make_matlab_resize_matrix(length, out_length, scale, antialias)
    ref = jax_matrix(length, out_length, scale, antialias)
    assert ours.dtype == np.float32 and ours.shape == (out_length, length)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("scale", [0.25, 0.5, 4.0])
@pytest.mark.parametrize("shape", [(37, 52), (37, 52, 3), (2, 40, 24, 3)], ids=["HW", "HWC", "NHWC"])
def test_matlab_resize_matches_jax(shape, scale):
    img = np.random.default_rng(len(shape)).random(shape).astype(np.float32)
    out = matlab_resize(torch.from_numpy(img), scale)
    ref = np.asarray(jax_resize(jnp.asarray(img), scale))
    assert tuple(out.shape) == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def test_matlab_resize_without_antialias_matches_jax():
    img = np.random.default_rng(9).random((33, 47, 3)).astype(np.float32)
    out = matlab_resize(torch.from_numpy(img), 0.5, antialias=False)
    ref = np.asarray(jax_resize(jnp.asarray(img), 0.5, antialias=False))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def test_true_f32_sets_and_restores_the_tf32_flags():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="inside"):
            with true_f32():
                assert not torch.backends.cuda.matmul.allow_tf32
                assert not torch.backends.cudnn.allow_tf32
                raise RuntimeError("inside")
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
