"""The port's ``tools/tail_exp.py`` against the JAX tool's own functions.

* ``conv_i8`` (im2col + ``torch._int_mm``) bit-exact against JAX's
  ``_conv_i8`` (``preferred_element_type=int32``) and against int64 sums, at
  every per-conv shape of ``run_int8`` on a smaller image.
* ``quant`` equal to JAX's ``_quant``: the same int8 values and the same
  float32 scale.
* The requantising int8 RDB against JAX's, restated from
  ``tools/tail_exp.py::run_int8`` with JAX's own ``_quant`` and ``_conv_i8``
  on the same weights: the int8 products are exact on both sides and the
  float32 steps between them are written in the same order, so the bfloat16
  outputs are equal bit for bit.
* The tail's reshapes and (2, 2)-window conv against JAX's (einops and
  ``_conv`` with stride 2), and every mode run once on the CPU at batch 1
  (``B``, ``TAIL_SIZE``, ``RDB_SIZE``, ``EPILOGUE_B`` and ``EPILOGUE_SIZE``
  shrunk).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from einops import rearrange

from real_esrgan_tpu_torch.tools import perf_lab, tail_exp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))

import perf_lab as jax_lab  # noqa: E402
import tail_exp as jax_tail  # noqa: E402


def _i8(shape, seed):
    return (np.random.default_rng(seed).random(shape) * 254 - 127).astype(np.int8)


@pytest.mark.parametrize("cin,cout", tail_exp.INT8_SHAPES)
def test_conv_i8_is_bit_exact(cin, cout):
    xq, kq = _i8((2, 9, 13, cin), cin), _i8((3, 3, cin, cout), cout)
    ours = tail_exp.conv_i8(torch.from_numpy(xq), torch.from_numpy(kq))
    ref = np.asarray(jax_tail._conv_i8(jnp.asarray(xq), jnp.asarray(kq)))
    assert ours.dtype == torch.int32 and ref.dtype == np.int32
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert torch.equal(ours, tail_exp.conv_i8_reference(torch.from_numpy(xq),
                                                        torch.from_numpy(kq)))


def test_quant_equals_jax():
    x = np.random.default_rng(3).normal(0, 2, (2, 8, 8, 32)).astype(np.float32)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        q, s = tail_exp.quant(torch.from_numpy(x).to(dtype))
        jq, js = jax_tail._quant(jnp.asarray(x, jdtype))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert s.dtype == torch.float32 and float(s) == float(js)


def _jax_rdb_int8(kernels, x):
    """JAX's ``rdb_int8`` as ``tools/tail_exp.py::run_int8`` writes it."""
    kq = [jnp.clip(jnp.round(k * 1270), -127, 127).astype(jnp.int8) for k in kernels]
    kscale = [jnp.float32(1 / 1270)] * 5
    c, g = 64, 32
    w_x, w_o1, w_o2, w_o3, w_o4 = jax_lab._pack_source_major(kq)
    lrelu = lambda v: jax.nn.leaky_relu(v, 0.2)  # noqa: E731
    q, conv = jax_tail._quant, jax_tail._conv_i8
    xq, sx = q(x)
    base = conv(xq, w_x).astype(jnp.float32) * (sx * kscale[0])
    o1 = lrelu(base[..., :g])
    o1q, s1 = q(o1)
    t2 = conv(o1q, w_o1).astype(jnp.float32) * (s1 * kscale[1])
    o2 = lrelu(base[..., g:2 * g] + t2[..., :g])
    o2q, s2 = q(o2)
    t3 = conv(o2q, w_o2).astype(jnp.float32) * (s2 * kscale[2])
    o3 = lrelu(base[..., 2 * g:3 * g] + t2[..., g:2 * g] + t3[..., :g])
    o3q, s3 = q(o3)
    t4 = conv(o3q, w_o3).astype(jnp.float32) * (s3 * kscale[3])
    o4 = lrelu(base[..., 3 * g:4 * g] + t2[..., 2 * g:3 * g] + t3[..., g:2 * g] + t4[..., :g])
    o4q, s4 = q(o4)
    t5 = conv(o4q, w_o4).astype(jnp.float32) * (s4 * kscale[4])
    o5 = base[..., 4 * g:] + t2[..., 3 * g:] + t3[..., 2 * g:] + t4[..., g:] + t5
    return (o5 * 0.2 + x.astype(jnp.float32)).astype(jnp.bfloat16)


def test_rdb_int8_matches_jax():
    kernels, _ = perf_lab.rand_weights("cpu", seed=5)
    x = np.random.default_rng(5).random((2, 16, 20, 64)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ours = tail_exp.make_rdb_int8(kernels)(xb).float().numpy()
    ref = np.asarray(_jax_rdb_int8([jnp.asarray(k.numpy()) for k in kernels],
                                   jnp.asarray(xb.float().numpy(), jnp.bfloat16)),
                     np.float32)
    assert ours.shape == ref.shape == x.shape
    np.testing.assert_array_equal(ours, ref)


def test_tail_reshapes_and_window_conv_match_jax():
    rng = np.random.default_rng(1)
    y = rng.random((2, 6, 10, 12)).astype(np.float32)
    np.testing.assert_array_equal(
        tail_exp.depth_to_space(torch.from_numpy(y)).numpy(),
        rearrange(y, "n h w (a b o) -> n (h a) (w b) o", a=2, b=2))
    np.testing.assert_array_equal(
        tail_exp.space_to_depth(torch.from_numpy(y)).numpy(),
        rearrange(y, "n (h a) (w b) c -> n h w (a b c)", a=2, b=2))
    x = rng.random((2, 12, 16, 256)).astype(np.float32)
    k = rng.normal(0, 0.05, (2, 2, 256, 12)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax_tail._conv(jnp.asarray(x), jnp.asarray(k), (2, 2),
                                        ((1, 0), (1, 0))))
    ours = tail_exp.conv_window22(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    assert ours.shape == ref.shape == (2, 6, 8, 12)
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode,count", [("conv4", 5), ("nchw", 4), ("int8", 7), ("epilogue", 6)])
def test_every_mode_runs_on_the_cpu(monkeypatch, mode, count):
    monkeypatch.setattr(tail_exp, "B", 1)
    monkeypatch.setattr(tail_exp, "TAIL_SIZE", 32)
    monkeypatch.setattr(tail_exp, "RDB_SIZE", 16)
    monkeypatch.setattr(tail_exp, "EPILOGUE_B", 1)
    monkeypatch.setattr(tail_exp, "EPILOGUE_SIZE", 8)
    records = tail_exp.main(["--mode", mode, "--iters", "1", "--cpu"])
    assert len(records) == count
    for record in records:
        times = [v for k, v in record.items() if k.endswith("ms")]
        assert times and all(np.isfinite(t) and t > 0 for t in times), record
