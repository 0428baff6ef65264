"""Port parity of the fused RDB op (real_esrgan_tpu_torch/ops/fused_rdb.py)
against the flax ResidualDenseBlock and the Pallas ``fused_rdb`` on the CPU.

c=64, g=32; inputs from numpy.  Bounds: f32 1e-5 (same math, other summation
order); bf16 atol/rtol 2e-2, the bound of tests/test_pallas_rdb.py.  The
Pallas kernel runs in interpret mode through that file's fixture.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_pallas_rdb import interpret_pallas  # noqa: F401  (fixture)

from real_esrgan_tpu.models.rrdbnet import ResidualDenseBlock as FlaxRDB
from real_esrgan_tpu.ops import pallas_rdb
from real_esrgan_tpu.train.checkpoint import load_generator_params as jax_load
from real_esrgan_tpu_torch.models.rrdbnet import ResidualDenseBlock
from real_esrgan_tpu_torch.ops.fused_rdb import _check, fused_rdb, pack_rdb_weights, rdb_plain

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, G = 64, 32
BAND = 5  # the RDB's halo: 5 chained 3x3 convs


def trained_rdb_params():
    """Trained weights and biases of one RDB (assets/inenv10_esrnet_ema.npz)."""
    return jax_load(os.path.join(ROOT, "assets", "inenv10_esrnet_ema.npz"))["trunk_5"]["rdb2"]


def init_rdb_params(x):
    """Init weights as tests/test_pallas_rdb.py draws them: zero biases."""
    return jax.device_get(FlaxRDB(C, G).init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])


def port_pack(params, dtype):
    kernels = [torch.from_numpy(np.transpose(np.asarray(params[f"conv{k}"]["kernel"]),
                                             (3, 2, 0, 1)).copy()) for k in range(1, 6)]
    biases = [torch.from_numpy(np.asarray(params[f"conv{k}"]["bias"]).copy()) for k in range(1, 6)]
    return pack_rdb_weights(kernels, biases, C, G, dtype)


def flax_block(params, x, dtype=jnp.float32, packed=True):
    out = FlaxRDB(C, G, dtype=dtype, packed=packed).apply(
        {"params": params}, jnp.asarray(x).astype(dtype))
    return np.asarray(out.astype(jnp.float32))


def normal_input(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.5).astype(np.float32)


@pytest.mark.parametrize("flax_packed", [True, False])
@pytest.mark.parametrize("port", ["rdb_plain", "module_unpacked"])
def test_f32_matches_flax_block(port, flax_packed):
    params = trained_rdb_params()
    x = normal_input((2, 20, 28, C))
    ref = flax_block(params, x, packed=flax_packed)
    if port == "rdb_plain":
        out = rdb_plain(torch.from_numpy(x), port_pack(params, torch.float32)).numpy()
    else:
        block = ResidualDenseBlock(C, G, packed=False)
        with torch.no_grad():
            for k, conv in enumerate(block.convs(), start=1):
                conv.weight.copy_(torch.from_numpy(
                    np.transpose(np.asarray(params[f"conv{k}"]["kernel"]), (3, 2, 0, 1)).copy()))
                conv.bias.copy_(torch.from_numpy(np.asarray(params[f"conv{k}"]["bias"]).copy()))
            xt = torch.from_numpy(x).permute(0, 3, 1, 2)
            out = block(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_bf16_matches_flax_bf16_block():
    params = trained_rdb_params()
    x = normal_input((2, 20, 28, C), seed=1)
    ref = flax_block(params, x, dtype=jnp.bfloat16)
    out = rdb_plain(torch.from_numpy(x).bfloat16(), port_pack(params, torch.bfloat16))
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2, rtol=2e-2)


def test_bf16_matches_pallas_kernel_on_interior(interpret_pallas):  # noqa: F811
    rng = np.random.default_rng(0)
    x = rng.random((1, 64, 64, C)).astype(np.float32)
    params = init_rdb_params(x)
    kernels = [jnp.asarray(params[f"conv{i}"]["kernel"]) for i in range(1, 6)]
    biases = [jnp.asarray(params[f"conv{i}"]["bias"]) for i in range(1, 6)]
    pallas = np.asarray(pallas_rdb.fused_rdb(
        jnp.asarray(x), pallas_rdb.pack_rdb_weights(kernels, biases, C, G), tile=32))
    out = rdb_plain(torch.from_numpy(x).bfloat16(), port_pack(params, torch.bfloat16))
    inner = (slice(None), slice(BAND, -BAND), slice(BAND, -BAND))
    np.testing.assert_allclose(out.float().numpy()[inner], pallas.astype(np.float32)[inner],
                               atol=2e-2, rtol=2e-2)


def test_border_band_follows_flax_not_pallas(interpret_pallas):  # noqa: F811
    """With trained (nonzero) biases the Pallas kernel's intermediates are
    nonzero outside the image, so its border band departs from the flax
    block; the port zeroes them there and follows flax everywhere."""
    params = trained_rdb_params()
    x = normal_input((1, 64, 64, C), seed=2)
    kernels = [jnp.asarray(params[f"conv{i}"]["kernel"]) for i in range(1, 6)]
    biases = [jnp.asarray(params[f"conv{i}"]["bias"]) for i in range(1, 6)]
    pallas = np.asarray(pallas_rdb.fused_rdb(
        jnp.asarray(x), pallas_rdb.pack_rdb_weights(kernels, biases, C, G),
        tile=32)).astype(np.float32)
    ref = flax_block(params, x, dtype=jnp.bfloat16)
    out = rdb_plain(torch.from_numpy(x).bfloat16(), port_pack(params, torch.bfloat16))
    out = out.float().numpy()

    border = np.ones(x.shape[1:3], bool)
    border[BAND:-BAND, BAND:-BAND] = False
    np.testing.assert_allclose(out, ref, atol=2e-2, rtol=2e-2)
    assert np.abs(pallas - ref)[:, border].max() > 0.1
    assert np.abs(pallas - ref)[:, ~border].max() < 2e-2
    np.testing.assert_allclose(out[:, ~border], pallas[:, ~border], atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensor_takes_plain_path_without_launching(dtype):
    params = trained_rdb_params()
    x = torch.from_numpy(normal_input((1, 12, 12, C))).to(dtype)
    packed = port_pack(params, dtype)
    fused_rdb.launches = 0
    out = fused_rdb(x, packed)
    assert fused_rdb.launches == 0
    assert torch.equal(out, rdb_plain(x, packed))


def test_check_rejects_packed_tensors_off_a_16_byte_boundary():
    x = torch.zeros(1, 8, 8, C)
    packed = list(port_pack(trained_rdb_params(), torch.float32))
    _check(x, packed)
    for i in (0, 4, 5):  # a weight, the last weight, the bias
        shifted = torch.empty(packed[i].numel() + 1)[1:].view(packed[i].shape)
        shifted.copy_(packed[i])
        assert shifted.is_contiguous() and shifted.data_ptr() % 16
        with pytest.raises(ValueError, match="16-byte boundary"):
            _check(x, packed[:i] + [shifted] + packed[i + 1:])


def test_module_packs_weights_once_until_they_change():
    """Without autograd the block keeps its packed weights; load_state_dict,
    an in-place update or another dtype repacks; with autograd every call
    packs anew and gradients reach the parameters."""
    block = ResidualDenseBlock(C, G)
    params = trained_rdb_params()
    block.load_state_dict({f"conv{k}.{n}": torch.from_numpy(np.asarray(
        np.transpose(params[f"conv{k}"]["kernel"], (3, 2, 0, 1)) if n == "weight"
        else params[f"conv{k}"]["bias"]).copy()) for k in range(1, 6) for n in ("weight", "bias")})
    fresh = lambda dtype: pack_rdb_weights(  # noqa: E731
        [c.weight for c in block.convs()], [c.bias for c in block.convs()], C, G, dtype)
    same = lambda a, b: all(torch.equal(s, t) for s, t in zip(a, b))  # noqa: E731

    with torch.no_grad():
        first = block.packed_weights(torch.float32)
        assert same(first, port_pack(params, torch.float32))
        assert block.packed_weights(torch.float32) is first
        bf16 = block.packed_weights(torch.bfloat16)
        assert bf16[0].dtype == torch.bfloat16 and same(bf16, fresh(torch.bfloat16))
        block.conv3.bias.add_(1.0)
        updated = block.packed_weights(torch.float32)
        assert updated is not first and same(updated, fresh(torch.float32))
        block.load_state_dict({k: torch.zeros_like(v) for k, v in block.state_dict().items()})
        assert not any(t.any() for t in block.packed_weights(torch.float32))

    x = torch.from_numpy(normal_input((1, 6, 6, C))).permute(0, 3, 1, 2)
    assert block.packed_weights(torch.float32) is not block.packed_weights(torch.float32)
    block(x).sum().backward()
    assert block.conv5.bias.grad is not None and block.conv5.bias.grad.abs().sum() > 0
