"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: each test skips without a CUDA device.  This file imports no
JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Bounds: f32 1e-4 (summation order only, TF32 off); bf16 atol/rtol 2e-2.
"""

import pytest
import torch

from real_esrgan_tpu_torch.ops.fused_rdb import fused_rdb, pack_rdb_weights, rdb_plain

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _packed(dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    kernels = [torch.randn(32 if k < 4 else 64, 64 + 32 * k, 3, 3, generator=g)
               * (2.0 / (9 * (64 + 32 * k))) ** 0.5 for k in range(5)]
    biases = [torch.randn(32 if k < 4 else 64, generator=g) * 0.1 for k in range(5)]
    return [t.to(device) for t in pack_rdb_weights(kernels, biases, 64, 32, dtype)]


@pytest.mark.parametrize("shape", [(1, 48, 64, 64), (2, 67, 93, 64), (1, 5, 3, 64)],
                         ids=["aligned", "ragged", "smaller_than_a_tile"])
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-4, 0.0),
                                             (torch.bfloat16, 2e-2, 2e-2)], ids=["f32", "bf16"])
def test_fused_rdb_kernel_matches_plain(cuda, shape, dtype, atol, rtol):
    packed = _packed(dtype, cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randn(shape, generator=g, device=cuda) * 0.5).to(dtype)
    before = fused_rdb.launches
    out = fused_rdb(x, packed)
    torch.cuda.synchronize()
    assert fused_rdb.launches == before + 1
    torch.testing.assert_close(out.float(), rdb_plain(x, packed).float(), atol=atol, rtol=rtol)


def test_fused_rdb_rejects_what_the_kernel_does_not_take(cuda):
    packed = _packed(torch.float32, cuda)
    x = torch.zeros(1, 16, 16, 64, device=cuda)
    with pytest.raises(ValueError):
        fused_rdb(x.transpose(1, 2), packed)  # not contiguous NHWC
    with pytest.raises(ValueError):
        fused_rdb(torch.zeros(1, 16, 16, 32, device=cuda), packed)
    with pytest.raises(ValueError):
        fused_rdb(x.bfloat16(), packed)  # weights in another dtype
    with pytest.raises(TypeError):
        fused_rdb(x.half(), packed)
    shifted = torch.empty(packed[1].numel() + 1, device=cuda)[1:].view(packed[1].shape)
    shifted.copy_(packed[1])
    with pytest.raises(ValueError, match="16-byte boundary"):
        fused_rdb(x, [packed[0], shifted] + packed[2:])  # weight off a 16-byte boundary
