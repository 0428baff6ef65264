"""What the port's card tests share (not a test module): the ``cuda``
fixture, the committed inputs and the kernels' launch counts a forward.
Imports no JAX, so the card tests run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda*.py
"""

import contextlib
import io
import math
import os

import numpy as np
import pytest
import torch

from real_esrgan_tpu_torch.ops.fused_rdb import fused_rdb, pack_rdb_weights
from real_esrgan_tpu_torch.ops.tail_epilogue import bias_lrelu
from real_esrgan_tpu_torch.train.checkpoint import load_generator_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "assets", "inenv10_esrnet_ema.npz")
TREE = os.path.join(ROOT, "tests", "data", "tree_lr.png")
TREE_SR = os.path.join(ROOT, "tests", "data", "tree_sr.png")
RDB_TOLERANCE = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-2, 2e-2)}  # atol, rtol
RDBS_PER_FORWARD = 69  # 23 RRDBs x 3 RDBs
TAIL_PER_FORWARD = 3  # the tail kernel after upsampling1, upsampling2 and conv3


@pytest.fixture()
def cuda(monkeypatch):
    """The card, with TF32 off for float32 convolutions and products."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


class Launches:
    """The RDB kernel's and the tail kernel's launches inside a ``with``."""

    def __enter__(self):
        self._rdb, self._tail = fused_rdb.launches, bias_lrelu.launches
        return self

    def __exit__(self, *exc):
        self.rdb, self.tail = fused_rdb.launches - self._rdb, bias_lrelu.launches - self._tail


def assert_tail_beside(launches: Launches, rdbs_per_forward: int = RDBS_PER_FORWARD) -> None:
    """The tail kernel launched TAIL_PER_FORWARD times beside each forward's
    ``rdbs_per_forward`` RDB launches, so none in a training step."""
    assert launches.tail * rdbs_per_forward == TAIL_PER_FORWARD * launches.rdb, \
        (launches.tail, launches.rdb)


def trained_packed(dtype, device, name="trunk.11.rdb2"):
    """The packed weights of RDB ``name`` of the committed generator."""
    state = load_generator_params(WEIGHTS)
    convs = [(state[f"{name}.conv{k}.weight"], state[f"{name}.conv{k}.bias"]) for k in range(1, 6)]
    return [t.to(device) for t in pack_rdb_weights([w for w, _ in convs], [b for _, b in convs],
                                                   64, 32, dtype)]


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return math.inf if mse == 0 else 10.0 * math.log10(1.0 / mse)


def printed(fn, *args):
    """``fn(*args)`` with its standard output kept: (result, printed lines)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return result, out.getvalue().splitlines()
