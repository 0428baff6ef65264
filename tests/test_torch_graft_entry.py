"""The port's entry pair (``real_esrgan_tpu_torch/graft_entry.py``)
against the JAX one (``__graft_entry__.py``): ``entry()``'s forward with
JAX's parameters carried across by the port's converter, within the bf16
bound of tests/test_pallas_rdb.py; the dry run as two gloo ranks."""

import time

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from real_esrgan_tpu_torch import graft_entry
from real_esrgan_tpu_torch.models.convert import state_dict_from_jax_params

BF16_BOUND = 2e-2


def test_entry_forward_matches_jax_with_jax_parameters():
    jax_fn, (jax_params, jax_x) = jax_entry.entry()
    ref = np.asarray(jax.jit(jax_fn)(jax_params, jax_x), np.float32)

    fn, (params, x) = graft_entry.entry(device="cpu")
    assert x.shape == (1, 64, 64, 3) and x.device.type == "cpu"
    np.testing.assert_array_equal(x.numpy(), np.asarray(jax_x))
    carried = state_dict_from_jax_params(jax.device_get(jax_params))
    assert set(carried) == set(params)
    assert all(carried[k].shape == params[k].shape for k in params)
    out = fn(carried, x)
    assert out.shape == (1, 256, 256, 3) and out.dtype == torch.float32
    assert not out.requires_grad
    err = float(np.abs(out.numpy() - ref).max())
    print(f"entry() port vs JAX, bf16, max abs {err:.3e}")
    assert err <= BF16_BOUND

    own = fn(params, x)  # the port's own seeded parameters
    assert own.shape == (1, 256, 256, 3) and bool(torch.isfinite(own).all())


def test_entry_without_cuda_needs_the_cpu_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        graft_entry.entry()


def test_dryrun_multichip_two_ranks(capsys):
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(2)
    seconds = time.perf_counter() - t0
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("dryrun_multichip(2): ")]
    assert len(lines) == 3, lines
    assert "one fused train step OK, loss=" in lines[0]
    assert "one fused GAN step OK, g_loss=" in lines[1] and " d_loss=" in lines[1]
    assert "full-size (23-RRDB, bs48, 256px)" in lines[2]
    assert "24 crops a rank, 702 gradients" in lines[2]
    assert seconds < 120, seconds

