"""The port's ``scripts/snapshot_weights.py``: a checkpoint directory of the
port's trainer -> ``.npz`` -> the same values through both packages'
``load_generator_params``.

The snapshot stores f16 by default, so the values read back are the
checkpoint's rounded to f16, exactly, in both packages; ``--float32`` keeps
them exactly; ``--use-params`` takes the raw parameters instead of the EMA.
A 2-RRDB, 16-channel generator keeps the files small.
"""

import jax
import numpy as np
import pytest
import torch

from real_esrgan_tpu.train.checkpoint import load_generator_params as jax_load
from real_esrgan_tpu_torch.models import Generator
from real_esrgan_tpu_torch.models.convert import state_dict_from_jax_params
from real_esrgan_tpu_torch.scripts import snapshot_weights
from real_esrgan_tpu_torch.train.checkpoint import load_generator_params, save_checkpoint


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A ``g_last`` directory as the port's trainer writes it: params, and
    an EMA that differs from them."""
    params = Generator(num_rrdb=2, channels=16, growth=8,
                       generator=torch.Generator().manual_seed(5)).state_dict()
    ema = {k: v * 0.5 + 0.01 for k, v in params.items()}
    path = str(tmp_path_factory.mktemp("ckpt") / "g_last")
    save_checkpoint(path, {"epoch": 3, "best_niqe": 7.5, "step": 12, "params": params,
                           "ema_params": ema})
    return path, params, ema


@pytest.mark.parametrize("flags", [[], ["--use-params"], ["--float32"]])
def test_snapshot_loads_back_in_both_packages(checkpoint, tmp_path, capsys, flags):
    path, params, ema = checkpoint
    out = str(tmp_path / "snap" / "g.npz")
    assert snapshot_weights.main(["--checkpoint", path, "--output", out, *flags]) == out
    assert f"-> `{out}`" in capsys.readouterr().out
    source = params if "--use-params" in flags else ema
    dtype, stored = ((torch.float32, np.float32) if "--float32" in flags
                     else (torch.float16, np.float16))
    with np.load(out) as data:
        assert {data[k].dtype for k in data.files} == {np.dtype(stored)}
    port = load_generator_params(out)
    jax_side = state_dict_from_jax_params(jax.device_get(jax_load(out)))
    assert port.keys() == jax_side.keys() == source.keys()
    for k, v in source.items():
        expected = v.to(dtype).float()
        assert torch.equal(port[k], expected), k
        assert torch.equal(torch.as_tensor(np.asarray(jax_side[k]), dtype=torch.float32),
                           expected), k


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(ValueError, match="unrecognized"):
        snapshot_weights.main(["--checkpoint", str(tmp_path / "none.bin"),
                               "--output", str(tmp_path / "g.npz")])
