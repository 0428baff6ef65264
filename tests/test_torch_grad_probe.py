"""The port's ``tools/grad_probe.py``.

* The grouping by source (the file name before its last ``_``), as the JAX
  tool groups ``os.listdir``.
* The L1 loss and the global gradient norm on one fixed LR/HR pair against
  ``jax.value_and_grad`` of the same loss and ``optax.global_norm`` (the JAX
  tool's ``loss_grads`` after its degradation), on JAX's weights carried
  across, 1 RRDB x 16 channels, float32: 1e-5 relative.
* The whole tool on the CPU with a tiny configuration and a two-source crop
  set: one finite row a source.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from real_esrgan_tpu.models.rrdbnet import Generator as JaxGenerator
from real_esrgan_tpu_torch import config as run_config
from real_esrgan_tpu_torch.configuration import (
    DegradationConfig, ModelConfig, PipelineGeometry, TrainConfig,
)
from real_esrgan_tpu_torch.models.convert import state_dict_from_jax_params
from real_esrgan_tpu_torch.tools import grad_probe
from real_esrgan_tpu_torch.train.checkpoint import save_params_npz
from real_esrgan_tpu_torch.train.esrnet import build_generator
from real_esrgan_tpu_torch.utils.imgio import write_png

REL = 1e-5


def test_group_by_source(tmp_path):
    for name in ("tree_a_0001.png", "tree_a_0002.png", "hopper_r0_0003.png",
                 "hopper_r1_0001.png", "wood_0040.png"):
        (tmp_path / name).write_bytes(b"")
    groups = grad_probe.group_by_source(str(tmp_path))
    assert {k: len(v) for k, v in groups.items()} == {"tree_a": 2, "hopper_r0": 1,
                                                      "hopper_r1": 1, "wood": 1}


def test_loss_and_grad_norm_match_jax():
    rng = np.random.default_rng(4)
    lr = rng.random((2, 8, 8, 3)).astype(np.float32)
    hr = rng.random((2, 32, 32, 3)).astype(np.float32)
    jmodel = JaxGenerator(num_rrdb=1, channels=16, growth=8)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(4), jnp.asarray(lr))["params"])

    def loss_fn(p):
        return jnp.abs(jmodel.apply({"params": p}, jnp.asarray(lr)) - jnp.asarray(hr)).mean()

    with jax.default_matmul_precision("highest"):
        ref_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    ref_norm = float(optax.global_norm(grads))
    model = build_generator(ModelConfig(num_rrdb=1, channels=16, growth_channels=8),
                            TrainConfig(use_bfloat16=False, remat_rrdb=False), "cpu")
    loss, norm = grad_probe.loss_and_grad_norm(
        model, state_dict_from_jax_params(params), torch.from_numpy(lr), torch.from_numpy(hr))
    assert abs(loss - float(ref_loss)) <= REL * abs(float(ref_loss))
    assert abs(norm - ref_norm) <= REL * ref_norm


@pytest.fixture()
def tiny(tmp_path, monkeypatch):
    monkeypatch.setattr(run_config, "geometry", PipelineGeometry(hr_size=64, crop_size=32,
                                                                 scale=4))
    monkeypatch.setattr(run_config, "model", ModelConfig(num_rrdb=1, channels=16,
                                                         growth_channels=8))
    monkeypatch.setattr(run_config, "degradation", DegradationConfig(usm_radius=13))
    monkeypatch.setattr(run_config, "train_esrnet", TrainConfig(use_bfloat16=False))
    rng = np.random.default_rng(0)
    train = tmp_path / "train"
    train.mkdir()
    for i in range(6):
        write_png(str(train / f"{('tree_a', 'wood')[i % 2]}_{i:04d}.png"),
                  rng.integers(0, 255, (64, 64, 3), np.uint8))
    weights = str(tmp_path / "g.npz")
    save_params_npz(weights, build_generator(run_config.model, run_config.train_esrnet,
                                             training=False).state_dict())
    return tmp_path, weights


@pytest.mark.parametrize("flags", [[], ["--random-init"]])
def test_every_source_gets_one_finite_row(tiny, capsys, flags):
    tmp_path, weights = tiny
    rows = grad_probe.main(["--cpu", "--weights", weights, "--train-dir", str(tmp_path / "train"),
                            "--draws", "2", "--batch", "2", *flags])
    assert sorted(rows) == ["tree_a", "wood"]
    for row in rows.values():
        assert row["tiles"] == 3 and row["n_over_500"] == 0
        assert all(np.isfinite(row[k]) and row[k] > 0 for k in ("gnorm_med", "gnorm_max",
                                                                 "loss_med"))
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["source", "tiles", "gnorm_med", "gnorm_max", "loss_med", "n>500"]
    assert [line.split()[0] for line in lines[1:]] == ["tree_a", "wood"]
