"""The port's ``tools/nan_probe.py`` and ``tools/explode_analysis.py``.

* ``capture_outputs`` (forward hooks on every named module) against flax's
  ``capture_intermediates`` on the same weights and LR input: every
  activation flax records (the output, conv1..conv4, every RRDB and every
  RDB) has the port's counterpart (``trunk_1/rdb2`` <-> ``trunk.1.rdb2``),
  float32, max abs <= 1e-4.
* The replay on a tiny configuration (1 RRDB x 16 channels, hr 64, f32, 16
  crops, batch 4): one epoch, the trainer's coin stream, no non-finite step.
* ``dissect`` on that state with one weight of ``trunk.0.rdb2`` set to inf:
  the loss is not finite, the first non-finite output is ``trunk.0.rdb2`` or
  a module that finishes after it, the guard rejects the step, and the
  artifacts are written; ``explode_analysis`` reads them back and finds the
  non-finite outputs in both dtypes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_esrgan_tpu.models.rrdbnet import Generator as JaxGenerator
from real_esrgan_tpu_torch import config as run_config
from real_esrgan_tpu_torch.configuration import (
    DegradationConfig, ModelConfig, PipelineGeometry, TrainConfig,
)
from real_esrgan_tpu_torch.models import Generator
from real_esrgan_tpu_torch.models.convert import state_dict_from_jax_params
from real_esrgan_tpu_torch.tools import explode_analysis, nan_probe
from real_esrgan_tpu_torch.utils.imgio import write_png


def _flax_activations(inter) -> dict:
    """flax's recorded activations by the port's module names."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(inter)[0]:
        keys = [p.key for p in path if hasattr(p, "key")][1:-1]  # drop intermediates, __call__
        if len(path) != len(keys) + 3 or leaf.ndim != 4:
            continue  # the packed convs' (kernel, bias) pairs are parameters
        out[".".join(k.replace("trunk_", "trunk.") for k in keys)] = np.asarray(leaf)
    return out


def test_capture_outputs_matches_flax_capture_intermediates():
    x = np.random.default_rng(2).random((2, 12, 16, 3)).astype(np.float32)
    jmodel = JaxGenerator(num_rrdb=2, channels=16, growth=8)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"])
    _, inter = jmodel.apply({"params": params}, jnp.asarray(x), capture_intermediates=True)
    ref = _flax_activations(inter)
    model = Generator(num_rrdb=2, channels=16, growth=8, device="cpu").eval()
    out, ours = nan_probe.capture_outputs(model, state_dict_from_jax_params(params),
                                          torch.from_numpy(x))
    assert set(ref) == {"", "conv1", "conv2", "conv3", "conv4"} | {
        f"trunk.{i}" + s for i in range(2) for s in ("", ".rdb1", ".rdb2", ".rdb3")}
    assert set(ref) <= set(ours)
    for name, value in ref.items():
        assert ours[name].shape == value.shape, name
        np.testing.assert_allclose(ours[name].numpy(), value, atol=1e-4, rtol=0, err_msg=name)
    assert torch.equal(out, ours[""])
    names = list(ours)
    assert names.index("trunk.0.rdb3") < names.index("trunk.0") < names.index("trunk.1.rdb1")


@pytest.fixture()
def tiny(tmp_path, monkeypatch):
    monkeypatch.setattr(run_config, "geometry", PipelineGeometry(hr_size=64, crop_size=32,
                                                                 scale=4))
    monkeypatch.setattr(run_config, "model", ModelConfig(num_rrdb=1, channels=16,
                                                         growth_channels=8))
    monkeypatch.setattr(run_config, "degradation", DegradationConfig(usm_radius=13))
    monkeypatch.setattr(run_config, "train_esrnet", TrainConfig(use_bfloat16=False,
                                                                num_workers=2))
    train = tmp_path / "train"
    train.mkdir()
    rng = np.random.default_rng(0)
    for i in range(16):
        write_png(str(train / f"src{i % 2}_{i:04d}.png"),
                  rng.integers(0, 255, (64, 64, 3), np.uint8))
    return tmp_path


def test_replay_dissect_and_explode_analysis(tiny, capsys):
    out = str(tiny / "probe")
    argv = ["--cpu", "--train-dir", str(tiny / "train"), "--epochs", "1", "--batch-size", "4",
            "--out", out]
    result = nan_probe.main(argv)
    assert result == {"steps": 4, "bad_steps": 0, "reports": []}
    assert "no non-finite step found" in capsys.readouterr().out

    args = nan_probe.build_parser().parse_args(argv)
    probe, state = nan_probe.build_probe(args, 4, torch.device("cpu"))
    state = nan_probe.clone_tree(state)
    state.params["trunk.0.rdb2.conv3.weight"][0, 0, 1, 1] = float("inf")
    hr = torch.from_numpy(np.random.default_rng(1).integers(0, 255, (4, 64, 64, 3), np.uint8))
    report = nan_probe.dissect(probe, state, hr, False, False, "step0_e1")
    assert not np.isfinite(report["loss"]) and report["params_nonfinite"] == 1
    first = report["forward_nonfinite_layers"][0][0]
    assert first in ("trunk.0.rdb2", "trunk.0.rdb3", "trunk.0"), report
    assert report["guard_rejected"] == 1 and report["guarded_params_after_nonfinite"] == 1
    assert report["lr_nonfinite"] == report["hr_nonfinite"] == 0
    for name in ("step0_e1.json", "step0_e1_hr_uint8.npy", "step0_e1_params.npz"):
        assert os.path.isfile(os.path.join(out, name))
    with np.load(os.path.join(out, "step0_e1_params.npz")) as saved:
        assert set(saved.files) == set(state.params)

    explode = explode_analysis.main(["--cpu", "--dir", out, "--step", "0", "--epoch", "1",
                                     "--batch", "0"])
    for dtype in ("bf16", "f32"):
        assert not np.isfinite(explode[dtype]["loss"])
        assert explode[dtype]["nonfinite_outputs"][0][0] == first, explode[dtype]
    assert "=== forward [f32]" in capsys.readouterr().out


def test_coins_replay_the_trainers_stream():
    dcfg = DegradationConfig()
    rng = np.random.default_rng((0, 2, 17))
    coins = [(bool(rng.random() < dcfg.resize_probs1[0]),
              bool(rng.random() < dcfg.resize_probs2[0])) for _ in range(5)]
    assert [explode_analysis.replay_coins(0, 3, b, dcfg) for b in range(5)] == coins
