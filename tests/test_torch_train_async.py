"""The rest of the port's checkpoints on the CPU: ``AsyncSaver`` (order,
errors raised by the next call, a snapshot taken before the call returns),
``save_params_npz`` crossing to the JAX package and back, ``restore_like``,
the host-memory failsafe (the counterpart of tests/test_hostmem.py), and the
stage-1 CLI's asynchronous saves and failsafe exit.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_esrgan_tpu.models import Generator as JaxGenerator
from real_esrgan_tpu.models.convert import convert_generator as jax_convert_generator
from real_esrgan_tpu.train.checkpoint import load_generator_params as jax_load_generator_params
from real_esrgan_tpu.train.checkpoint import save_params_npz as jax_save_params_npz
from real_esrgan_tpu_torch import config as run_config
from real_esrgan_tpu_torch import train_realesrnet as trainer
from real_esrgan_tpu_torch.configuration import (
    DegradationConfig, ModelConfig, PipelineGeometry, TrainConfig,
)
from real_esrgan_tpu_torch.models.convert import state_dict_from_jax_params
from real_esrgan_tpu_torch.models.rrdbnet import Generator
from real_esrgan_tpu_torch.train import checkpoint as ckpt_lib
from real_esrgan_tpu_torch.utils import hostmem


def test_async_saver_writes_in_order_with_copies(tmp_path):
    saver = ckpt_lib.AsyncSaver()
    for i in range(3):  # each save joins the last: the last write wins
        saver.save(str(tmp_path / "ck"), {"epoch": i, "w": torch.full((2,), float(i))},
                   copies=[str(tmp_path / "last")])
    saver.save_many([(str(tmp_path / "g"), {"epoch": 7}, [str(tmp_path / "g_last")]),
                     (str(tmp_path / "d"), {"epoch": 8}, [])])
    saver.wait()
    for name, epoch in (("ck", 2), ("last", 2), ("g", 7), ("g_last", 7), ("d", 8)):
        assert ckpt_lib.load_checkpoint(str(tmp_path / name))["epoch"] == epoch, name
    assert torch.equal(ckpt_lib.load_checkpoint(str(tmp_path / "last"))["w"], torch.full((2,), 2.))


def test_async_saver_snapshots_before_it_returns(tmp_path, monkeypatch):
    """The thread writes late (a slowed save_checkpoint); the live tensors are
    changed in place and replaced as soon as save returns; the file holds
    the values at the call."""
    real = ckpt_lib.save_checkpoint

    def slow(path, payload):
        time.sleep(0.3)
        real(path, payload)

    monkeypatch.setattr(ckpt_lib, "save_checkpoint", slow)
    w = torch.arange(6.0)
    payload = {"params": {"w": w}, "opt_state": {"count": torch.tensor(3, dtype=torch.int32)}}
    saver = ckpt_lib.AsyncSaver()
    saver.save(str(tmp_path / "ck"), payload)
    w.add_(100.0)
    payload["params"]["w"] = torch.zeros(6)
    saver.wait()
    tree = ckpt_lib.load_checkpoint(str(tmp_path / "ck"))
    assert torch.equal(tree["params"]["w"], torch.arange(6.0))
    assert int(tree["opt_state"]["count"]) == 3


def test_async_saver_raises_a_failure_on_the_next_call(tmp_path):
    (tmp_path / "a_file").write_text("not a directory")
    bad = str(tmp_path / "a_file" / "ck")
    saver = ckpt_lib.AsyncSaver()
    saver.save(bad, {"epoch": 0})
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        saver.wait()
    saver.wait()  # the error is consumed; the saver stays usable
    saver.save(bad, {"epoch": 1})
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        saver.save(str(tmp_path / "ok"), {"epoch": 2})
    saver.save(str(tmp_path / "ok"), {"epoch": 3})
    saver.wait()
    assert ckpt_lib.load_checkpoint(str(tmp_path / "ok"))["epoch"] == 3


@pytest.fixture(scope="module")
def jax_params():
    model = JaxGenerator(num_rrdb=2, channels=16, growth=8)
    return jax.device_get(model.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 3)))["params"])


def _f16(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float16).astype(np.float32), tree)


def test_the_ports_npz_reads_in_jax_as_the_f16_rounded_weights(tmp_path, jax_params):
    sd = state_dict_from_jax_params(jax_params)
    path = str(tmp_path / "g.npz")
    ckpt_lib.save_params_npz(path, sd)
    with np.load(path) as data:
        assert all(data[k].dtype == np.float16 for k in data.files)
        assert "trunk_1/rdb3/conv5/kernel" in data.files
    back = jax_load_generator_params(path)
    ref = _f16(jax_convert_generator({k: v.numpy() for k, v in sd.items()}))
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, ref)
    ours = ckpt_lib.load_generator_params(path)
    expected = state_dict_from_jax_params(_f16(jax_params))
    assert set(ours) == set(expected)
    for k in expected:
        assert torch.equal(ours[k], expected[k]), k


def test_a_jax_npz_reads_in_the_port_as_the_f16_rounded_weights(tmp_path, jax_params):
    path = str(tmp_path / "j.npz")
    jax_save_params_npz(path, jax_params)
    ours = ckpt_lib.load_generator_params(path)
    expected = state_dict_from_jax_params(_f16(jax_params))
    for k in expected:
        assert torch.equal(ours[k], expected[k]), k
    model = Generator(num_rrdb=2, channels=16, growth=8)
    model.load_state_dict(ours)
    ckpt_lib.save_params_npz(str(tmp_path / "again.npz"), model.state_dict())
    with np.load(path) as a, np.load(str(tmp_path / "again.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_restore_like_keeps_the_template_order_device_and_dtype(capsys):
    template = {"count": torch.zeros((), dtype=torch.int32),
                "mu": {"b": torch.zeros(2), "a": torch.zeros(3)}}
    saved = {"mu": {"a": torch.ones(3, dtype=torch.float64), "b": torch.ones(2)},
             "count": torch.tensor(5)}
    out = ckpt_lib.restore_like(template, saved, "opt_state")
    assert list(out["mu"]) == ["b", "a"] and out["count"].dtype == torch.int32
    assert int(out["count"]) == 5 and out["mu"]["a"].dtype == torch.float32
    for bad in ({"count": torch.tensor(5), "mu": {"a": torch.ones(3)}},
                {"count": torch.tensor(5), "mu": {"a": torch.ones(4), "b": torch.ones(2)}},
                None):
        with pytest.raises(ValueError, match="does not match"):
            ckpt_lib.restore_like(template, bad, "opt_state")
        assert ckpt_lib.restore_like(template, bad, "opt_state",
                                     on_mismatch="template") is template
    assert "Keeping freshly-initialized opt_state" in capsys.readouterr().out


def test_host_memory_fraction_is_sane_for_this_process():
    assert 0.0 < hostmem.host_memory_fraction() < 0.5


def test_check_host_memory_passes_below_the_watermark():
    hostmem.check_host_memory(0.99)


def test_check_host_memory_exits_restartable_above_the_watermark(monkeypatch, capsys):
    monkeypatch.setattr(hostmem, "host_memory_fraction", lambda: 0.93)
    with pytest.raises(SystemExit) as exc:
        hostmem.check_host_memory(0.8)
    assert exc.value.code == hostmem.RESTART_EXIT_CODE == 4
    assert "FAILSAFE" in capsys.readouterr().out


def test_host_memory_fraction_is_zero_without_proc(monkeypatch):
    def raising_open(*a, **k):
        raise OSError("no /proc")

    monkeypatch.setattr("builtins.open", raising_open)
    assert hostmem.host_memory_fraction() == 0.0


@pytest.fixture()
def tiny(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(run_config, "geometry", PipelineGeometry(hr_size=64, crop_size=32,
                                                                 scale=4))
    monkeypatch.setattr(run_config, "model", ModelConfig(num_rrdb=1, channels=16,
                                                         growth_channels=8))
    monkeypatch.setattr(run_config, "degradation", DegradationConfig(usm_radius=13))

    def configure(**cfg):
        monkeypatch.setattr(run_config, "train_esrnet", TrainConfig(
            **{"batch_size": 2, "print_frequency": 1, "epochs": 1, "num_workers": 2,
               "use_bfloat16": False, **cfg}))
    configure()
    return configure


def _stage1_args(**overrides):
    args = trainer.build_parser().parse_args(
        ["--cpu", "--synthetic", "--epochs", "1", "--batch-size", "2", "--steps-per-epoch", "2",
         "--no-tensorboard"])
    for k, v in overrides.items():
        setattr(args, k, v)
    return args


@pytest.mark.parametrize("async_checkpoint", [True, False])
def test_the_stage1_cli_saves_through_the_async_saver(tiny, monkeypatch, capsys,
                                                      async_checkpoint):
    tiny(async_checkpoint=async_checkpoint)
    saved = []
    real = ckpt_lib.AsyncSaver.save_many
    monkeypatch.setattr(ckpt_lib.AsyncSaver, "save_many",
                        lambda self, items: saved.append(len(items)) or real(self, items))
    trainer.main(_stage1_args(epochs=2))
    out = capsys.readouterr().out
    assert saved == ([1, 1] if async_checkpoint else [])
    assert ("(asynchronously)" in out) == async_checkpoint
    tree = ckpt_lib.load_checkpoint(os.path.join("results", run_config.exp_name, "g_last"))
    assert (tree["step"], tree["epoch"]) == (4, 2)


def test_the_stage1_failsafe_exits_4_with_the_checkpoint_written(tiny, monkeypatch, capsys):
    monkeypatch.setattr(hostmem, "host_memory_fraction", lambda: 0.93)
    with pytest.raises(SystemExit) as exc:
        trainer.main(_stage1_args(epochs=2))
    assert exc.value.code == hostmem.RESTART_EXIT_CODE
    assert "HOST-MEMORY FAILSAFE" in capsys.readouterr().out
    tree = ckpt_lib.load_checkpoint(os.path.join("results", run_config.exp_name, "g_last"))
    assert tree["epoch"] == 1  # the first saving epoch, durable before the exit
