"""The port's stage-1 trainer CLI end to end on the CPU (``--cpu``), with a
tiny model and geometry, as tests/test_trainer_main_e2e.py drives the JAX
one: step and epoch counts after a run and after ``--resume auto``, the
checkpoint cadence, ``--exp-name``, missing evaluation directories, and
``--abort-on-storm``; then the validation pass against the JAX trainer's.
"""

import os

import numpy as np
import pytest
import torch

from real_esrgan_tpu_torch import config as run_config
from real_esrgan_tpu_torch import train_realesrnet as trainer
from real_esrgan_tpu_torch.configuration import (
    DegradationConfig, ModelConfig, PipelineGeometry, TrainConfig,
)
from real_esrgan_tpu_torch.train import checkpoint as ckpt_lib
from real_esrgan_tpu_torch.utils.imgio import write_png

TINY_GEO = PipelineGeometry(hr_size=64, crop_size=32, scale=4)
TINY_MODEL = ModelConfig(num_rrdb=1, channels=16, growth_channels=8)
TINY_DEG = DegradationConfig(usm_radius=13)


def _args(**overrides):
    args = trainer.build_parser().parse_args(
        ["--cpu", "--synthetic", "--epochs", "1", "--batch-size", "8", "--steps-per-epoch", "2",
         "--no-tensorboard"])
    for k, v in overrides.items():
        setattr(args, k, v)
    return args


@pytest.fixture()
def tiny(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(run_config, "geometry", TINY_GEO)
    monkeypatch.setattr(run_config, "model", TINY_MODEL)
    monkeypatch.setattr(run_config, "degradation", TINY_DEG)

    def configure(**cfg):
        monkeypatch.setattr(run_config, "train_esrnet", TrainConfig(
            **{"batch_size": 8, "print_frequency": 1, "epochs": 1, "num_workers": 2,
               "use_bfloat16": False, **cfg}))
    configure()
    return configure


def test_main_end_to_end_and_resume_auto(tiny):
    trainer.main(_args())
    last = os.path.join("results", run_config.exp_name, "g_last")
    tree = ckpt_lib.load_checkpoint(last)
    assert (tree["step"], tree["epoch"]) == (2, 1)
    assert int(tree["opt_state"]["count"]) == 2
    assert os.path.exists(os.path.join("results", run_config.exp_name, "g_best"))

    trainer.main(_args(epochs=2, resume="auto"))
    tree = ckpt_lib.load_checkpoint(last)
    assert (tree["step"], tree["epoch"]) == (4, 2)
    assert int(tree["opt_state"]["count"]) == 4
    assert os.path.isdir(os.path.join("samples", run_config.exp_name, "g_epoch_2"))


def test_resume_auto_without_a_checkpoint_starts_fresh(tiny, capsys):
    trainer.main(_args(resume="auto"))
    assert "no checkpoint found, starting fresh" in capsys.readouterr().out


def test_checkpoint_cadence(tiny, monkeypatch):
    """checkpoint_frequency 2 over 3 epochs: epoch 1 is not saved, epochs 2
    (cadence) and 3 (the last) are, and g_last follows every saving epoch."""
    tiny(epochs=3, checkpoint_frequency=2)
    last_copies = []
    real_copy = ckpt_lib.copy_checkpoint

    def spy(src, dst):
        if dst.endswith("g_last"):
            last_copies.append(os.path.basename(src))
        real_copy(src, dst)

    monkeypatch.setattr(ckpt_lib, "copy_checkpoint", spy)
    trainer.main(_args(epochs=3))
    samples = os.path.join("samples", run_config.exp_name)
    assert not os.path.exists(os.path.join(samples, "g_epoch_1"))
    assert os.path.exists(os.path.join(samples, "g_epoch_2"))
    assert last_copies == ["g_epoch_2", "g_epoch_3"]
    assert ckpt_lib.load_checkpoint(os.path.join("results", run_config.exp_name,
                                                 "g_last"))["epoch"] == 3


def test_exp_name_override(tiny):
    trainer.main(_args(exp_name="override_run"))
    assert os.path.exists(os.path.join("results", "override_run", "g_last"))
    assert not os.path.exists(os.path.join("results", run_config.exp_name))


def test_missing_eval_dirs_are_skipped(tiny, tmp_path, capsys):
    rng = np.random.default_rng(11)
    train_dir = tmp_path / "train"
    train_dir.mkdir()
    for i in range(8):
        write_png(str(train_dir / f"im{i}.png"), (rng.random((64, 64, 3)) * 255).astype(np.uint8))
    tiny(num_workers=0, train_image_dir=str(train_dir))
    trainer.main(_args(synthetic=False, valid_dir=str(tmp_path / "no_valid"),
                       test_lr_dir=str(tmp_path / "no_lr"), test_hr_dir=str(tmp_path / "no_hr")))
    out = capsys.readouterr().out
    assert "skipping the per-epoch valid NIQE eval" in out
    assert "skipping the per-epoch test NIQE eval" in out
    for name in ("g_last", "g_best"):
        assert os.path.exists(os.path.join("results", run_config.exp_name, name)), name


def test_abort_on_storm_exits_3(tiny, capsys):
    """A reject limit below every gradient norm rejects every step: once the
    printed windows cover 200 steps (1 + 4 x 50 at print_frequency 50) the
    trailing rejection rate is a storm, and --abort-on-storm exits 3."""
    tiny(grad_reject_limit=1e-12, print_frequency=50)
    with pytest.raises(SystemExit) as exc:
        trainer.main(_args(batch_size=1, steps_per_epoch=202, abort_on_storm=True))
    assert exc.value.code == 3
    out = capsys.readouterr().out
    assert "STORM: training is NOT progressing" in out and "Aborting (rc=3)" in out
    assert not os.path.exists(os.path.join("results", run_config.exp_name, "g_last"))


@pytest.mark.parametrize("loader", ["device", "grain"])
def test_unported_loaders_raise(tiny, loader, capsys):
    """Both loaders are ported now: on --synthetic data ``device`` trains
    from the device-resident pool, and ``grain``, which streams image files,
    refuses a dataset that has none (tests/test_torch_data_cli.py drives both
    on files)."""
    if loader == "grain":
        with pytest.raises(ValueError, match="--loader grain streams image files"):
            trainer.main(_args(loader=loader))
        return
    trainer.main(_args(loader=loader))
    assert "Using device-resident pool loader" in capsys.readouterr().out
    tree = ckpt_lib.load_checkpoint(os.path.join("results", run_config.exp_name, "g_last"))
    assert (tree["step"], tree["epoch"]) == (2, 1)


def test_without_cpu_and_without_cuda_it_raises(tiny):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the trainer runs on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer.main(_args(cpu=False))


def test_validate_matches_the_jax_trainers():
    """The validation pass (bucket padding to 32, the EMA weights' forward,
    NIQE of the cropped output) on the same f32 weights and images as the
    JAX trainer's ``validate``: NIQE within 1e-2 (the NIQE CLIs' bound)."""
    import jax
    import jax.numpy as jnp

    import train_realesrnet as jax_trainer
    from real_esrgan_tpu.configuration import ModelConfig as JaxModelConfig
    from real_esrgan_tpu.configuration import TrainConfig as JaxTrainConfig
    from real_esrgan_tpu.metrics.niqe import NIQE as JaxNIQE
    from real_esrgan_tpu.train import esrnet as jax_esrnet
    from real_esrgan_tpu_torch.metrics.niqe import NIQE
    from real_esrgan_tpu_torch.models.convert import state_dict_from_jax_params
    from real_esrgan_tpu_torch.train import esrnet

    model = jax_esrnet.build_generator(JaxModelConfig(num_rrdb=1, channels=16,
                                                      growth_channels=8),
                                       JaxTrainConfig(use_bfloat16=False))
    params = model.init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3)))["params"]
    rng = np.random.default_rng(4)
    # outputs of 200 x 280 and 256 x 256: NIQE needs at least two 96-pixel
    # blocks; 50 x 70 is padded to 64 x 96 and cropped back
    images = [{"lr": rng.random((50, 70, 3)).astype(np.float32)},
              {"lr": rng.random((64, 64, 3)).astype(np.float32)}]
    ref = jax_trainer.validate(jax_esrnet.make_eval_fn(model), params, images,
                               JaxNIQE(crop_border=4), "Valid", 0)

    eval_model = esrnet.build_generator(TINY_MODEL, TrainConfig(use_bfloat16=False),
                                        training=False)
    sd = state_dict_from_jax_params(jax.device_get(params))
    ours = trainer.validate(esrnet.make_eval_fn(eval_model), sd, images,
                            NIQE(crop_border=4, device="cpu"), "Valid", 0, torch.device("cpu"))
    assert np.isfinite(ours) and abs(ours - ref) <= 1e-2
