"""The port's stage-2 trainer CLI end to end on the CPU (``--cpu``), with a
tiny model and geometry: one epoch, then a second through ``--resume-g
auto --resume-d auto``; the refusals (random VGG features without
``--allow-random-vgg``, the trunk backbone without a warm start); the trunk
backbone from a warm start and VGG weights from a torchvision file; and
save -> load -> continue bit-identical to an unbroken run.
"""

import os

import numpy as np
import pytest
import torch

from real_esrgan_tpu_torch import config as run_config
from real_esrgan_tpu_torch import train_realesrgan as trainer
from real_esrgan_tpu_torch.configuration import (
    DegradationConfig, GanTrainConfig, KernelSynthesisConfig, ModelConfig, PipelineGeometry,
)
from real_esrgan_tpu_torch.models.discriminator import SN_LAYERS
from real_esrgan_tpu_torch.models.vgg import TORCHVISION_INDEX
from real_esrgan_tpu_torch.train import checkpoint as ckpt_lib
from real_esrgan_tpu_torch.train import esrgan
from real_esrgan_tpu_torch.utils.imgio import write_png

TINY_GEO = PipelineGeometry(hr_size=64, crop_size=32, scale=4)
TINY_MODEL = ModelConfig(num_rrdb=2, channels=16, growth_channels=8)
TINY_DEG = DegradationConfig(usm_radius=13)
TINY_GAN = dict(batch_size=2, print_frequency=1, epochs=1, num_workers=2, use_bfloat16=False,
                remat_rrdb=False, vgg_nodes=("conv1_2",), content_weights=(1.0,), resume="")


def _args(*extra, **overrides):
    args = trainer.build_parser().parse_args(
        ["--cpu", "--synthetic", "--epochs", "1", "--batch-size", "2", "--steps-per-epoch", "2",
         "--no-tensorboard", *extra])
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
        monkeypatch.setattr(run_config, "train_esrgan", GanTrainConfig(**{**TINY_GAN, **cfg}))
    configure()
    return configure


def _train_dir(tmp_path, n=4):
    rng = np.random.default_rng(11)
    train_dir = tmp_path / "train"
    train_dir.mkdir(exist_ok=True)
    for i in range(n):
        write_png(str(train_dir / f"im{i}.png"), (rng.random((64, 64, 3)) * 255).astype(np.uint8))
    return str(train_dir)


def test_one_epoch_then_a_second_through_auto_resume(tiny, capsys):
    trainer.main(_args())
    exp = run_config.train_esrgan.exp_name
    g = ckpt_lib.load_checkpoint(os.path.join("results", exp, "g_last"))
    d = ckpt_lib.load_checkpoint(os.path.join("results", exp, "d_last"))
    assert (g["step"], g["epoch"], int(g["opt_state"]["count"])) == (2, 1, 2)
    assert d["epoch"] == 1 and int(d["opt_state"]["count"]) == 2
    assert set(d["batch_stats"]) == {f"{n}.{s}" for n, *_ in SN_LAYERS for s in ("u", "sigma")}
    for name in ("g_best", "d_best"):
        assert os.path.isdir(os.path.join("results", exp, name))
    assert "(asynchronously)" in capsys.readouterr().out

    trainer.main(_args("--resume-g", "auto", "--resume-d", "auto", epochs=2))
    out = capsys.readouterr().out
    assert "at epoch 1" in out and "Resumed discriminator" in out and "Epoch: [2]" in out
    assert "Epoch: [1]" not in out
    g2 = ckpt_lib.load_checkpoint(os.path.join("results", exp, "g_last"))
    d2 = ckpt_lib.load_checkpoint(os.path.join("results", exp, "d_last"))
    assert (g2["step"], g2["epoch"], int(g2["opt_state"]["count"])) == (4, 2, 4)
    assert int(d2["opt_state"]["count"]) == 4
    assert not torch.equal(d2["batch_stats"]["down1.u"], d["batch_stats"]["down1.u"])
    for name in ("g_epoch_2", "d_epoch_2"):
        assert os.path.isdir(os.path.join("samples", exp, name))


def test_auto_resume_without_checkpoints_starts_fresh(tiny, capsys):
    trainer.main(_args("--resume-g", "auto", "--resume-d", "auto"))
    out = capsys.readouterr().out
    assert "--resume-g auto: no checkpoint found" in out
    assert "--resume-d auto: no checkpoint found" in out


def test_random_vgg_features_need_the_flag(tiny, tmp_path, capsys):
    tiny(train_image_dir=_train_dir(tmp_path), num_workers=0)
    with pytest.raises(SystemExit, match="--allow-random-vgg"):
        trainer.main(_args(synthetic=False))
    trainer.main(_args("--allow-random-vgg", synthetic=False))
    assert "content loss uses random features" in capsys.readouterr().out


def test_vgg_weights_load_from_a_torchvision_file(tiny, tmp_path, capsys):
    g = torch.Generator().manual_seed(0)
    sd = {"features.0.weight": torch.randn(64, 3, 3, 3, generator=g) * 0.1,
          "features.0.bias": torch.zeros(64),
          "features.2.weight": torch.randn(64, 64, 3, 3, generator=g) * 0.05,
          "features.2.bias": torch.zeros(64)}
    assert TORCHVISION_INDEX[2] == "conv1_2"
    path = str(tmp_path / "vgg19-test.pth")
    torch.save(sd, path)
    tiny(vgg_weights_path=path, train_image_dir=_train_dir(tmp_path), num_workers=0)
    trainer.main(_args(synthetic=False))
    assert f"Loaded VGG19 weights from `{path}`" in capsys.readouterr().out


def test_the_trunk_backbone_needs_a_warm_start(tiny, tmp_path, capsys, monkeypatch):
    tiny(train_image_dir=_train_dir(tmp_path), num_workers=0)
    with pytest.raises(SystemExit, match="needs a stage-1 warm start"):
        trainer.main(_args("--content-backbone", "trunk", synthetic=False))
    with pytest.raises(SystemExit, match="needs a stage-1 warm start"):
        trainer.main(_args("--content-backbone", "trunk", "--resume",
                           str(tmp_path / "missing.npz"), synthetic=False))

    from real_esrgan_tpu_torch.train.esrnet import build_generator
    stage1 = build_generator(TINY_MODEL, run_config.train_esrgan,
                             generator=torch.Generator().manual_seed(5))
    weights = str(tmp_path / "stage1.npz")
    ckpt_lib.save_params_npz(weights, stage1.state_dict())
    seen = {}
    real = esrgan.make_gan_train_step

    def spy(generator, discriminator, backbone, *args):
        seen["backbone"], seen["cfg"] = backbone, args[-1]
        return real(generator, discriminator, backbone, *args)

    monkeypatch.setattr(trainer, "make_gan_train_step", spy)
    trainer.main(_args("--content-backbone", "trunk", "--resume", weights, synthetic=False))
    out = capsys.readouterr().out
    assert "Warm-started generator" in out and "taps (0, 1, 2)" in out
    assert seen["cfg"].content_weights == (1.0, 1.0, 1.0)
    warm = ckpt_lib.load_generator_params(weights)
    for k, v in seen["backbone"].state_dict().items():
        assert torch.equal(v, warm[k]), k
    assert not any(p.requires_grad for p in seen["backbone"].parameters())


def test_without_cpu_and_without_cuda_it_raises(tiny):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the trainer runs on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer.main(_args(cpu=False))


def _fresh(seed):
    cfg = GanTrainConfig(**{**TINY_GAN, "seed": seed})
    generator, discriminator, vgg = esrgan.build_models(TINY_MODEL, cfg)
    g_tx, d_tx = esrgan.build_optimizers(cfg, 3)
    step = esrgan.make_gan_train_step(generator, discriminator, vgg, g_tx, d_tx, TINY_GEO,
                                      KernelSynthesisConfig(), TINY_DEG,
                                      GanTrainConfig(**{**TINY_GAN, "seed": 7}))
    return esrgan.init_gan_state(generator, discriminator, g_tx, d_tx), step


def _run(state, step, batches):
    for hr, (up1, up2) in batches:
        state, _ = step(state, hr, up1, up2)
    return state


def _assert_same(a, b):
    assert a.step == b.step
    for name in ("g_params", "g_ema", "d_params", "d_stats"):
        for k, v in getattr(a, name).items():
            assert torch.equal(v, getattr(b, name)[k]), (name, k)
    for name in ("g_opt", "d_opt"):
        oa, ob = getattr(a, name), getattr(b, name)
        assert torch.equal(oa.count, ob.count)
        for k in oa.mu:
            assert torch.equal(oa.mu[k], ob.mu[k]) and torch.equal(oa.nu[k], ob.nu[k]), k
    for name in ("g_guard", "d_guard"):
        for f in ("reject_streak", "rejected_total", "rollback_total", "accept_streak",
                  "lr_scale", "gnorm_ref"):
            assert torch.equal(getattr(getattr(a, name), f), getattr(getattr(b, name), f)), f


def test_save_load_continue_is_bit_identical_to_an_unbroken_run(tmp_path):
    rng = np.random.default_rng(1)
    batches = list(zip([torch.from_numpy((rng.random((2, 64, 64, 3)) * 255).astype(np.uint8))
                        for _ in range(4)],
                       [(True, False), (False, True), (False, False), (True, True)]))
    unbroken = _run(*_fresh(0), batches)

    half = _run(*_fresh(0), batches[:2])
    g_payload, d_payload = trainer.checkpoint_payloads(half, 1, 42.0)
    ckpt_lib.write_checkpoints([(str(tmp_path / "g_epoch_1"), g_payload, []),
                                (str(tmp_path / "d_epoch_1"), d_payload, [])])
    fresh, step = _fresh(9)  # other initial weights: all must come from the files
    resumed, epoch, best = trainer.resume_generator(fresh, str(tmp_path / "g_epoch_1"))
    resumed = trainer.resume_discriminator(resumed, str(tmp_path / "d_epoch_1"))
    assert (epoch, best, resumed.step) == (1, 42.0, 2)
    _assert_same(_run(resumed, step, batches[2:]), unbroken)
    assert int(unbroken.g_opt.count) == int(unbroken.d_opt.count) == 4


def test_a_mismatched_checkpoint_raises_for_params_and_warns_for_the_optimizer(tmp_path, capsys):
    state, _ = _fresh(0)
    g_payload, d_payload = trainer.checkpoint_payloads(state, 1, 100.0)
    g_payload["opt_state"] = {"count": torch.tensor(3), "mu": {}, "nu": {}}
    d_payload["params"] = {k: v for k, v in d_payload["params"].items() if k != "conv4.bias"}
    ckpt_lib.write_checkpoints([(str(tmp_path / "g"), g_payload, []),
                                (str(tmp_path / "d"), d_payload, [])])
    resumed, _, _ = trainer.resume_generator(_fresh(1)[0], str(tmp_path / "g"))
    assert "opt_state does not match" in capsys.readouterr().out
    assert int(resumed.g_opt.count) == 0
    with pytest.raises(ValueError, match="d_params does not match"):
        trainer.resume_discriminator(state, str(tmp_path / "d"))


def test_the_failsafe_exits_4_with_both_checkpoints_written(tiny, monkeypatch, capsys):
    from real_esrgan_tpu_torch.utils import hostmem

    monkeypatch.setattr(hostmem, "host_memory_fraction", lambda: 0.93)
    with pytest.raises(SystemExit) as exc:
        trainer.main(_args(epochs=2))
    assert exc.value.code == hostmem.RESTART_EXIT_CODE
    assert "HOST-MEMORY FAILSAFE" in capsys.readouterr().out
    exp = run_config.train_esrgan.exp_name
    for name in ("g_last", "d_last"):  # the first saving epoch, durable before the exit
        assert ckpt_lib.load_checkpoint(os.path.join("results", exp, name))["epoch"] == 1
