"""Both trainer CLIs on the CPU (``--cpu``) with each ``--loader`` choice of
the JAX CLI, ``auto`` (with and without the device pool's budget),
``device``, ``threads`` and ``grain``: a 2-step run on a directory of PNGs
prints the loader it took and trains; with ``grain``, ``--epochs 1`` then
``--epochs 2`` through resume writes ``loader_state_p0.bin``, restores it,
and the resumed run's first batch is the unbroken stream's.
"""

import os

import numpy as np
import pytest

from real_esrgan_tpu_torch import config as run_config
from real_esrgan_tpu_torch import train_realesrgan, train_realesrnet
from real_esrgan_tpu_torch.configuration import (
    DegradationConfig, GanTrainConfig, ModelConfig, PipelineGeometry, TrainConfig,
)
from real_esrgan_tpu_torch.data import grain_loader, native_loader
from real_esrgan_tpu_torch.train import checkpoint as ckpt_lib
from real_esrgan_tpu_torch.utils.imgio import write_png

HR = 64
SMALL = dict(batch_size=2, print_frequency=1, epochs=1, num_workers=2, use_bfloat16=False,
             remat_rrdb=False)
GAN = dict(vgg_nodes=("conv1_2",), content_weights=(1.0,), resume="")
# (--loader, device pool budget) -> the line the CLI prints
LOADER_LINES = {("auto", None): "Using device-resident pool loader",
                ("auto", 0): "Using native C++ data loader",
                ("device", None): "Using device-resident pool loader",
                ("threads", None): "Using Python threaded loader",
                ("grain", None): "Using grain-contract stream loader"}


@pytest.fixture()
def tiny(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(run_config, "geometry", PipelineGeometry(hr_size=HR, crop_size=32,
                                                                 scale=4))
    monkeypatch.setattr(run_config, "model", ModelConfig(num_rrdb=1, channels=16,
                                                         growth_channels=8))
    monkeypatch.setattr(run_config, "degradation", DegradationConfig(usm_radius=13))
    rng = np.random.default_rng(17)
    train_dir = tmp_path / "train"
    train_dir.mkdir()
    for i in range(4):
        write_png(str(train_dir / f"im{i}.png"), (rng.random((HR, HR, 3)) * 255).astype(np.uint8))

    def configure(**cfg):
        monkeypatch.setattr(run_config, "train_esrnet", TrainConfig(**{**SMALL, **cfg}))
        monkeypatch.setattr(run_config, "train_esrgan", GanTrainConfig(**{**SMALL, **GAN,
                                                                         **cfg}))
    configure()
    return str(train_dir), configure


def run(cli, train_dir, loader, *extra):
    trainer = {"esrnet": train_realesrnet, "esrgan": train_realesrgan}[cli]
    flags = ["--cpu", "--train-dir", train_dir, "--valid-dir", "none", "--test-lr-dir", "none",
             "--test-hr-dir", "none", "--no-tensorboard", "--loader", loader, *extra]
    if cli == "esrgan":
        flags.append("--allow-random-vgg")
    trainer.main(trainer.build_parser().parse_args(flags))


@pytest.mark.parametrize("cli", ["esrnet", "esrgan"])
@pytest.mark.parametrize("loader, budget", list(LOADER_LINES))
def test_each_loader_trains_two_steps(tiny, capsys, cli, loader, budget):
    train_dir, configure = tiny
    if budget is not None:
        configure(device_pool_budget_bytes=budget)
        if not native_loader.available():
            pytest.skip(f"native loader does not build here: "
                        f"{native_loader.unavailable_reason()}")
    run(cli, train_dir, loader, "--epochs", "1")
    out = capsys.readouterr().out
    assert LOADER_LINES[(loader, budget)] in out
    assert "2 steps/epoch" in out
    exp = (run_config.train_esrnet if cli == "esrnet" else run_config.train_esrgan).exp_name
    tree = ckpt_lib.load_checkpoint(os.path.join("results", exp, "g_last"))
    assert (tree["step"], tree["epoch"]) == (2, 1)
    state_file = os.path.join("samples", exp, "loader_state_p0.bin")
    assert os.path.exists(state_file) == (loader == "grain")


@pytest.mark.parametrize("cli", ["esrnet", "esrgan"])
def test_grain_resume_continues_the_stream(tiny, capsys, monkeypatch, cli):
    train_dir, _ = tiny
    trainer = {"esrnet": train_realesrnet, "esrgan": train_realesrgan}[cli]
    first_batches = []
    prefetcher = trainer.DevicePrefetcher

    class Recording(prefetcher):
        def __iter__(self):
            for i, batch in enumerate(super().__iter__()):
                if i == 0:
                    first_batches.append(batch.numpy().copy())
                yield batch

    monkeypatch.setattr(trainer, "DevicePrefetcher", Recording)
    resume = ["--resume", "auto"] if cli == "esrnet" else ["--resume-g", "auto",
                                                          "--resume-d", "auto"]
    run(cli, train_dir, "grain", "--epochs", "1")
    exp = (run_config.train_esrnet if cli == "esrnet" else run_config.train_esrgan).exp_name
    state_file = os.path.join("samples", exp, "loader_state_p0.bin")
    with open(state_file, "rb") as f:
        assert int.from_bytes(f.read(8), "little") == 1
    run(cli, train_dir, "grain", "--epochs", "2", *resume)
    assert "Restored data-loader stream position." in capsys.readouterr().out

    files = sorted(os.path.join(train_dir, f) for f in os.listdir(train_dir))
    unbroken = grain_loader.GrainLoader(files, 2, HR, num_workers=0, seed=TrainConfig().seed)
    stream = [b.copy() for _ in range(2) for b in unbroken]
    assert len(first_batches) == 2
    assert np.array_equal(first_batches[0], stream[0])
    assert np.array_equal(first_batches[1], stream[2])  # epoch 2 starts at batch 2
    assert not np.array_equal(stream[2], stream[0])
