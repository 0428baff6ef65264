"""The trainers on the card at full width: both CLIs through their automatic
resume, one float32 update against the CPU, every ``--loader`` choice and
the grain stream's resume, and the ``.npz`` snapshot of a trained EMA.

The CLIs run in-process at 23 RRDBs, 64 channels, growth 32, batch 48,
hr 400 -> crop 256, bf16 and remat on 96 crops of 400 of
``tests/data/tree_sr.png`` (2 steps an epoch), validated on 3 crops of 300.

Marked ``cuda``: each test skips without a CUDA device.  This file imports
no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_train.py
"""

import math
import os

import numpy as np
import pytest
import torch

from _torch_card import (  # noqa: F401  (cuda is a fixture)
    RDBS_PER_FORWARD, TAIL_PER_FORWARD, TREE, TREE_SR, WEIGHTS, Launches, assert_tail_beside,
    cuda, psnr,
)
from real_esrgan_tpu_torch.configuration import PipelineGeometry
from real_esrgan_tpu_torch.utils.imgio import read_png, write_png

pytestmark = pytest.mark.cuda

GEO = PipelineGeometry(hr_size=400, crop_size=256, scale=4)
TRAIN_BATCH, TRAIN_CROPS, TRAIN_STRIDE = 48, 96, 64
STEPS_PER_EPOCH = TRAIN_CROPS // TRAIN_BATCH
TRAIN_VALID_CORNERS = ((0, 0), (400, 900), (700, 1700))
CARD_CPU_REL = 1e-4
NPZ_PSNR_DB = 40.0
GAN_METRICS = ("pixel", "content", "adversarial", "g_loss", "d_loss", "d_hr_prob", "d_sr_prob",
               "g_grad_norm", "d_grad_norm", "g_rejected", "d_rejected")


def _write_train_data(root) -> tuple:
    """TRAIN_CROPS crops of 400 of the 1024 x 2048 test image, at a stride
    of 64 in row-major order, in ``train/``, and the TRAIN_VALID_CORNERS
    crops of 300 in ``valid/``."""
    tree_sr = read_png(TREE_SR)
    train_dir, valid_dir = os.path.join(root, "train"), os.path.join(root, "valid")
    os.makedirs(train_dir), os.makedirs(valid_dir)
    size = GEO.hr_size
    corners = [(y, x) for y in range(0, tree_sr.shape[0] - size + 1, TRAIN_STRIDE)
               for x in range(0, tree_sr.shape[1] - size + 1, TRAIN_STRIDE)]
    for i, (y, x) in enumerate(corners[:TRAIN_CROPS]):
        write_png(os.path.join(train_dir, f"crop_{i:03d}.png"), tree_sr[y:y + size, x:x + size])
    for i, (y, x) in enumerate(TRAIN_VALID_CORNERS):
        write_png(os.path.join(valid_dir, f"valid_{i}.png"), tree_sr[y:y + 300, x:x + 300])
    return train_dir, valid_dir


def _counting_validation(monkeypatch, trainer) -> list:
    """Patches the trainer's ``validate`` to append (RDB launches, images,
    score, tail launches) of each validation pass to the list it returns."""
    validations, validate = [], trainer.validate

    def counted(*args, **kwargs):
        with Launches() as launched:
            score = validate(*args, **kwargs)
        validations.append((launched.rdb, len(args[2]), score, launched.tail))
        return score
    monkeypatch.setattr(trainer, "validate", counted)
    return validations


def _check_validation_and_steps(validations: list, launched: Launches) -> None:
    """The run's validation passes: 3 images, 69 RDB launches (3 of the tail
    kernel) an image, a finite NIQE; its training steps: no launch of either."""
    assert sum(k for _, k, _, _ in validations) == len(TRAIN_VALID_CORNERS)
    rdb, tail = sum(n for n, _, _, _ in validations), sum(t for _, _, _, t in validations)
    assert rdb == RDBS_PER_FORWARD * len(TRAIN_VALID_CORNERS)
    assert tail * RDBS_PER_FORWARD == TAIL_PER_FORWARD * rdb
    assert launched.rdb == rdb and launched.tail == tail  # none in the training steps
    assert all(math.isfinite(score) for _, _, score, _ in validations)


def test_the_stage1_cli_at_full_width_resumes_on_the_card(cuda, tmp_path, monkeypatch):
    """``--epochs 1``, then ``--epochs 2 --resume auto``: the checkpoint
    reaches step 4, epoch 2, with finite parameters."""
    from real_esrgan_tpu_torch import train_realesrnet as trainer
    from real_esrgan_tpu_torch.train import checkpoint as ckpt_lib

    train_dir, valid_dir = _write_train_data(str(tmp_path))
    validations = _counting_validation(monkeypatch, trainer)
    monkeypatch.chdir(tmp_path)
    for epochs, resume in ((1, []), (2, ["--resume", "auto"])):
        seen = len(validations)
        with Launches() as launched:
            trainer.main(trainer.build_parser().parse_args(
                ["--train-dir", train_dir, "--valid-dir", valid_dir,
                 "--test-lr-dir", str(tmp_path / "none"), "--test-hr-dir", str(tmp_path / "none"),
                 "--batch-size", str(TRAIN_BATCH), "--epochs", str(epochs), "--exp-name", "card",
                 "--no-tensorboard", *resume]))
        _check_validation_and_steps(validations[seen:], launched)
    tree = ckpt_lib.load_checkpoint(str(tmp_path / "results" / "card" / "g_last"))
    assert (tree["step"], tree["epoch"]) == (2 * STEPS_PER_EPOCH, 2)
    assert all(bool(torch.isfinite(v).all()) for v in tree["params"].values())


def test_one_f32_esrnet_update_on_the_card_equals_the_cpu(cuda):
    """One update with the degradation bypassed, 2 RRDBs (64 channels,
    growth 32), f32, TF32 off, on the same parameters and batch (2 LR crops
    of 64) on the card and on the CPU: loss and grad norm within 1e-4
    relative."""
    from real_esrgan_tpu_torch.configuration import ModelConfig, TrainConfig
    from real_esrgan_tpu_torch.train import esrnet

    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    cfg = TrainConfig(use_bfloat16=False, remat_rrdb=False)
    rng = np.random.default_rng(6)
    lr = torch.from_numpy(rng.random((2, 64, 64, 3)).astype(np.float32))
    hr = torch.from_numpy(rng.random((2, 256, 256, 3)).astype(np.float32))
    weights, results = None, {}
    for device in ("cpu", "cuda"):
        model = esrnet.build_generator(ModelConfig(num_rrdb=2), cfg, device,
                                       generator=torch.Generator().manual_seed(5))
        if weights is None:
            weights = model.state_dict()
        model.load_state_dict(weights)
        opt = esrnet.build_optimizer(cfg, 10)
        step = esrnet.make_train_step(model, opt, None, None, None, cfg.ema_decay)
        _, metrics = step.update(esrnet.init_state(model, opt), lr.to(device), hr.to(device))
        results[device] = (float(metrics["loss"]), float(metrics["grad_norm"]))
    (loss_cpu, gn_cpu), (loss, gn) = results["cpu"], results["cuda"]
    assert abs(loss - loss_cpu) <= CARD_CPU_REL * abs(loss_cpu), (loss, loss_cpu)
    assert abs(gn - gn_cpu) <= CARD_CPU_REL * gn_cpu, (gn, gn_cpu)


def test_every_loader_choice_gives_the_same_batches_on_the_card(cuda, tmp_path):
    """Each ``--loader`` choice through ``make_train_loader`` on the 96 crops
    (``native`` only where the C++ loader builds): the loader of its class;
    the first epochs of threads, device and native the same uint8 batches on
    the card, byte for byte, through ``DevicePrefetcher``; the grain
    stream's first batch the CPU stream's; the pool on the card, sending
    only its int64 index vector a step."""
    import dataclasses

    from real_esrgan_tpu_torch.configuration import TrainConfig
    from real_esrgan_tpu_torch.data import dataset, device_pool, grain_loader, native_loader
    from real_esrgan_tpu_torch.data.prefetcher import DevicePrefetcher
    from real_esrgan_tpu_torch.train_realesrnet import make_train_loader

    train_dir, _ = _write_train_data(str(tmp_path))
    cfg = TrainConfig()
    choices = {"threads": (dataclasses.replace(cfg, loader="threads"), dataset.ThreadedLoader),
               "device": (dataclasses.replace(cfg, loader="device"),
                          device_pool.DevicePoolLoader)}
    if native_loader.available():  # auto without the pool's budget: the C++ loader
        choices["native"] = (dataclasses.replace(cfg, loader="auto", device_pool_budget_bytes=0),
                             native_loader.NativeThreadedLoader)
    choices["grain"] = (dataclasses.replace(cfg, loader="grain"), grain_loader.GrainLoader)
    firsts = {}
    for name, (choice, kind) in choices.items():
        ds = dataset.TrainImageDataset(train_dir, GEO.hr_size,
                                       cache_bytes=choice.decoded_cache_bytes)
        loader = make_train_loader(ds, TRAIN_BATCH, choice, GEO, torch.device("cuda"))
        assert type(loader) is kind, (name, type(loader))
        index_before = getattr(loader, "index_bytes", 0)
        pf = DevicePrefetcher(loader, "cuda")
        batches = [b.clone() for b in pf]
        torch.cuda.synchronize()
        h2d = (pf.h2d_bytes + getattr(loader, "index_bytes", 0) - index_before) / len(batches)
        firsts[name] = batches
        if name == "device":
            assert loader.pool.is_cuda and h2d == TRAIN_BATCH * 8
        if name == "grain":
            loader.close()
    for name in ("device", "native"):
        if name in firsts:
            assert len(firsts[name]) == len(firsts["threads"]), name
            assert all(torch.equal(a, b) for a, b in zip(firsts[name], firsts["threads"])), name
    files = sorted(os.path.join(train_dir, f) for f in os.listdir(train_dir))
    cpu_stream = grain_loader.GrainLoader(files, TRAIN_BATCH, GEO.hr_size, num_workers=0,
                                          seed=TrainConfig().seed)
    assert np.array_equal(firsts["grain"][0].cpu().numpy(), next(iter(cpu_stream)))


def test_the_grain_stream_resumes_through_the_stage1_cli_on_the_card(cuda, tmp_path, monkeypatch):
    """``train_realesrnet --loader grain`` at full width, batch 48: --epochs
    1, then --epochs 2 --resume auto.  loader_state_p0.bin is written (epoch
    tag 1, then 2), the second run restores it, and its first batch is batch
    2 of an unbroken stream of the same seed (read on the CPU with no
    workers), not batch 0."""
    from real_esrgan_tpu_torch import train_realesrnet as trainer
    from real_esrgan_tpu_torch.configuration import TrainConfig
    from real_esrgan_tpu_torch.data import grain_loader

    train_dir, _ = _write_train_data(str(tmp_path))
    firsts, restored, state_tags = [], [], []
    prefetcher, restore = trainer.DevicePrefetcher, grain_loader.restore_loader_state

    class Recording(prefetcher):
        def __iter__(self):
            for i, batch in enumerate(super().__iter__()):
                if i == 0:
                    firsts.append(batch.cpu().numpy())
                yield batch

    def recorded(*args, **kwargs):
        restored.append(restore(*args, **kwargs))
        return restored[-1]

    monkeypatch.setattr(trainer, "DevicePrefetcher", Recording)
    monkeypatch.setattr(grain_loader, "restore_loader_state", recorded)
    monkeypatch.chdir(tmp_path)
    for epochs, resume in ((1, []), (2, ["--resume", "auto"])):
        trainer.main(trainer.build_parser().parse_args(
            ["--train-dir", train_dir, "--valid-dir", str(tmp_path / "none"),
             "--test-lr-dir", str(tmp_path / "none"), "--test-hr-dir", str(tmp_path / "none"),
             "--batch-size", str(TRAIN_BATCH), "--epochs", str(epochs), "--exp-name", "grain",
             "--loader", "grain", "--no-tensorboard", *resume]))
        with open(tmp_path / "samples" / "grain" / "loader_state_p0.bin", "rb") as f:
            state_tags.append(int.from_bytes(f.read(8), "little"))
    files = sorted(os.path.join(train_dir, f) for f in os.listdir(train_dir))
    unbroken = grain_loader.GrainLoader(files, TRAIN_BATCH, GEO.hr_size, num_workers=0,
                                        seed=TrainConfig().seed)
    stream = [b.copy() for _ in range(2) for b in unbroken]
    assert state_tags == [1, 2] and restored == [True]
    assert np.array_equal(firsts[0], stream[0]) and np.array_equal(firsts[1], stream[2])
    assert not np.array_equal(firsts[1], stream[0])


def test_the_stage2_cli_at_full_width_resumes_on_the_card(cuda, tmp_path, monkeypatch):
    """The stage-2 CLI, D at 64 channels, warm-started from the committed
    ESRNet weights with the frozen-trunk content backbone: --epochs 1, then
    --epochs 2 --resume-g auto --resume-d auto (resumed at epoch 1).  Every
    step's metrics finite; the asynchronous saver writes g_epoch_1 and
    d_epoch_1, which load back; g_last's EMA as an ``.npz`` snapshot serves
    the test image in bf16 within 40 dB of g_last itself (f16 storage)."""
    from real_esrgan_tpu_torch import train_realesrgan as trainer
    from real_esrgan_tpu_torch.serve import SRPipeline
    from real_esrgan_tpu_torch.train import checkpoint as ckpt_lib

    train_dir, valid_dir = _write_train_data(str(tmp_path))
    validations = _counting_validation(monkeypatch, trainer)
    steps, saved, resumed = [], [], []
    make_step, resume_generator = trainer.make_gan_train_step, trainer.resume_generator
    save_many = ckpt_lib.AsyncSaver.save_many

    def recording(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def run(*a, **k):
            state, metrics = step(*a, **k)
            steps.append({k: float(metrics[k]) for k in GAN_METRICS})
            return state, metrics
        return run

    def resume(*args, **kwargs):
        out = resume_generator(*args, **kwargs)
        resumed.append(out[1])
        return out

    def spy_save(self, items):
        saved.append([os.path.basename(path) for path, _, _ in items])
        return save_many(self, items)

    monkeypatch.setattr(trainer, "make_gan_train_step", recording)
    monkeypatch.setattr(trainer, "resume_generator", resume)
    monkeypatch.setattr(ckpt_lib.AsyncSaver, "save_many", spy_save)
    monkeypatch.chdir(tmp_path)
    for epochs, resume_args in ((1, []), (2, ["--resume-g", "auto", "--resume-d", "auto"])):
        seen, first = len(validations), len(steps)
        with Launches() as launched:
            trainer.main(trainer.build_parser().parse_args(
                ["--train-dir", train_dir, "--valid-dir", valid_dir,
                 "--test-lr-dir", str(tmp_path / "none"), "--test-hr-dir", str(tmp_path / "none"),
                 "--batch-size", str(TRAIN_BATCH), "--epochs", str(epochs), "--exp-name", "gan",
                 "--resume", WEIGHTS, "--content-backbone", "trunk", "--no-tensorboard",
                 *resume_args]))
        _check_validation_and_steps(validations[seen:], launched)
        assert len(steps) - first == STEPS_PER_EPOCH
        assert all(math.isfinite(v) for step in steps[first:] for v in step.values())
    assert resumed[-1] == 1
    assert saved == [["g_epoch_1", "d_epoch_1"], ["g_epoch_2", "d_epoch_2"]]
    samples, results = tmp_path / "samples" / "gan", tmp_path / "results" / "gan"
    epoch_1 = {kind: ckpt_lib.load_checkpoint(str(samples / f"{kind}_epoch_1"))
               for kind in ("g", "d")}
    assert epoch_1["g"]["epoch"] == epoch_1["d"]["epoch"] == 1
    assert epoch_1["g"]["step"] == STEPS_PER_EPOCH
    assert set(epoch_1["d"]["batch_stats"]) and set(epoch_1["g"]["ema_params"])
    g_last = ckpt_lib.load_checkpoint(str(results / "g_last"))
    d_last = ckpt_lib.load_checkpoint(str(results / "d_last"))
    assert g_last["step"] == 2 * STEPS_PER_EPOCH and g_last["epoch"] == d_last["epoch"] == 2
    assert all(bool(torch.isfinite(v).all()) for t in (g_last, d_last)
               for v in t["params"].values())

    npz = str(tmp_path / "g_last_ema.npz")
    ckpt_lib.save_params_npz(npz, ckpt_lib.load_generator_params(str(results / "g_last")))
    image = read_png(TREE).astype(np.float32) / 255.0
    with Launches() as launched:
        outs = [SRPipeline(weights, bfloat16=True, device="cuda").upscale(image)
                for weights in (str(results / "g_last"), npz)]
    assert_tail_beside(launched)
    assert np.isfinite(outs[1]).all() and psnr(outs[1], outs[0]) >= NPZ_PSNR_DB
