"""The port's training checkpoints on the CPU: save, load and continue is
bit-identical to an unbroken run; ``find_latest_checkpoint``, the
crash-safe copy, ``merge_matching`` and ``load_generator_params`` on a
checkpoint directory.
"""

import os

import numpy as np
import pytest
import torch

from real_esrgan_tpu_torch.configuration import (
    DegradationConfig, KernelSynthesisConfig, ModelConfig, PipelineGeometry, TrainConfig,
)
from real_esrgan_tpu_torch.train import checkpoint as ckpt_lib
from real_esrgan_tpu_torch.train import esrnet
from real_esrgan_tpu_torch.train_realesrnet import checkpoint_payload, resume_state

MODEL = ModelConfig(num_rrdb=1, channels=16, growth_channels=8)
GEO = PipelineGeometry(hr_size=64, crop_size=32, scale=4)
CFG = TrainConfig(use_bfloat16=False, remat_rrdb=False)


def _fresh(seed=0):
    model = esrnet.build_generator(MODEL, CFG, generator=torch.Generator().manual_seed(seed))
    opt = esrnet.build_optimizer(CFG, 3)
    step = esrnet.make_train_step(model, opt, GEO, KernelSynthesisConfig(),
                                  DegradationConfig(usm_radius=13), 0.9, seed=7)
    return esrnet.init_state(model, opt), step


def _batches():
    rng = np.random.default_rng(1)
    hr = [torch.from_numpy((rng.random((2, 64, 64, 3)) * 255).astype(np.uint8))
          for _ in range(4)]
    coins = [(True, False), (False, True), (False, False), (True, True)]
    return list(zip(hr, coins))


def _run(state, step, batches):
    """Full steps: the degradation drawn from (seed + 1, step), then the update."""
    for hr, (up1, up2) in batches:
        state, _ = step(state, hr, up1, up2)
    return state


def _assert_same(a, b):
    assert a.step == b.step
    for name in ("params", "ema_params"):
        for k, v in getattr(a, name).items():
            assert torch.equal(v, getattr(b, name)[k]), (name, k)
    assert torch.equal(a.opt_state.count, b.opt_state.count)
    for k in a.opt_state.mu:
        assert torch.equal(a.opt_state.mu[k], b.opt_state.mu[k]), k
        assert torch.equal(a.opt_state.nu[k], b.opt_state.nu[k]), k
    for f in ("reject_streak", "rejected_total", "rollback_total", "accept_streak", "lr_scale",
              "gnorm_ref"):
        assert torch.equal(getattr(a.guard, f), getattr(b.guard, f)), f


def test_save_load_continue_is_bit_identical_to_an_unbroken_run(tmp_path):
    batches = _batches()
    state, step = _fresh()
    unbroken = _run(state, step, batches)

    state, step = _fresh()
    half = _run(state, step, batches[:2])
    path = str(tmp_path / "g_epoch_1")
    ckpt_lib.save_checkpoint(path, checkpoint_payload(half, 1, 42.0))
    fresh, step = _fresh(seed=9)  # other initial weights: all must come from the file
    resumed, epoch, best = resume_state(fresh, path, torch.device("cpu"))
    assert (epoch, best, resumed.step) == (1, 42.0, 2)
    _assert_same(_run(resumed, step, batches[2:]), unbroken)
    assert int(unbroken.opt_state.count) == 4


def test_resume_keeps_the_guard_and_a_count_behind_the_step(tmp_path):
    cfg_batches = _batches()
    state, step = _fresh()
    state = _run(state, step, cfg_batches[:2])
    state.guard.rejected_total = torch.tensor(3, dtype=torch.int32)
    state.guard.lr_scale = torch.tensor(0.25)
    state.opt_state.count = torch.tensor(1, dtype=torch.int32)
    path = str(tmp_path / "ckpt")
    ckpt_lib.save_checkpoint(path, checkpoint_payload(state, 5, 10.0))
    resumed, _, _ = resume_state(_fresh(seed=3)[0], path, torch.device("cpu"))
    _assert_same(resumed, state)


def test_checkpoint_loads_with_weights_only(tmp_path):
    state, _ = _fresh()
    path = str(tmp_path / "c")
    ckpt_lib.save_checkpoint(path, checkpoint_payload(state, 1, 100.0))
    tree = torch.load(os.path.join(path, ckpt_lib.CHECKPOINT_FILE), weights_only=True)
    assert set(tree) == {"epoch", "best_niqe", "step", "params", "ema_params", "opt_state",
                         "guard"}
    assert os.listdir(path) == [ckpt_lib.CHECKPOINT_FILE]


def test_a_mismatched_optimizer_state_is_replaced_with_a_warning(tmp_path, capsys):
    state, _ = _fresh()
    payload = checkpoint_payload(state, 1, 100.0)
    payload["opt_state"] = {"count": torch.tensor(3), "mu": {}, "nu": {}}
    ckpt_lib.save_checkpoint(str(tmp_path / "c"), payload)
    resumed, _, _ = resume_state(_fresh()[0], str(tmp_path / "c"), torch.device("cpu"))
    assert "does not match" in capsys.readouterr().out
    assert int(resumed.opt_state.count) == 0


def test_find_latest_checkpoint(tmp_path):
    assert ckpt_lib.find_latest_checkpoint(str(tmp_path / "missing")) == ""
    for name in ("g_epoch_2", "g_epoch_10", "g_epoch_x", "d_epoch_30"):
        (tmp_path / name).mkdir()
    (tmp_path / "g_epoch_11").write_text("a file, not a checkpoint")
    assert ckpt_lib.find_latest_checkpoint(str(tmp_path)) == str(tmp_path / "g_epoch_10")
    assert ckpt_lib.find_latest_checkpoint(str(tmp_path), "d_epoch_") == str(tmp_path /
                                                                              "d_epoch_30")


def test_copy_checkpoint_is_crash_safe(tmp_path):
    src, dst = tmp_path / "src", tmp_path / "dst"
    src.mkdir()
    (src / "f").write_text("new")
    dst.mkdir()
    (dst / "f").write_text("old")
    (tmp_path / "dst.tmp").mkdir()   # stale siblings of an interrupted copy
    (tmp_path / "dst.old").mkdir()
    ckpt_lib.copy_checkpoint(str(src), str(dst))
    assert (dst / "f").read_text() == "new"
    assert sorted(os.listdir(tmp_path)) == ["dst", "src"]
    ckpt_lib.copy_checkpoint(str(src), str(tmp_path / "fresh"))
    assert (tmp_path / "fresh" / "f").read_text() == "new"


def test_merge_matching():
    params = {"a": torch.zeros(2), "b": torch.zeros(3), "c": torch.zeros(1)}
    loaded = {"a": torch.ones(2), "b": torch.ones(4), "d": torch.ones(1)}
    merged = ckpt_lib.merge_matching(params, loaded)
    assert torch.equal(merged["a"], torch.ones(2))
    assert torch.equal(merged["b"], torch.zeros(3)) and torch.equal(merged["c"], torch.zeros(1))
    assert set(merged) == {"a", "b", "c"}


def test_load_generator_params_reads_a_checkpoint_directory(tmp_path):
    state, _ = _fresh()
    state.ema_params = {k: v + 1.0 for k, v in state.params.items()}
    path = str(tmp_path / "g_best")
    ckpt_lib.save_checkpoint(path, checkpoint_payload(state, 1, 100.0))
    ema = ckpt_lib.load_generator_params(path)
    raw = ckpt_lib.load_generator_params(path, prefer_ema=False)
    for k in state.params:
        assert torch.equal(ema[k], state.ema_params[k]) and torch.equal(raw[k], state.params[k])
    model = esrnet.build_generator(MODEL, CFG, training=False)
    model.load_state_dict(ema)
    (tmp_path / "orbax").mkdir()  # empty: neither kind of checkpoint directory
    with pytest.raises(ValueError, match="nor an Orbax checkpoint directory"):
        ckpt_lib.load_generator_params(str(tmp_path / "orbax"))
    # the JAX trainer's Orbax g_epoch_1: EMA and params as saved, both OIHW
    jax_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jax_orbax",
                           "esrnet_c16", "g_epoch_1")
    tree = ckpt_lib.load_checkpoint(jax_dir)
    ema = ckpt_lib.load_generator_params(jax_dir)
    raw = ckpt_lib.load_generator_params(jax_dir, prefer_ema=False)
    assert ema.keys() == raw.keys() == tree["params"].keys()
    for k in ema:
        assert torch.equal(ema[k], tree["ema_params"][k]) and torch.equal(raw[k], tree["params"][k])
    assert ema["conv1.weight"].shape == (16, 3, 3, 3)
