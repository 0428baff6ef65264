"""A JAX training run carried over to the port through its Orbax
checkpoints, on the CPU in float32.

The JAX package takes one guarded step of a narrow model and saves
``g_epoch_1`` (stage 1; stage 2 also ``d_epoch_1``) as its trainers save
them (``tests/_make_orbax_fixtures.py``; the guard starts at ``lr_scale``
0.5, as after a rollback).  Then JAX resumes the directory and takes a
second step, and the port resumes it through the trainers'
``resume_state`` / ``resume_generator`` / ``resume_discriminator`` and takes
the same second step.

Before the step, exactly: ``step``, ``epoch``, ``best_niqe``, Adam's
``count`` and moments (HWIO -> OIHW), the guard, G's params and EMA, D's
params and spectral state.  After it: the step tests' tolerances,
``UPDATE_BOUND`` of ``test_torch_train_step.py`` (1e-3 of the largest JAX
parameter change) for G's params and EMA; for D the bounds of
``test_torch_gan_step.py`` (at most ``D_SHARE`` of the elements past
``UPDATE_BOUND``, none past 10x); the losses within their ``REL``.
"""

import jax
import numpy as np
import pytest
import torch

import _make_orbax_fixtures as fixtures
from real_esrgan_tpu_torch.configuration import (
    DegradationConfig, GanTrainConfig, ModelConfig, TrainConfig,
)
from real_esrgan_tpu_torch.models.convert import (
    discriminator_params_from_jax, discriminator_state_from_jax, state_dict_from_jax_params,
    vgg_state_from_jax,
)
from real_esrgan_tpu_torch.models.discriminator import UNetDiscriminator
from real_esrgan_tpu_torch.models.vgg import VGG19Features
from real_esrgan_tpu_torch.train import esrgan, esrnet
from real_esrgan_tpu_torch.train.guard import GUARD_FIELDS
from real_esrgan_tpu_torch.train_realesrgan import resume_discriminator, resume_generator
from real_esrgan_tpu_torch.train_realesrnet import resume_state
from test_torch_gan_step import D_SHARE
from test_torch_train_step import REL, UPDATE_BOUND

BATCHES = fixtures.batches(2)


def _host(tree):
    return jax.device_get(tree)


def _assert_equal(ours, theirs, what):
    assert ours.keys() == theirs.keys(), what
    for k in theirs:
        assert torch.equal(ours[k].cpu(), theirs[k]), f"{what}: {k}"


def _assert_guard(ours, jax_guard):
    for field in GUARD_FIELDS:
        theirs = np.asarray(getattr(jax_guard, field))
        mine = getattr(ours, field).cpu().numpy()
        assert mine.dtype == theirs.dtype and mine == theirs, field


def _assert_adam(ours, jax_opt, to_port):
    adam = _host(jax_opt[1][0])
    assert int(ours.count) == int(adam.count) == int(_host(jax_opt[1][1]).count)
    assert ours.count.dtype == torch.int32
    _assert_equal(ours.mu, to_port(adam.mu), "mu")
    _assert_equal(ours.nu, to_port(adam.nu), "nu")


def _change_error(ours, ref, start):
    scale = max(float((ref[k] - start[k]).abs().max()) for k in start)
    return {k: (ours[k] - ref[k]).abs() / scale for k in start}


@pytest.fixture(scope="module")
def esrnet_runs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("esrnet") / "g_epoch_1")
    run, saved = fixtures.write_esrnet(path)
    resumed = run.resume(path)
    after, loss = run.step(resumed, *BATCHES[1])
    return {"path": path, "saved": saved, "after": after, "loss": loss}


def test_stage1_resumes_jax_state_exactly_and_steps_like_jax(esrnet_runs):
    cfg = TrainConfig(**fixtures.ESRNET_TRAIN)
    model = esrnet.build_generator(ModelConfig(**fixtures.NARROW_MODEL), cfg)
    opt = esrnet.build_optimizer(cfg, fixtures.STEPS_PER_EPOCH)
    state, epoch, best = resume_state(esrnet.init_state(model, opt), esrnet_runs["path"], "cpu")

    saved = esrnet_runs["saved"]
    assert (state.step, epoch, best) == (1, 1, fixtures.BEST_NIQE)
    _assert_equal(state.params, state_dict_from_jax_params(_host(saved["params"])), "params")
    _assert_equal(state.ema_params, state_dict_from_jax_params(_host(saved["ema"])), "ema")
    _assert_adam(state.opt_state, saved["opt"], state_dict_from_jax_params)
    _assert_guard(state.guard, saved["guard"])
    assert float(state.guard.lr_scale) == fixtures.START_LR_SCALE

    step = esrnet.make_train_step(model, opt, None, None, None, fixtures.EMA_DECAY,
                                  reject_limit=cfg.grad_reject_limit,
                                  rollback_after=cfg.rollback_after,
                                  reject_mult=cfg.grad_reject_mult)
    start = {k: v.clone() for k, v in state.params.items()}
    lr, hr = BATCHES[1]
    state, metrics = step.update(state, torch.from_numpy(lr), torch.from_numpy(hr))
    after = esrnet_runs["after"]
    assert abs(float(metrics["loss"]) - esrnet_runs["loss"]) <= REL * esrnet_runs["loss"]
    assert state.step == int(after["step"]) == 2
    assert int(state.opt_state.count) == 2
    jax_params = state_dict_from_jax_params(_host(after["params"]))
    jax_ema = state_dict_from_jax_params(_host(after["ema"]))
    err = max(float(e.max()) for e in _change_error(state.params, jax_params, start).values())
    ema_err = max(float(e.max()) for e in
                  _change_error(state.ema_params, jax_ema, start).values())
    print(f"stage 1, second step: params {err:.3g}, EMA {ema_err:.3g} of the largest change")
    assert max(err, ema_err) <= UPDATE_BOUND
    for field in ("accept_streak", "lr_scale"):
        assert float(getattr(state.guard, field)) == float(getattr(after["guard"], field))


@pytest.fixture(scope="module")
def gan_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("gan")
    g_path, d_path = str(root / "g_epoch_1"), str(root / "d_epoch_1")
    run, saved = fixtures.write_gan(g_path, d_path)
    resumed = run.resume(g_path, d_path)
    after, metrics = run.step(resumed, *BATCHES[1])
    return {"g": g_path, "d": d_path, "saved": saved, "after": after, "metrics": metrics,
            "vgg": vgg_state_from_jax(_host(run.vgg_params))}


def test_stage2_resumes_jax_state_exactly_and_steps_like_jax(gan_runs):
    cfg = GanTrainConfig(**fixtures.GAN_TRAIN)
    generator = esrnet.build_generator(ModelConfig(**fixtures.NARROW_MODEL), cfg)
    discriminator = UNetDiscriminator(channels=fixtures.D_CHANNELS, dtype=torch.float32)
    vgg = VGG19Features(fixtures.VGG_NODES, dtype=torch.float32).requires_grad_(False)
    vgg.load_state_dict(gan_runs["vgg"])
    g_tx, d_tx = esrgan.build_optimizers(cfg, fixtures.STEPS_PER_EPOCH)
    state = esrgan.init_gan_state(generator, discriminator, g_tx, d_tx)
    state, epoch, best = resume_generator(state, gan_runs["g"])
    state = resume_discriminator(state, gan_runs["d"])

    saved = gan_runs["saved"]
    assert (state.step, epoch, best) == (1, 1, fixtures.BEST_NIQE)
    _assert_equal(state.g_params, state_dict_from_jax_params(_host(saved.g_params)), "g")
    _assert_equal(state.g_ema, state_dict_from_jax_params(_host(saved.g_ema)), "g_ema")
    d_params, d_stats = discriminator_state_from_jax(_host(saved.d_params), _host(saved.d_stats))
    _assert_equal(state.d_params, d_params, "d")
    _assert_equal(state.d_stats, d_stats, "d_stats")
    _assert_adam(state.g_opt, saved.g_opt, state_dict_from_jax_params)
    _assert_adam(state.d_opt, saved.d_opt, discriminator_params_from_jax)
    _assert_guard(state.g_guard, saved.g_guard)
    _assert_guard(state.d_guard, saved.d_guard)

    step = esrgan.make_gan_train_step(generator, discriminator, vgg, g_tx, d_tx, None, None,
                                      DegradationConfig(), cfg)
    g_start = {k: v.clone() for k, v in state.g_params.items()}
    d_start = {k: v.clone() for k, v in state.d_params.items()}
    lr, hr = BATCHES[1]
    state, metrics = step.update(state, torch.from_numpy(lr), torch.from_numpy(hr))
    for name in ("g_loss", "d_loss"):
        theirs = gan_runs["metrics"][name]
        assert abs(float(metrics[name]) - theirs) <= REL * abs(theirs), name
    after = gan_runs["after"]
    assert state.step == int(after.step) == 2
    assert int(state.g_opt.count) == int(state.d_opt.count) == 2
    g_err = max(float(e.max()) for e in _change_error(
        state.g_params, state_dict_from_jax_params(_host(after.g_params)), g_start).values())
    ema_err = max(float(e.max()) for e in _change_error(
        state.g_ema, state_dict_from_jax_params(_host(after.g_ema)), g_start).values())
    d_jax, _ = discriminator_state_from_jax(_host(after.d_params), _host(after.d_stats))
    d_err = torch.cat([e.reshape(-1) for e in
                       _change_error(state.d_params, d_jax, d_start).values()])
    off = float((d_err > UPDATE_BOUND).double().mean())
    print(f"stage 2, second step: G {g_err:.3g}, EMA {ema_err:.3g}; "
          f"D worst {float(d_err.max()):.3g}, "
          f"{off:.3g} of it past {UPDATE_BOUND}")
    assert max(g_err, ema_err) <= UPDATE_BOUND
    assert off <= D_SHARE and float(d_err.max()) <= 10 * UPDATE_BOUND


def test_the_committed_fixtures_resume(tmp_path):
    """The fixtures test_torch_cuda_orbax.py resumes on the card, here on the CPU:
    step, count and lr_scale carry on from the JAX values."""
    cfg = TrainConfig(**fixtures.ESRNET_TRAIN)
    model = esrnet.build_generator(ModelConfig(**fixtures.NARROW_MODEL), cfg)
    opt = esrnet.build_optimizer(cfg, fixtures.STEPS_PER_EPOCH)
    path = f"{fixtures.DATA}/esrnet_c16/g_epoch_1"
    state, epoch, _ = resume_state(esrnet.init_state(model, opt), path, "cpu")
    assert (state.step, epoch, int(state.opt_state.count)) == (1, 1, 1)
    assert float(state.guard.lr_scale) == fixtures.START_LR_SCALE
    gan = GanTrainConfig(**fixtures.GAN_TRAIN)
    g_tx, d_tx = esrgan.build_optimizers(gan, fixtures.STEPS_PER_EPOCH)
    state = esrgan.init_gan_state(
        esrnet.build_generator(ModelConfig(**fixtures.NARROW_MODEL), gan),
        UNetDiscriminator(channels=fixtures.D_CHANNELS, dtype=torch.float32), g_tx, d_tx)
    state, epoch, _ = resume_generator(state, f"{fixtures.DATA}/gan_c16/g_epoch_1")
    state = resume_discriminator(state, f"{fixtures.DATA}/gan_c16/d_epoch_1")
    assert (state.step, epoch, int(state.g_opt.count), int(state.d_opt.count)) == (1, 1, 1, 1)
    assert float(state.d_guard.lr_scale) == fixtures.START_LR_SCALE
