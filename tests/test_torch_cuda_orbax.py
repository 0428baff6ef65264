"""The JAX trainers' Orbax directories on the card: both trainers resume the
narrow states onto the card and step.  (``chip_smoke.py`` reads every
fixture against ``leaves.json`` and serves and scores from ``g_c64_b1``.)

Marked ``cuda``: each test skips without a CUDA device.  This file imports
no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_orbax.py
"""

import math
import os

import numpy as np
import pytest
import torch

from _torch_card import ROOT, Launches, assert_tail_beside, cuda  # noqa: F401  (a fixture)
from real_esrgan_tpu_torch.utils.orbax_read import read_pytree

pytestmark = pytest.mark.cuda

ORBAX_DATA = os.path.join(ROOT, "tests", "data", "jax_orbax")
# the narrow runs of tests/_make_orbax_fixtures.py, which wrote the fixtures
ORBAX_NARROW = dict(num_rrdb=1, channels=16, growth_channels=4)
ORBAX_D_CHANNELS = 4
ORBAX_VGG_NODES = ("conv1_2", "conv2_2")
ORBAX_STEPS_PER_EPOCH = 10


def _jax_counts(path: str) -> dict:
    """step, Adam's count and the guard's lr_scale as the JAX trainer saved
    them, read raw (no conversion)."""
    raw = read_pytree(path)
    adam = raw["opt_state"][1][0]
    return {"step": int(raw["step"]) if raw.get("step") is not None else None,
            "count": int(adam["count"]), "lr_scale": float(raw["guard"]["lr_scale"]),
            "rejected_total": int(raw["guard"]["rejected_total"])}


def _batch():
    rng = np.random.default_rng(0)
    lr = torch.from_numpy(rng.random((2, 16, 16, 3), dtype=np.float32)).cuda()
    hr = torch.from_numpy(rng.random((2, 64, 64, 3), dtype=np.float32)).cuda()
    torch.manual_seed(0)
    return lr, hr


def test_stage1_resumes_the_jax_state_on_the_card_and_steps(cuda):
    """The narrow stage-1 state resumed onto the card through
    ``resume_state``: one float32 step, a finite loss, no RDB kernel launch,
    and step, count and lr_scale carry on from the JAX values."""
    from real_esrgan_tpu_torch.configuration import ModelConfig, TrainConfig
    from real_esrgan_tpu_torch.train import esrnet
    from real_esrgan_tpu_torch.train_realesrnet import resume_state

    lr, hr = _batch()
    g_path = os.path.join(ORBAX_DATA, "esrnet_c16", "g_epoch_1")
    jax = _jax_counts(g_path)
    cfg = TrainConfig(use_bfloat16=False, remat_rrdb=False, grad_clip_norm=0.5)
    model = esrnet.build_generator(ModelConfig(**ORBAX_NARROW), cfg, "cuda")
    opt = esrnet.build_optimizer(cfg, ORBAX_STEPS_PER_EPOCH)
    state, _, _ = resume_state(esrnet.init_state(model, opt), g_path, "cuda")
    before = {"step": state.step, "count": int(state.opt_state.count),
              "lr_scale": float(state.guard.lr_scale)}
    step = esrnet.make_train_step(model, opt, None, None, None, cfg.ema_decay,
                                  reject_limit=cfg.grad_reject_limit,
                                  rollback_after=cfg.rollback_after,
                                  reject_mult=cfg.grad_reject_mult)
    with Launches() as launched:
        state, metrics = step.update(state, lr, hr)
    assert launched.rdb == 0
    assert_tail_beside(launched)
    assert math.isfinite(float(metrics["loss"]))
    assert state.params["conv1.weight"].is_cuda
    assert before == {k: jax[k] for k in before}
    assert {"step": state.step, "count": int(state.opt_state.count),
            "lr_scale": float(state.guard.lr_scale),
            "rejected_total": int(state.guard.rejected_total)} == \
        {"step": jax["step"] + 1, "count": jax["count"] + 1, "lr_scale": jax["lr_scale"],
         "rejected_total": jax["rejected_total"]}


def test_stage2_resumes_the_jax_states_on_the_card_and_steps(cuda):
    """The narrow G and D states resumed onto the card through
    ``resume_generator`` and ``resume_discriminator``: one float32 G+D
    step, finite losses, no RDB kernel launch, and step, both counts and
    both lr_scales carry on from the JAX values."""
    from real_esrgan_tpu_torch.configuration import (
        DegradationConfig, GanTrainConfig, ModelConfig,
    )
    from real_esrgan_tpu_torch.models.discriminator import UNetDiscriminator
    from real_esrgan_tpu_torch.models.vgg import VGG19Features
    from real_esrgan_tpu_torch.train import esrgan, esrnet
    from real_esrgan_tpu_torch.train_realesrgan import resume_discriminator, resume_generator

    lr, hr = _batch()
    g_path = os.path.join(ORBAX_DATA, "gan_c16", "g_epoch_1")
    d_path = os.path.join(ORBAX_DATA, "gan_c16", "d_epoch_1")
    jax = {"g": _jax_counts(g_path), "d": _jax_counts(d_path)}
    cfg = GanTrainConfig(use_bfloat16=False, remat_rrdb=False, vgg_nodes=ORBAX_VGG_NODES,
                         content_weights=(0.1, 1.0))
    generator = esrnet.build_generator(ModelConfig(**ORBAX_NARROW), cfg, "cuda")
    discriminator = UNetDiscriminator(channels=ORBAX_D_CHANNELS, dtype=torch.float32,
                                      device="cuda")
    vgg = VGG19Features(ORBAX_VGG_NODES, dtype=torch.float32, device="cuda").requires_grad_(False)
    g_tx, d_tx = esrgan.build_optimizers(cfg, ORBAX_STEPS_PER_EPOCH)
    state = esrgan.init_gan_state(generator, discriminator, g_tx, d_tx)
    state, _, _ = resume_generator(state, g_path)
    state = resume_discriminator(state, d_path)

    def counts(s):
        return {"step": s.step, "g_count": int(s.g_opt.count), "d_count": int(s.d_opt.count),
                "g_lr_scale": float(s.g_guard.lr_scale), "d_lr_scale": float(s.d_guard.lr_scale)}

    expect = {"step": jax["g"]["step"], "g_count": jax["g"]["count"],
              "d_count": jax["d"]["count"], "g_lr_scale": jax["g"]["lr_scale"],
              "d_lr_scale": jax["d"]["lr_scale"]}
    assert counts(state) == expect
    step = esrgan.make_gan_train_step(generator, discriminator, vgg, g_tx, d_tx, None, None,
                                      DegradationConfig(), cfg)
    with Launches() as launched:
        state, metrics = step.update(state, lr, hr)
    assert launched.rdb == 0
    assert_tail_beside(launched)
    assert all(math.isfinite(float(metrics[k])) for k in ("g_loss", "d_loss"))
    assert counts(state) == {**expect, "step": expect["step"] + 1,
                             "g_count": expect["g_count"] + 1, "d_count": expect["d_count"] + 1}
