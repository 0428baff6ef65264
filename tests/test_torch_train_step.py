"""The port's stage-1 training step against the JAX package's on the CPU.

Small size: 2 RRDBs, 16 channels, growth 8, LR 16x16 -> HR 64x64, batch 2,
float32, with the JAX params carried across by ``state_dict_from_jax_params``
and the degradation bypassed: each step gets its own numpy batch (HR scaled
by 0.5, 1.0, 1.5, so the gradients differ from step to step).  The JAX side
is ``jax.value_and_grad(loss_fn)`` + ``guarded_update`` + ``build_optimizer``;
the port's is ``make_train_step(...).update``.  ``grad_clip_norm`` is 0.5,
under the gradient norms here (0.73-0.80), so the clip is at work.

Bounds, after each of three steps: loss and pre-clip gradient norm within
1e-5 relative (the two frameworks sum in other orders: 2e-6 measured).
Parameters and EMA after the three steps: within ``UPDATE_BOUND`` = 1e-3 of
the largest JAX parameter change from the start.  The parameters agree to
1.2e-5 of it (float32 sums in another order, which Adam's division by
sqrt(nu) carries into every element); the smallest of the optimizer mutants
run below, beta2 = 0.999 instead of 0.99, moves them by 6.5e-3 of it, the
others by 0.1-0.9, so 1e-3 holds the port and fails every mutant.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from real_esrgan_tpu.configuration import ModelConfig as JaxModelConfig
from real_esrgan_tpu.configuration import TrainConfig as JaxTrainConfig
from real_esrgan_tpu.train import esrnet as jax_esrnet
from real_esrgan_tpu.train.guard import guard_init as jax_guard_init
from real_esrgan_tpu.train.guard import guarded_update as jax_guarded_update
from real_esrgan_tpu_torch.configuration import ModelConfig, TrainConfig
from real_esrgan_tpu_torch.models.convert import state_dict_from_jax_params
from real_esrgan_tpu_torch.models.rrdbnet import ResidualDenseBlock
from real_esrgan_tpu_torch.train import esrnet
from real_esrgan_tpu_torch.train.optim import AdamState, ClippedAdam, clip_by_global_norm

MODEL = dict(num_rrdb=2, channels=16, growth_channels=8)
TRAIN = dict(use_bfloat16=False, remat_rrdb=False, grad_clip_norm=0.5)
STEPS_PER_EPOCH = 10
EMA_DECAY = 0.999
REL = 1e-5
UPDATE_BOUND = 1e-3


def _batches(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.random((2, 16, 16, 3)).astype(np.float32),
             (rng.random((2, 64, 64, 3)) * (0.5 + 0.5 * i)).astype(np.float32))
            for i in range(n)]


def _jax_model(**train):
    cfg = JaxTrainConfig(**{**TRAIN, **train})
    return jax_esrnet.build_generator(JaxModelConfig(**MODEL), cfg), cfg


@pytest.fixture(scope="module")
def jax_run():
    """Three guarded JAX steps: the start, then (loss, grad norm) a step and
    the final params and EMA, all as port state_dicts."""
    model, cfg = _jax_model()
    tx = jax_esrnet.build_optimizer(cfg, STEPS_PER_EPOCH)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"]
    train_model = jax_esrnet.train_forward_model(model, "none")

    def loss_fn(p, lr, hr):
        return jnp.mean(jnp.abs(train_model.apply({"params": p}, lr) - hr))

    p, ema, opt, guard = params, jax.tree_util.tree_map(jnp.copy, params), tx.init(params), \
        jax_guard_init()
    metrics = []
    for lr, hr in _batches():
        loss, grads = jax.value_and_grad(loss_fn)(p, lr, hr)
        p, ema, opt, guard, info = jax_guarded_update(
            tx, grads, opt, p, ema, guard, reject_limit=cfg.grad_reject_limit,
            rollback_after=cfg.rollback_after, ema_decay=EMA_DECAY,
            reject_mult=cfg.grad_reject_mult)
        metrics.append((float(loss), float(info["grad_norm"])))
        assert float(info["rejected"]) == 0.0
    sd = lambda tree: state_dict_from_jax_params(jax.device_get(tree))  # noqa: E731
    return {"start": sd(params), "metrics": metrics, "params": sd(p), "ema": sd(ema),
            "count": int(opt[1][0].count)}


def _port_run(start, opt=None, **train):
    cfg = TrainConfig(**{**TRAIN, **train})
    model = esrnet.build_generator(ModelConfig(**MODEL), cfg)
    model.load_state_dict(start)
    opt = opt or esrnet.build_optimizer(cfg, STEPS_PER_EPOCH)
    state = esrnet.init_state(model, opt)
    step = esrnet.make_train_step(model, opt, None, None, None, EMA_DECAY,
                                  reject_limit=cfg.grad_reject_limit,
                                  rollback_after=cfg.rollback_after,
                                  reject_mult=cfg.grad_reject_mult)
    metrics = []
    for lr, hr in _batches():
        state, m = step.update(state, torch.from_numpy(lr), torch.from_numpy(hr))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return state, metrics


def _update_error(ours, ref, start, scale_ref=None):
    """Largest |our change - JAX's change| over the largest JAX change of
    ``scale_ref`` (default ``ref``) from ``start``."""
    scale_ref = ref if scale_ref is None else scale_ref
    scale = max(float((scale_ref[k] - start[k]).abs().max()) for k in start)
    return max(float((ours[k] - ref[k]).abs().max()) for k in start) / scale


def test_three_guarded_updates_match_jax(jax_run):
    state, metrics = _port_run(jax_run["start"])
    for (loss, gnorm), (jloss, jgnorm) in zip(metrics, jax_run["metrics"]):
        print(f"loss rel {abs(loss - jloss) / jloss:.3g}, grad norm rel "
              f"{abs(gnorm - jgnorm) / jgnorm:.3g}")
        assert abs(loss - jloss) <= REL * abs(jloss)
        assert abs(gnorm - jgnorm) <= REL * jgnorm
        assert gnorm > TRAIN["grad_clip_norm"]  # the clip is at work
    # the EMA moves by about 0.003 of the parameters' change in three steps,
    # so it is held on the parameters' scale, where its float32 rounding
    # (an ulp of its values) does not count as a change
    errors = [_update_error(getattr(state, name), jax_run[ref], jax_run["start"],
                            jax_run["params"])
              for name, ref in (("params", "params"), ("ema_params", "ema"))]
    print(f"params and EMA error {errors[0]:.3g}, {errors[1]:.3g} of the largest parameter "
          "change")
    assert max(errors) <= UPDATE_BOUND
    assert int(state.opt_state.count) == jax_run["count"] == 3
    assert state.step == 3


class _NoBiasCorrection(ClippedAdam):
    """Adam without the bias correction: a mutant."""

    def update(self, grads, state, norm=None):
        keys = list(state.mu)
        g = clip_by_global_norm([grads[k] for k in keys], self.clip_norm, norm)
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - self.b1),
                                torch._foreach_mul([state.mu[k] for k in keys], self.b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - self.b2),
                                torch._foreach_mul([state.nu[k] for k in keys], self.b2))
        u = torch._foreach_div(mu, torch._foreach_add(torch._foreach_sqrt(nu), self.eps))
        u = torch._foreach_mul(u, -1 * self.schedule(state.count))
        return dict(zip(keys, u)), AdamState(state.count + 1, dict(zip(keys, mu)),
                                             dict(zip(keys, nu)))


def _mutant(name):
    base = esrnet.build_optimizer(TrainConfig(**TRAIN), STEPS_PER_EPOCH)
    args = dict(b1=0.9, b2=0.99, eps=1e-8, clip_norm=TRAIN["grad_clip_norm"])
    if name == "beta2=0.999":
        args["b2"] = 0.999
    elif name == "eps=1e-7":
        args["eps"] = 1e-7
    elif name == "no clip":
        args["clip_norm"] = 0.0
    elif name == "no bias correction":
        return _NoBiasCorrection(base.schedule, **args)
    return ClippedAdam(base.schedule, **args)


@pytest.mark.parametrize("name", ["beta2=0.999", "eps=1e-7", "no bias correction", "no clip"])
def test_the_bound_fails_an_optimizer_mutant(jax_run, name):
    state, _ = _port_run(jax_run["start"], opt=_mutant(name))
    error = _update_error(state.params, jax_run["params"], jax_run["start"])
    print(f"{name}: change error {error:.3g} of the largest")
    assert error > UPDATE_BOUND


def _grads_of(loss, params):
    return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


@pytest.mark.parametrize("mode", ["none", "st", "hard"])
def test_clamp_modes_match_train_forward_model(mode):
    """The loss and its gradients under each training clamp, on inputs that
    push a fair share of the output outside [0, 1]."""
    model, _ = _jax_model()
    params = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3)))["params"]
    rng = np.random.default_rng(5)
    lr = (rng.random((2, 16, 16, 3)) * 6.0 - 3.0).astype(np.float32)
    hr = rng.random((2, 64, 64, 3)).astype(np.float32)
    jm = jax_esrnet.train_forward_model(model, mode)
    out = np.asarray(jm.apply({"params": params}, lr))
    if mode == "none":
        assert ((out < 0) | (out > 1)).mean() > 0.05

    def loss_fn(p):
        return jnp.mean(jnp.abs(jm.apply({"params": p}, lr) - hr))
    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    jgrads = state_dict_from_jax_params(jax.device_get(jgrads))

    pm = esrnet.build_generator(ModelConfig(**MODEL), TrainConfig(**TRAIN))
    pm.load_state_dict(state_dict_from_jax_params(jax.device_get(params)))
    loss, grads = _port_loss_and_grads(pm, lr, hr, mode)
    assert abs(float(loss) - float(jloss)) <= REL * float(jloss)
    scale = max(float(g.abs().max()) for g in jgrads.values())
    assert max(float((grads[k] - jgrads[k]).abs().max()) for k in grads) <= 1e-4 * scale
    with pytest.raises(ValueError, match="none|st|hard"):
        esrnet.train_forward_model(pm, "soft")


def _loss_and_grads(model, seed=3):
    rng = np.random.default_rng(seed)
    lr = torch.from_numpy(rng.random((2, 16, 16, 3)).astype(np.float32))
    hr = torch.from_numpy(rng.random((2, 64, 64, 3)).astype(np.float32))
    params = dict(model.named_parameters())
    loss = torch.mean(torch.abs(model(lr) - hr))
    return loss, _grads_of(loss, params)


def test_remat_gives_the_same_gradients():
    plain = esrnet.build_generator(ModelConfig(**MODEL), TrainConfig(**TRAIN))
    remat = esrnet.build_generator(ModelConfig(**MODEL), TrainConfig(**{**TRAIN,
                                                                       "remat_rrdb": True}))
    remat.load_state_dict(plain.state_dict())
    assert remat.remat and not plain.remat
    loss_a, grads_a = _loss_and_grads(plain)
    loss_b, grads_b = _loss_and_grads(remat)
    assert torch.equal(loss_a, loss_b)
    for k in grads_a:
        assert torch.equal(grads_a[k], grads_b[k]), k


def test_every_trunk_parameter_gets_a_gradient():
    model = esrnet.build_generator(ModelConfig(**MODEL), TrainConfig(**{**TRAIN,
                                                                       "remat_rrdb": True}))
    _, grads = _loss_and_grads(model)
    assert set(grads) == {k for k, _ in model.named_parameters()}
    for name, g in grads.items():
        assert g is not None and bool((g != 0).any()), name
    assert any(name.startswith("trunk.1.rdb3.conv5") for name in grads)


def test_the_training_model_runs_the_plain_rdb_and_the_eval_model_the_kernel():
    cfg = TrainConfig(**TRAIN)
    train = esrnet.build_generator(ModelConfig(**MODEL), cfg, training=True)
    evaluate = esrnet.build_generator(ModelConfig(**MODEL), cfg, training=False)
    blocks = lambda m: [b for b in m.modules() if isinstance(b, ResidualDenseBlock)]  # noqa: E731
    assert blocks(train) and all(b.packed and b.plain for b in blocks(train))
    assert blocks(evaluate) and all(b.packed and not b.plain for b in blocks(evaluate))
    assert not evaluate.remat


def _port_loss_and_grads(model, lr, hr, mode="none"):
    tm = esrnet.train_forward_model(model, mode)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in model.named_parameters()}
    loss = torch.mean(torch.abs(torch.func.functional_call(tm, leaves, (torch.from_numpy(lr),))
                                - torch.from_numpy(hr)))
    return loss.detach(), _grads_of(loss, leaves)


def test_one_bf16_step_against_jax():
    """One step in bf16 compute from the same f32 params and batch.

    The convolutions round their outputs to bf16 at the same points in both
    frameworks, and their weight gradients agree within the bf16 bound
    (2e-2 of the largest).  The bias gradients do not: JAX sums a bias's
    bf16 cotangent over the batch and pixels in bf16 (conv4's 8,192 terms
    here come to 0.108 where float32 gives 0.524), PyTorch sums bf16 in
    float32 and rounds once.  So the port's bias gradients are held to its
    own f32 ones (1e-2), JAX's conv4 bias gradient is pinned as off by more
    than half, and the step's parameter change is compared on the weights.
    The clip is the default 100, at work on neither side (the two gradient
    norms differ by the biases').  Adam's first step is lr * g / (|g| + eps)
    elementwise, which bf16 moves only where |g| is near eps or its sign
    flips: at most 1% of the weights may differ from JAX's change by more
    than 1e-2 of the largest one (0.09% measured, the worst 0.10)."""
    model, cfg = _jax_model(use_bfloat16=True, grad_clip_norm=100.0)
    tx = jax_esrnet.build_optimizer(cfg, STEPS_PER_EPOCH)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"]
    lr, hr = _batches(1)[0]
    tm = jax_esrnet.train_forward_model(model, "none")
    jloss, jgrads = jax.value_and_grad(
        lambda p: jnp.mean(jnp.abs(tm.apply({"params": p}, lr) - hr)))(params)
    jp, _, _, _, _ = jax_guarded_update(
        tx, jgrads, tx.init(params), params, params, jax_guard_init(), reject_limit=500.0,
        rollback_after=4, ema_decay=EMA_DECAY)
    start = state_dict_from_jax_params(jax.device_get(params))
    ref = state_dict_from_jax_params(jax.device_get(jp))
    jgrads = state_dict_from_jax_params(jax.device_get(jgrads))

    pcfg = TrainConfig(**{**TRAIN, "use_bfloat16": True, "grad_clip_norm": 100.0})
    pm = esrnet.build_generator(ModelConfig(**MODEL), pcfg)
    pm.load_state_dict(start)
    assert pm.dtype == torch.bfloat16
    f32 = esrnet.build_generator(ModelConfig(**MODEL), TrainConfig(**TRAIN))
    f32.load_state_dict(start)
    loss, grads = _port_loss_and_grads(pm, lr, hr)
    _, grads_f32 = _port_loss_and_grads(f32, lr, hr)
    assert abs(float(loss) - float(jloss)) <= 2e-3 * float(jloss)
    weights = [k for k in grads if k.endswith(".weight")]
    scale = max(float(jgrads[k].abs().max()) for k in weights)
    assert max(float((grads[k] - jgrads[k]).abs().max()) for k in weights) <= 2e-2 * scale
    for k in grads:
        if k.endswith(".bias") and float(grads_f32[k].norm()) > 1e-3:
            assert float((grads[k] - grads_f32[k]).norm()) <= 1e-2 * float(grads_f32[k].norm()), k
    conv4 = float(grads_f32["conv4.bias"].norm())
    print(f"conv4 bias gradient norm: JAX bf16 {float(jgrads['conv4.bias'].norm()):.3f}, "
          f"port bf16 {float(grads['conv4.bias'].norm()):.3f}, port f32 {conv4:.3f}")
    assert float((jgrads["conv4.bias"] - grads_f32["conv4.bias"]).norm()) > 0.5 * conv4

    opt = esrnet.build_optimizer(pcfg, STEPS_PER_EPOCH)
    step = esrnet.make_train_step(pm, opt, None, None, None, EMA_DECAY)
    state, m = step.update(esrnet.init_state(pm, opt), torch.from_numpy(lr),
                           torch.from_numpy(hr))
    assert torch.equal(m["loss"], loss) and bool(torch.isfinite(m["grad_norm"]))
    scale = max(float((ref[k] - start[k]).abs().max()) for k in weights)
    err = torch.cat([((state.params[k] - ref[k]).abs() / scale).reshape(-1) for k in weights])
    print(f"weights off by > 1e-2: {float((err > 1e-2).double().mean()):.3g}, "
          f"worst {float(err.max()):.3g}")
    assert float((err > 1e-2).double().mean()) <= 1e-2


def test_the_full_step_degrades_then_updates():
    """``step`` = ``degrade_batch`` then ``update``: the same state and batch
    give the same (lr, hr), and the step's loss is the update's on them."""
    from real_esrgan_tpu_torch.configuration import (
        DegradationConfig, KernelSynthesisConfig, PipelineGeometry,
    )

    cfg = TrainConfig(**TRAIN)
    model = esrnet.build_generator(ModelConfig(**MODEL), cfg)
    opt = esrnet.build_optimizer(cfg, STEPS_PER_EPOCH)
    geo = PipelineGeometry(hr_size=64, crop_size=32, scale=4)
    step = esrnet.make_train_step(model, opt, geo, KernelSynthesisConfig(),
                                  DegradationConfig(usm_radius=13), EMA_DECAY, seed=4)
    state = esrnet.init_state(model, opt)
    hr = torch.from_numpy((np.random.default_rng(2).random((2, 64, 64, 3)) * 255)
                          .astype(np.uint8))
    lr_a, hr_a = step.degrade_batch(state, hr, True, False)
    lr_b, hr_b = step.degrade_batch(copy.copy(state), hr, True, False)
    assert torch.equal(lr_a, lr_b) and torch.equal(hr_a, hr_b)
    assert lr_a.shape == (2, 8, 8, 3) and hr_a.shape == (2, 32, 32, 3)
    new, m = step(state, hr, True, False)
    _, m_ref = step.update(state, lr_a, hr_a)
    assert torch.equal(m["loss"], m_ref["loss"]) and new.step == 1
    other = copy.copy(state)
    other.step = 1
    assert not torch.equal(step.degrade_batch(other, hr, True, False)[0], lr_a)
