"""The port's stage-2 G+D step against the JAX package's
``make_gan_train_step`` on the CPU, float32.

Small size: G 2 RRDBs, 16 channels, growth 8; D ``channels=16``; VGG19 to
conv2_2 (taps conv1_2 and conv2_2, weights 0.1 and 1.0); LR 16x16 -> HR
64x64, batch 2, with the JAX params carried across by the port's carriers.
JAX's ``degrade`` is replaced inside the test by one that returns the
step's fixed batch (passed through the jitted step's batch argument, so
each step gets its own: HR scaled by 0.5, 1.0, 1.5); the port's side is
``make_gan_train_step(...).update``.

Bounds, after each of three guarded steps: every loss term, both
probabilities and both pre-clip gradient norms within ``REL`` = 1e-5
relative (2.1e-6 measured); D's ``sigma`` of every layer within 1e-5
relative (the power iteration runs three times a step).  After the three
steps: G's parameters and EMA within ``UPDATE_BOUND`` = 1e-3 of the
largest JAX parameter change (2.5e-5 measured).  D's parameters: at most
``D_SHARE`` = 1e-4 of the elements off by more than 1e-3 of the largest JAX
change, none by more than 1e-2 (4 of 274,001 measured, the worst 2.2e-3).
Those few have a first gradient near Adam's eps (1e-8; the worst 1.7e-9),
where the step lr * g / (|g| + eps) follows g's last bits.  A cadence
mutant, D(hr) not advancing ``u`` (two power iterations a step instead of
three), fails the bounds: the metrics by 3.9e-2, the sigmas by 3.0e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import real_esrgan_tpu.train.esrgan as jax_esrgan
from real_esrgan_tpu.configuration import DegradationConfig as JaxDegradationConfig
from real_esrgan_tpu.configuration import GanTrainConfig as JaxGanTrainConfig
from real_esrgan_tpu.configuration import KernelSynthesisConfig as JaxKernelSynthesisConfig
from real_esrgan_tpu.configuration import ModelConfig as JaxModelConfig
from real_esrgan_tpu.configuration import PipelineGeometry as JaxPipelineGeometry
from real_esrgan_tpu.models import UNetDiscriminator as JaxDiscriminator
from real_esrgan_tpu.models.ema import ema_init as jax_ema_init
from real_esrgan_tpu.models.vgg import VGG19Features as JaxVGG
from real_esrgan_tpu.train.esrnet import build_generator as jax_build_generator
from real_esrgan_tpu.train.guard import guard_init as jax_guard_init
from real_esrgan_tpu_torch.configuration import DegradationConfig, GanTrainConfig, ModelConfig
from real_esrgan_tpu_torch.models.convert import (
    discriminator_state_from_jax, state_dict_from_jax_params, vgg_state_from_jax,
)
from real_esrgan_tpu_torch.models.discriminator import SN_LAYERS, UNetDiscriminator
from real_esrgan_tpu_torch.models.vgg import VGG19Features
from real_esrgan_tpu_torch.train import esrgan, esrnet

MODEL = dict(num_rrdb=2, channels=16, growth_channels=8)
NODES = ("conv1_2", "conv2_2")
TRAIN = dict(use_bfloat16=False, remat_rrdb=False, vgg_nodes=NODES, content_weights=(0.1, 1.0))
STEPS_PER_EPOCH = 10
REL = 1e-5
UPDATE_BOUND = 1e-3
D_SHARE = 1e-4
BF16_REL = 2e-4
METRICS = ("pixel", "content", "adversarial", "g_loss", "d_loss", "d_hr_prob", "d_sr_prob",
           "g_grad_norm", "d_grad_norm")


def batches(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.random((2, 16, 16, 3)).astype(np.float32),
             (rng.random((2, 64, 64, 3)) * (0.5 + 0.5 * i)).astype(np.float32))
            for i in range(n)]


def jax_gan_run(monkeypatch, n_steps=3, **train):
    """``n_steps`` JAX steps on ``batches()``: the start, each step's metrics,
    and after each step G's params and EMA and D's params and stats, all as
    the port's state dicts."""
    cfg = JaxGanTrainConfig(**{**TRAIN, **train})
    generator = jax_build_generator(JaxModelConfig(**MODEL), cfg)
    discriminator = JaxDiscriminator(channels=16, dtype=generator.dtype)
    vgg = JaxVGG(nodes=NODES, dtype=generator.dtype)
    g_params = generator.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"]
    d_vars = discriminator.init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)))
    vgg_params = vgg.init(jax.random.PRNGKey(2), jnp.zeros((1, 64, 64, 3)))["params"]
    g_tx, d_tx = jax_esrgan.build_optimizers(cfg, STEPS_PER_EPOCH)
    state = jax_esrgan.GanTrainState(
        step=jnp.zeros((), jnp.int32), g_params=g_params, g_ema=jax_ema_init(g_params),
        g_opt=g_tx.init(g_params), d_params=d_vars["params"], d_stats=d_vars["batch_stats"],
        d_opt=d_tx.init(d_vars["params"]), g_guard=jax_guard_init(), d_guard=jax_guard_init())
    # the batch rides in the step's batch argument, so each step sees its own
    monkeypatch.setattr(jax_esrgan, "degrade", lambda key, batch, *a, **k: batch)
    step = jax_esrgan.make_gan_train_step(
        generator, discriminator, vgg, vgg_params, g_tx, d_tx, JaxPipelineGeometry(64, 64, 4),
        JaxKernelSynthesisConfig(), JaxDegradationConfig(), cfg)

    def port_d(state):
        return discriminator_state_from_jax(jax.device_get(state.d_params),
                                            jax.device_get(state.d_stats))

    run = {"g": state_dict_from_jax_params(jax.device_get(g_params)), "d": port_d(state),
           "vgg": vgg_state_from_jax(jax.device_get(vgg_params)), "metrics": [], "after": []}
    for lr, hr in batches(n_steps):
        state, metrics = step(state, (jnp.asarray(lr), jnp.asarray(hr)), jax.random.PRNGKey(0))
        run["metrics"].append({k: float(v) for k, v in metrics.items()})
        run["after"].append({"g": state_dict_from_jax_params(jax.device_get(state.g_params)),
                             "ema": state_dict_from_jax_params(jax.device_get(state.g_ema)),
                             "d": port_d(state)})
    return run


def port_models(run, discriminator_cls=UNetDiscriminator, **train):
    cfg = GanTrainConfig(**{**TRAIN, **train})
    dtype = torch.bfloat16 if cfg.use_bfloat16 else torch.float32
    generator = esrnet.build_generator(ModelConfig(**MODEL), cfg)
    generator.load_state_dict(run["g"])
    discriminator = discriminator_cls(channels=16, dtype=dtype)
    discriminator.load_state_dict(run["d"][0])
    discriminator.stats = run["d"][1]
    vgg = VGG19Features(NODES, dtype=dtype).requires_grad_(False)
    vgg.load_state_dict(run["vgg"])
    g_tx, d_tx = esrgan.build_optimizers(cfg, STEPS_PER_EPOCH)
    step = esrgan.make_gan_train_step(generator, discriminator, vgg, g_tx, d_tx, None, None,
                                      DegradationConfig(), cfg)
    return esrgan.init_gan_state(generator, discriminator, g_tx, d_tx), step


def port_gan_run(run, n_steps=3, discriminator_cls=UNetDiscriminator, **train):
    state, step = port_models(run, discriminator_cls, **train)
    metrics = []
    for lr, hr in batches(n_steps):
        state, m = step.update(state, torch.from_numpy(lr), torch.from_numpy(hr))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def change_error(ours, ref, start, scale_ref=None):
    """Elementwise |our change - JAX's change| over the largest JAX change of
    ``scale_ref`` (default ``ref``) from ``start``, one tensor a name."""
    scale_ref = ref if scale_ref is None else scale_ref
    scale = max(float((scale_ref[k] - start[k]).abs().max()) for k in start)
    return {k: (ours[k] - ref[k]).abs() / scale for k in start}


def step_errors(metrics, run, stats):
    """The largest relative error of the metrics over the steps, and of
    D's sigmas after the last step."""
    metric_err = max(abs(m[k] - r[k]) / abs(r[k]) for m, r in zip(metrics, run["metrics"])
                     for k in METRICS)
    ref_stats = run["after"][-1]["d"][1]
    sigma_err = max(abs(float(stats[f"{n}.sigma"]) - float(ref_stats[f"{n}.sigma"]))
                    / float(ref_stats[f"{n}.sigma"]) for n, *_ in SN_LAYERS)
    return metric_err, sigma_err


@pytest.fixture(scope="module")
def jax_run():
    mp = pytest.MonkeyPatch()
    try:
        yield jax_gan_run(mp)
    finally:
        mp.undo()


def test_three_guarded_gan_steps_match_jax(jax_run):
    state, metrics = port_gan_run(jax_run)
    metric_err, sigma_err = step_errors(metrics, jax_run, state.d_stats)
    print(f"metrics rel {metric_err:.3g}, sigma rel {sigma_err:.3g}")
    assert metric_err <= REL and sigma_err <= REL
    for m in metrics:
        assert m["g_rejected"] == m["d_rejected"] == 0.0
    end, start = jax_run["after"][-1], jax_run
    g_err = max(float(e.max()) for e in change_error(state.g_params, end["g"], start["g"]).values())
    ema_err = max(float(e.max()) for e in
                  change_error(state.g_ema, end["ema"], start["g"], end["g"]).values())
    d_err = torch.cat([e.reshape(-1) for e in
                       change_error(state.d_params, end["d"][0], start["d"][0]).values()])
    off = float((d_err > UPDATE_BOUND).double().mean())
    print(f"G params {g_err:.3g}, EMA {ema_err:.3g}; D params: "
          f"{int((d_err > UPDATE_BOUND).sum())} of {d_err.numel()} off by > {UPDATE_BOUND} "
          f"({off:.3g}), the worst {float(d_err.max()):.3g}")
    assert max(g_err, ema_err) <= UPDATE_BOUND
    assert off <= D_SHARE and float(d_err.max()) <= 10 * UPDATE_BOUND
    assert state.step == 3
    assert int(state.g_opt.count) == int(state.d_opt.count) == 3


class TwoPowerIterations(UNetDiscriminator):
    """A mutant: the D-step's D(hr), the second D forward of every step,
    does not advance u."""

    def forward(self, x, stats, update_stats=False):
        self.calls = getattr(self, "calls", 0) + 1
        return super().forward(x, stats, update_stats and self.calls % 3 != 2)


def test_the_bounds_fail_a_cadence_mutant(jax_run):
    state, metrics = port_gan_run(jax_run, discriminator_cls=TwoPowerIterations)
    metric_err, sigma_err = step_errors(metrics, jax_run, state.d_stats)
    print(f"mutant: metrics rel {metric_err:.3g}, sigma rel {sigma_err:.3g}")
    assert metric_err > REL and sigma_err > REL


def test_the_steps_parts_compose_to_update(jax_run):
    """``update`` is g_loss_and_grads, g_apply, d_loss_and_grads on the
    detached sr and the stats the G-step left, then d_apply."""
    state, step = port_models(jax_run)
    lr, hr = (torch.from_numpy(a) for a in batches(1)[0])
    new, metrics = step.update(state, lr, hr)
    g_grads, aux = step.g_loss_and_grads(state, lr, hr)
    assert not aux["sr"].requires_grad and torch.equal(aux["g_loss"], metrics["g_loss"])
    g_params, g_ema, _, _, _ = step.g_apply(state, g_grads)
    d_grads, d_aux = step.d_loss_and_grads(state.d_params, aux["d_stats"], aux["sr"], hr)
    d_params, _, _, info = step.d_apply(state, d_grads)
    assert torch.equal(d_aux["d_loss"], metrics["d_loss"])
    assert torch.equal(info["grad_norm"], metrics["d_grad_norm"])
    for k in g_params:
        assert torch.equal(g_params[k], new.g_params[k]) and torch.equal(g_ema[k], new.g_ema[k])
    for k in d_params:
        assert torch.equal(d_params[k], new.d_params[k])
    for k in new.d_stats:
        assert torch.equal(d_aux["d_stats"][k], new.d_stats[k])
        assert not torch.equal(new.d_stats[k], state.d_stats[k]) or k.endswith("sigma")


def _weights_off(ours, ref, start, bound=1e-2):
    """The share of weight elements whose change is off from ``ref``'s by
    more than ``bound`` of ``ref``'s largest weight change."""
    names = [k for k in start if k.endswith(".weight")]
    scale = max(float((ref[k] - start[k]).abs().max()) for k in names)
    err = torch.cat([((ours[k] - ref[k]).abs() / scale).reshape(-1) for k in names])
    return float((err > bound).double().mean())


def test_one_bf16_gan_step_against_jax(jax_run):
    """One G+D step in bf16 compute from the same f32 params and batch.

    The loss terms and probabilities agree within ``BF16_REL`` = 2e-4
    relative (3.0e-5 measured, content) and D's sigmas within 1e-5 (the
    power iteration runs on the f32 kernels).  Adam's first step is
    lr * g / (|g| + eps) elementwise, about lr * sign(g), so a weight whose
    gradient is near 0 moves the other way when bf16 rounds its sums
    elsewhere; bf16 itself does that to 4.6% of G's and 1.9% of D's weights
    (JAX's f32 step against its bf16 step).  The port's bf16 step may be off
    from JAX's (by more than 1e-2 of the largest change) on at most 0.6 of
    that share: 1.9% and 0.9% measured, 0.41 and 0.48 of it.  The gradient
    norms are not compared: JAX sums a bias's bf16 cotangent in bf16
    (``test_torch_gan_models.py::test_jax_sums_d_bias_gradients_in_bf16``),
    so its norms differ by the biases', and the biases are left out here."""
    mp = pytest.MonkeyPatch()
    try:
        run = jax_gan_run(mp, n_steps=1, use_bfloat16=True)
    finally:
        mp.undo()
    for k in run["g"]:
        assert torch.equal(run["g"][k], jax_run["g"][k])
    state, metrics = port_gan_run(run, n_steps=1, use_bfloat16=True)
    rel = max(abs(metrics[0][k] - run["metrics"][0][k]) / abs(run["metrics"][0][k])
              for k in METRICS[:-2])
    ref_stats = run["after"][0]["d"][1]
    sigma = max(abs(float(state.d_stats[f"{n}.sigma"]) - float(ref_stats[f"{n}.sigma"]))
                / float(ref_stats[f"{n}.sigma"]) for n, *_ in SN_LAYERS)
    after, after_f32 = run["after"][0], jax_run["after"][0]
    shares = {}
    for name, ours, start in (("G", state.g_params, run["g"]), ("D", state.d_params, run["d"][0])):
        key = "g" if name == "G" else "d"
        ref = after[key] if name == "G" else after[key][0]
        ref_f32 = after_f32[key] if name == "G" else after_f32[key][0]
        shares[name] = (_weights_off(ours, ref, start), _weights_off(ref_f32, ref, start))
    print(f"bf16: metrics rel {rel:.3g}, sigma rel {sigma:.3g}; weights off by > 1e-2, port "
          f"against JAX and JAX f32 against JAX bf16: {shares}")
    assert rel <= BF16_REL and sigma <= REL
    for name, (port_off, bf16_off) in shares.items():
        assert port_off <= 0.6 * bf16_off, name
    assert metrics[0]["g_rejected"] == metrics[0]["d_rejected"] == 0.0
