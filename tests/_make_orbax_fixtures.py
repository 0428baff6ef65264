"""Writes the Orbax checkpoint fixtures under ``tests/data/jax_orbax/`` with
the JAX package's own ``save_checkpoint`` on the CPU, and ``leaves.json``,
the listing of every leaf as JAX's ``load_checkpoint`` returns it.  Not
collected by pytest (the name starts with ``_``); the tests import its
functions.

* ``g_c64_b1/``: the committed EMA generator (``assets/inenv10_esrnet_ema.npz``)
  at full width (64 channels, growth 32, x4) with its depth cut to one RRDB
  (the head, ``trunk_0`` and the tail), in float32: ``{"epoch": 1,
  "best_niqe": ..., "params": P, "ema_params": None}``.
* ``esrnet_c16/g_epoch_1/``: a narrow stage-1 state (16 channels, growth 4,
  one RRDB) after one guarded JAX step, as the JAX trainer saves it.
* ``gan_c16/{g_epoch_1,d_epoch_1}/``: the same for stage 2 (D with 4
  channels), after one JAX G+D step.  Together under 4 MB.

The narrow runs start from a guard whose ``lr_scale`` is 0.5, so a resumed
run that drops the guard shows.  Run from the repository root:

    python tests/_make_orbax_fixtures.py
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys

import jax

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import real_esrgan_tpu.train.esrgan as jax_esrgan  # noqa: E402
from real_esrgan_tpu.configuration import DegradationConfig, GanTrainConfig  # noqa: E402
from real_esrgan_tpu.configuration import KernelSynthesisConfig, ModelConfig  # noqa: E402
from real_esrgan_tpu.configuration import PipelineGeometry, TrainConfig  # noqa: E402
from real_esrgan_tpu.models import UNetDiscriminator  # noqa: E402
from real_esrgan_tpu.models.ema import ema_init  # noqa: E402
from real_esrgan_tpu.models.vgg import VGG19Features  # noqa: E402
from real_esrgan_tpu.train import esrnet as jax_esrnet  # noqa: E402
from real_esrgan_tpu.train.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from real_esrgan_tpu.train.guard import guard_from_dict, guard_to_dict  # noqa: E402
from real_esrgan_tpu.train.guard import guarded_update  # noqa: E402

DATA = os.path.join(ROOT, "tests", "data", "jax_orbax")
NPZ = os.path.join(ROOT, "assets", "inenv10_esrnet_ema.npz")
FIXTURES = ("g_c64_b1", "esrnet_c16/g_epoch_1", "gan_c16/g_epoch_1", "gan_c16/d_epoch_1")
BEST_NIQE = 6.25

NARROW_MODEL = dict(num_rrdb=1, channels=16, growth_channels=4)
ESRNET_TRAIN = dict(use_bfloat16=False, remat_rrdb=False, grad_clip_norm=0.5)
VGG_NODES = ("conv1_2", "conv2_2")
GAN_TRAIN = dict(use_bfloat16=False, remat_rrdb=False, vgg_nodes=VGG_NODES,
                 content_weights=(0.1, 1.0))
D_CHANNELS = 4
STEPS_PER_EPOCH = 10
EMA_DECAY = 0.999
START_LR_SCALE = 0.5


def batches(n=2, seed=0):
    """(LR 16x16, HR 64x64) float32 pairs of batch 2; HR scaled by 0.5, 1.0,
    ... so each step's gradients differ."""
    rng = np.random.default_rng(seed)
    return [(rng.random((2, 16, 16, 3)).astype(np.float32),
             (rng.random((2, 64, 64, 3)) * (0.5 + 0.5 * i)).astype(np.float32))
            for i in range(n)]


def c64_b1_params():
    """Head, ``trunk_0`` and tail of the committed EMA generator, float32."""
    from real_esrgan_tpu.train.checkpoint import load_generator_params
    tree = load_generator_params(NPZ)
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  {k: v for k, v in tree.items()
                                   if not k.startswith("trunk_") or k == "trunk_0"})


def start_guard():
    return guard_from_dict({"lr_scale": np.float32(START_LR_SCALE)})


class Esrnet:
    """The narrow stage-1 run: one guarded step is ``step(state, lr, hr)``
    on a dict state (``step``, ``params``, ``ema``, ``opt``, ``guard``)."""

    def __init__(self):
        self.cfg = TrainConfig(**ESRNET_TRAIN)
        self.model = jax_esrnet.build_generator(ModelConfig(**NARROW_MODEL), self.cfg)
        self.tx = jax_esrnet.build_optimizer(self.cfg, STEPS_PER_EPOCH)
        train_model = jax_esrnet.train_forward_model(self.model, "none")

        def loss_fn(p, lr, hr):
            return jnp.mean(jnp.abs(train_model.apply({"params": p}, lr) - hr))

        self.grad = jax.value_and_grad(loss_fn)

    def init(self):
        params = self.model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"]
        return {"step": jnp.zeros((), jnp.int32), "params": params, "ema": ema_init(params),
                "opt": self.tx.init(params), "guard": start_guard()}

    def step(self, state, lr, hr):
        loss, grads = self.grad(state["params"], lr, hr)
        p, ema, opt, guard, info = guarded_update(
            self.tx, grads, state["opt"], state["params"], state["ema"], state["guard"],
            reject_limit=self.cfg.grad_reject_limit, rollback_after=self.cfg.rollback_after,
            ema_decay=EMA_DECAY, reject_mult=self.cfg.grad_reject_mult)
        return {"step": state["step"] + 1, "params": p, "ema": ema, "opt": opt,
                "guard": guard}, float(loss)

    @staticmethod
    def payload(state, epoch=1):
        """The JAX trainer's g_ payload (train_realesrnet.py)."""
        return {"epoch": epoch, "best_niqe": BEST_NIQE, "step": state["step"],
                "params": state["params"], "ema_params": state["ema"],
                "opt_state": state["opt"], "guard": guard_to_dict(state["guard"])}

    def resume(self, path):
        """The JAX trainer's resume of a g_ checkpoint into a dict state."""
        from real_esrgan_tpu.train.checkpoint import restore_like
        tree = load_checkpoint(path)
        fresh = self.init()
        return {"step": jnp.asarray(tree["step"]), "params": tree["params"],
                "ema": tree["ema_params"], "opt": restore_like(fresh["opt"], tree["opt_state"]),
                "guard": guard_from_dict(tree["guard"])}


class Gan:
    """The narrow stage-2 run: ``step(state, lr, hr)`` is JAX's
    ``make_gan_train_step`` with the degradation replaced by the batch."""

    def __init__(self):
        self.cfg = GanTrainConfig(**GAN_TRAIN)
        self.generator = jax_esrnet.build_generator(ModelConfig(**NARROW_MODEL), self.cfg)
        self.discriminator = UNetDiscriminator(channels=D_CHANNELS, dtype=self.generator.dtype)
        self.vgg = VGG19Features(nodes=VGG_NODES, dtype=self.generator.dtype)
        self.vgg_params = self.vgg.init(jax.random.PRNGKey(2),
                                        jnp.zeros((1, 64, 64, 3)))["params"]
        self.g_tx, self.d_tx = jax_esrgan.build_optimizers(self.cfg, STEPS_PER_EPOCH)
        self._step = jax_esrgan.make_gan_train_step(
            self.generator, self.discriminator, self.vgg, self.vgg_params, self.g_tx,
            self.d_tx, PipelineGeometry(64, 64, 4), KernelSynthesisConfig(),
            DegradationConfig(), self.cfg)

    def init(self):
        g_params = self.generator.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"]
        d_vars = self.discriminator.init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)))
        return jax_esrgan.GanTrainState(
            step=jnp.zeros((), jnp.int32), g_params=g_params, g_ema=ema_init(g_params),
            g_opt=self.g_tx.init(g_params), d_params=d_vars["params"],
            d_stats=d_vars["batch_stats"], d_opt=self.d_tx.init(d_vars["params"]),
            g_guard=start_guard(), d_guard=start_guard())

    def step(self, state, lr, hr):
        degrade = jax_esrgan.degrade  # read when the jitted step is traced
        jax_esrgan.degrade = lambda key, batch, *a, **k: batch
        try:
            state, metrics = self._step(state, (jnp.asarray(lr), jnp.asarray(hr)),
                                        jax.random.PRNGKey(0))
        finally:
            jax_esrgan.degrade = degrade
        return state, {k: float(v) for k, v in metrics.items()}

    @staticmethod
    def payloads(state, epoch=1):
        """The JAX trainer's g_ and d_ payloads (train_realesrgan.py)."""
        g = {"epoch": epoch, "best_niqe": BEST_NIQE, "step": state.step,
             "params": state.g_params, "ema_params": state.g_ema, "opt_state": state.g_opt,
             "guard": guard_to_dict(state.g_guard)}
        d = {"epoch": epoch, "best_niqe": BEST_NIQE, "params": state.d_params,
             "batch_stats": state.d_stats, "opt_state": state.d_opt,
             "guard": guard_to_dict(state.d_guard)}
        return g, d

    def resume(self, g_path, d_path):
        """The JAX trainer's resume of a g_/d_ pair."""
        from real_esrgan_tpu.train.checkpoint import restore_like
        g, d = load_checkpoint(g_path), load_checkpoint(d_path)
        fresh = self.init()
        return fresh.replace(
            step=jnp.asarray(g["step"]), g_params=g["params"], g_ema=g["ema_params"],
            g_opt=restore_like(fresh.g_opt, g["opt_state"]), g_guard=guard_from_dict(g["guard"]),
            d_params=d["params"], d_stats=d["batch_stats"],
            d_opt=restore_like(fresh.d_opt, d["opt_state"]), d_guard=guard_from_dict(d["guard"]))


def write_esrnet(path):
    """One JAX step of the narrow stage-1 run, saved at ``path``; returns
    (the run, its state)."""
    run = Esrnet()
    state, _ = run.step(run.init(), *batches(1)[0])
    save_checkpoint(path, Esrnet.payload(state))
    return run, state


def write_gan(g_path, d_path):
    run = Gan()
    state, _ = run.step(run.init(), *batches(1)[0])
    g, d = Gan.payloads(state)
    save_checkpoint(g_path, g)
    save_checkpoint(d_path, d)
    return run, state


def leaves(path):
    """Every leaf of the JAX load of ``path``: path, dtype, shape and the
    SHA-256 of its bytes (dtype None for a None leaf)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(load_checkpoint(path),
                                                   is_leaf=lambda x: x is None)
    out = []
    for keys, value in flat:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in keys)
        if value is None:
            out.append({"path": name, "dtype": None, "shape": None, "sha256": None})
            continue
        arr = np.asarray(value)
        out.append({"path": name, "dtype": str(arr.dtype), "shape": list(arr.shape),
                    "sha256": hashlib.sha256(arr.tobytes()).hexdigest()})
    return out


def listing(root=DATA):
    return {name: leaves(os.path.join(root, name)) for name in FIXTURES}


def main():
    if os.path.exists(DATA):
        shutil.rmtree(DATA)
    os.makedirs(DATA)
    save_checkpoint(os.path.join(DATA, "g_c64_b1"),
                    {"epoch": 1, "best_niqe": BEST_NIQE, "params": c64_b1_params(),
                     "ema_params": None})
    write_esrnet(os.path.join(DATA, "esrnet_c16", "g_epoch_1"))
    write_gan(os.path.join(DATA, "gan_c16", "g_epoch_1"),
              os.path.join(DATA, "gan_c16", "d_epoch_1"))
    with open(os.path.join(DATA, "leaves.json"), "w") as f:
        json.dump(listing(), f, indent=1, sort_keys=True)
        f.write("\n")
    size = sum(os.path.getsize(os.path.join(d, n)) for d, _, names in os.walk(DATA) for n in names)
    print(f"wrote {DATA}: {size} bytes")


if __name__ == "__main__":
    main()
