"""The port's guard (``train/guard.py``) against the JAX ``guarded_update``,
and its schedules against the JAX ones, on the CPU.

Every scenario of tests/test_optimizer_robustness.py feeds the same gradient
sequence to both guards, with the same optimizer (``build_optimizer`` of the
same ``TrainConfig``) and the same params and EMA, and compares after every
step: each guard field (the counts exactly; ``lr_scale`` and ``gnorm_ref``
within 1e-6 relative), the info flags, and the params, EMA, Adam moments and
update count (1e-6 relative, 1e-7 absolute: the same float32 arithmetic on
4x4 tensors of constant gradients).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from real_esrgan_tpu.configuration import TrainConfig as JaxTrainConfig
from real_esrgan_tpu.train import esrnet as jax_esrnet
from real_esrgan_tpu.train import guard as jax_guard
from real_esrgan_tpu.train import schedule as jax_schedule
from real_esrgan_tpu_torch.configuration import TrainConfig
from real_esrgan_tpu_torch.train import esrnet, guard, schedule

PARAMS = {"b": np.zeros((4,), np.float32), "w": np.ones((4, 4), np.float32)}
EMA = {"b": np.full((4,), 3.0, np.float32), "w": np.full((4, 4), 2.0, np.float32)}
DEFAULTS = dict(reject_limit=500.0, rollback_after=4, ema_decay=0.9)


def _close(a, b, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=what)


class Both:
    """One JAX and one port guard, stepped on the same gradients."""

    def __init__(self, cfg_kwargs=None, params=PARAMS, ema=EMA):
        cfg_kwargs = cfg_kwargs or {}
        self.tx = jax_esrnet.build_optimizer(JaxTrainConfig(**cfg_kwargs), 10)
        self.opt = esrnet.build_optimizer(TrainConfig(**cfg_kwargs), 10)
        self.j = [{k: jnp.asarray(v) for k, v in params.items()},
                  {k: jnp.asarray(v) for k, v in ema.items()}, None, jax_guard.guard_init()]
        self.j[2] = self.tx.init(self.j[0])
        p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        self.t = [p, {k: torch.from_numpy(v.copy()) for k, v in ema.items()},
                  self.opt.init(p), guard.guard_init()]
        self.ema_is_params = ema is params

    def step(self, value, **kw):
        kw = {**DEFAULTS, **kw}
        jg = {k: jnp.full_like(v, value) for k, v in self.j[0].items()}
        tg = {k: torch.full_like(v, value) for k, v in self.t[0].items()}
        jema = self.j[0] if self.ema_is_params else self.j[1]
        tema = self.t[0] if self.ema_is_params else self.t[1]
        jp, je, jo, jgd, jinfo = jax_guard.guarded_update(self.tx, jg, self.j[2], self.j[0],
                                                          jema, self.j[3], **kw)
        tp, te, to, tgd, tinfo = guard.guarded_update(self.opt, tg, self.t[2], self.t[0], tema,
                                                      self.t[3], **kw)
        self.j = [jp, je, jo, jgd]
        self.t = [tp, te, to, tgd]
        self.compare(jinfo, tinfo)
        return tinfo

    def compare(self, jinfo, tinfo):
        jp, je, jo, jgd = self.j
        tp, te, to, tgd = self.t
        for f in ("reject_streak", "rejected_total", "rollback_total", "accept_streak"):
            assert int(getattr(jgd, f)) == int(getattr(tgd, f)), f
        for f in ("lr_scale", "gnorm_ref"):
            _close(getattr(tgd, f), getattr(jgd, f), f)
        for f in ("rejected", "rollback", "lr_scale"):
            assert float(jinfo[f]) == float(tinfo[f]), f
        jn, tn = float(jinfo["grad_norm"]), float(tinfo["grad_norm"])
        assert (np.isnan(jn) and np.isnan(tn)) or jn == tn or abs(jn - tn) <= 1e-6 * abs(jn)
        # the chain's Adam state, behind the clip's empty state or alone
        adam = jo[0] if isinstance(jo[0], optax.ScaleByAdamState) else jo[1][0]
        assert int(adam.count) == int(to.count)
        for k in tp:
            _close(tp[k], jp[k], f"params {k}")
            _close(te[k], je[k], f"ema {k}")
            _close(to.mu[k], adam.mu[k], f"mu {k}")
            _close(to.nu[k], adam.nu[k], f"nu {k}")

    @property
    def guard(self):
        return self.t[3]


def test_inf_gradient_is_rejected_then_a_finite_one_applies():
    both = Both()
    assert float(both.step(np.inf)["rejected"]) == 1.0
    assert torch.equal(both.t[0]["w"], torch.ones(4, 4))
    assert float(both.step(0.5)["rejected"]) == 0.0
    assert not torch.equal(both.t[0]["w"], torch.ones(4, 4))
    assert int(both.guard.rejected_total) == 1 and int(both.guard.reject_streak) == 0


def test_nan_gradient_is_rejected():
    both = Both()
    both.step(np.nan)
    assert int(both.guard.rejected_total) == 1


def test_huge_finite_gradient_cannot_poison_adam():
    both = Both()
    both.step(1e30)
    assert all(bool(torch.isfinite(v).all()) for v in both.t[2].nu.values())
    assert int(both.guard.rejected_total) == 1
    both.step(0.5)
    assert all(bool(torch.isfinite(v).all()) for v in both.t[0].values())


def test_outlier_is_rejected_and_under_the_limit_accepted():
    assert float(Both().step(1e3)["rejected"]) == 1.0
    assert float(Both().step(10.0)["rejected"]) == 0.0


def test_rollback_restores_the_ema_and_zeroes_the_moments_but_keeps_the_count():
    both = Both()
    for _ in range(3):
        both.step(0.5)
    ema_before = {k: v.clone() for k, v in both.t[1].items()}
    rolled = [float(both.step(np.nan)["rollback"]) for _ in range(4)]
    assert rolled == [0.0, 0.0, 0.0, 1.0]
    assert int(both.guard.rollback_total) == 1 and int(both.guard.reject_streak) == 0
    for k in ema_before:
        assert torch.equal(both.t[0][k], ema_before[k]) and torch.equal(both.t[1][k],
                                                                        ema_before[k])
        assert not bool(both.t[2].mu[k].any()) and not bool(both.t[2].nu[k].any())
    assert int(both.t[2].count) == 3
    assert float(both.step(0.5)["rejected"]) == 0.0


def test_rollback_disabled():
    both = Both(ema=PARAMS, params=PARAMS)
    for _ in range(10):
        assert float(both.step(np.inf, rollback_after=0)["rollback"]) == 0.0
    assert int(both.guard.rejected_total) == 10 and int(both.guard.rollback_total) == 0
    assert float(both.guard.lr_scale) == 0.5  # the 8-rejection streak backed off


def test_long_streak_keeps_rolling_back():
    both = Both()
    for _ in range(150):
        both.step(np.inf)
    assert int(both.guard.rejected_total) == 150 and int(both.guard.rollback_total) == 37


def test_lr_scale_halves_to_its_floor():
    both = Both()
    for k in range(1, 9):
        for _ in range(4):
            both.step(np.nan)
        assert float(both.guard.lr_scale) == max(0.5 ** k, 1 / 64)


def test_lr_scale_recovers_and_caps_at_one():
    both = Both()
    for _ in range(8):
        both.step(np.nan)
    assert float(both.guard.lr_scale) == 0.25
    for _ in range(10):
        both.step(0.5, recover_after=3)
    assert float(both.guard.lr_scale) == 1.0


def test_lr_scale_multiplies_the_update():
    both = Both(cfg_kwargs={"grad_clip_norm": 0.0})
    both.j[3] = both.j[3].replace(lr_scale=jnp.float32(0.5))
    both.t[3].lr_scale = torch.tensor(0.5)
    assert float(both.step(0.5)["lr_scale"]) == 0.5


def test_adaptive_limit_rejects_a_ramp_step_and_keeps_its_reference():
    both = Both()
    for _ in range(5):
        both.step(0.5)
    ref = float(both.guard.gnorm_ref)
    assert float(both.step(20.0)["rejected"]) == 1.0
    assert float(both.guard.gnorm_ref) == ref


def test_adaptive_limit_inactive_without_history():
    both = Both()
    assert float(both.step(10.0)["rejected"]) == 0.0
    assert float(both.guard.gnorm_ref) > 0.0


def test_reject_mult_zero_disables_the_adaptive_limit():
    both = Both()
    for _ in range(3):
        both.step(0.5, reject_mult=0.0)
    assert float(both.step(20.0, reject_mult=0.0)["rejected"]) == 0.0


def test_storm_then_recovery_sequence():
    """Healthy, a storm of non-finite gradients, healthy again: the two
    guards stay equal through every rollback, backoff and recovery."""
    both = Both(cfg_kwargs={"lr": 0.05})
    for value in [0.5] * 20 + [np.inf] * 20 + [0.25] * 40:
        both.step(value, ema_decay=0.95, recover_after=16)
    # five rollbacks took lr_scale to 1/32, and 40 accepted steps doubled it twice
    assert int(both.guard.rollback_total) == 5 and float(both.guard.lr_scale) == 0.125


def test_guard_dict_round_trip_and_missing_fields():
    g = guard.guard_init()
    g.rejected_total = torch.tensor(7, dtype=torch.int32)
    g.lr_scale = torch.tensor(0.25)
    g.gnorm_ref = torch.tensor(12.5)
    d = guard.guard_to_dict(g)
    assert set(d) == set(guard.GUARD_FIELDS)
    back = guard.guard_from_dict({k: np.asarray(v) for k, v in d.items()})
    assert int(back.rejected_total) == 7 and float(back.lr_scale) == 0.25
    assert float(back.gnorm_ref) == 12.5 and back.rejected_total.dtype == torch.int32
    d.pop("gnorm_ref")
    back = guard.guard_from_dict(d)
    assert float(back.gnorm_ref) == 0.0 and float(back.lr_scale) == 0.25
    assert float(guard.guard_from_dict(None).lr_scale) == 1.0
    # the JAX dict of the same guard gives the same fields
    jd = jax_guard.guard_to_dict(jax_guard.guard_init().replace(
        rejected_total=jnp.int32(7), lr_scale=jnp.float32(0.25)))
    back = guard.guard_from_dict({k: np.asarray(v) for k, v in jd.items()})
    assert int(back.rejected_total) == 7 and float(back.lr_scale) == 0.25


STEPS = [0, 1, 2, 5, 9, 10, 19, 20, 49, 50, 99, 100, 101, 250, 999, 1000, 5000]


@pytest.mark.parametrize("warmup", [0, 7])
def test_step_lr_matches_jax(warmup):
    ours = schedule.step_lr(2e-4, 3, 0.5, 10, warmup_steps=warmup)
    ref = jax_schedule.step_lr(2e-4, 3, 0.5, 10, warmup_steps=warmup)
    for s in STEPS:
        got = ours(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert float(got) == float(ref(jnp.int32(s))), s


@pytest.mark.parametrize("warmup", [0, 5])
def test_multistep_lr_matches_jax(warmup):
    ours = schedule.multistep_lr(1e-4, (8, 2, 4), 0.5, 10, warmup_steps=warmup)
    ref = jax_schedule.multistep_lr(1e-4, (8, 2, 4), 0.5, 10, warmup_steps=warmup)
    for s in STEPS:
        assert float(ours(torch.tensor(s, dtype=torch.int32))) == float(ref(jnp.int32(s))), s
