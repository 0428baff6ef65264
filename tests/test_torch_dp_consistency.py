"""Data-parallel training in the port: two ranks (two spawned processes,
gloo on localhost) against the single-process step on the whole batch, and
against the JAX package's sharded step, on the CPU in float32.

The cases are ``real_esrgan_tpu_torch/tools/dp_check.py``'s ``small``
preset: G 2 RRDBs, 16 channels, growth 8; D 16 channels; VGG19 to conv2_2;
hr 64 -> crop 32; a global batch of 4, 2 a rank; three steps.

* ``esrnet_step`` and ``gan_step`` (the degradation included: each rank
  draws the global batch's draws and applies its slice): every loss term,
  probability and pre-clip gradient norm of the three steps within ``REL``
  = 1e-5 relative of the single-process step's; G's parameters and EMA
  within ``UPDATE_BOUND`` = 1e-3 of the largest single-process change; D's
  parameters by PR 12's element-share rule (at most ``D_SHARE`` = 1e-4 of
  the elements off by more than 1e-3 of the largest change, none by more
  than 1e-2), since Adam's eps carries the summation order of gradients
  near zero into whole steps.  The G+D parameters and D's ``u`` are held
  after the first of the three steps: from the second on, a few elements
  whose gradient is near eps follow the summation order of the step before,
  and one process against itself on 1, 2, 4 and 8 threads already differs
  by up to 2.06e-3 (G, 9 elements) and 1.21e-2 (D, 115 elements) after
  three steps, where after one it stays within 3.7e-5 and 7.4e-4 (my CPU
  runs).  Both ranks hold the same bits of every parameter, EMA and D
  ``u`` after all three steps.
* ``esrnet_update`` on fixed batches from JAX's start weights, against
  JAX's ``guarded_update`` jitted with the parameters replicated and the
  batch sharded over two devices of the test mesh (as
  tests/test_dp_consistency.py runs the JAX step): loss and grad norm 1e-5
  relative a step; parameters and EMA within 1e-3 of the largest JAX
  parameter change (``PERF.md`` §2's bound for three f32 steps).
* ``guard``: a reject limit between a rank's own gradient norm and the
  global one, once each way; both ranks take the global decision.

Each multi-process run is bounded by ``TIMEOUT`` seconds and retried once
only when a rank never joined the group (``launch_local``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_esrgan_tpu.configuration import ModelConfig as JaxModelConfig
from real_esrgan_tpu.configuration import TrainConfig as JaxTrainConfig
from real_esrgan_tpu.parallel import batch_sharding, make_mesh, replicated_sharding
from real_esrgan_tpu.train import esrnet as jax_esrnet
from real_esrgan_tpu.train.guard import guard_init as jax_guard_init
from real_esrgan_tpu.train.guard import guarded_update as jax_guarded_update
from real_esrgan_tpu_torch import train_realesrnet as trainer
from real_esrgan_tpu_torch.configuration import PipelineGeometry, TrainConfig
from real_esrgan_tpu_torch.data.device_pool import DevicePoolLoader
from real_esrgan_tpu_torch.models.convert import state_dict_from_jax_params
from real_esrgan_tpu_torch.parallel import mesh
from real_esrgan_tpu_torch.tools import dp_check

TIMEOUT = 120.0
REL = 1e-5
UPDATE_BOUND = 1e-3
D_SHARE = 1e-4
CASES = ("esrnet_step", "gan_step", "esrnet_update", "guard")
PRESET = dp_check.PRESETS["small"]
GAN_TERMS = ("pixel", "content", "adversarial", "g_loss", "d_loss", "d_hr_prob", "d_sr_prob",
             "g_grad_norm", "d_grad_norm")


def _jax_cfg():
    return JaxTrainConfig(use_bfloat16=False, remat_rrdb=False, grad_clip_norm=dp_check.GRAD_CLIP)


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    """The run's directory, holding JAX's start weights for ``esrnet_update``."""
    path = tmp_path_factory.mktemp("dp")
    model = jax_esrnet.build_generator(
        JaxModelConfig(num_rrdb=PRESET.rrdbs, channels=PRESET.channels,
                       growth_channels=PRESET.growth), _jax_cfg())
    lr_side = dp_check.UPDATE_SIZES[0]
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, lr_side, lr_side, 3)))["params"]
    torch.save(state_dict_from_jax_params(jax.device_get(params)), path / "start.pt")
    return path


@pytest.fixture(scope="module")
def ranks(out_dir):
    """Both ranks' results of every case."""
    runs = dp_check.launch_local(
        ["-m", "real_esrgan_tpu_torch.tools.dp_check", "--cpu", "--preset", "small", "--cases",
         ",".join(CASES), "--out", str(out_dir)], 2, TIMEOUT, env={"OMP_NUM_THREADS": "2"})
    for r, (rc, out) in enumerate(runs):
        assert rc == 0 and f"DP_CHECK_OK rank={r}" in out, f"rank {r}:\n{out[-4000:]}"
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=True) for r in range(2)]


@pytest.fixture(scope="module")
def single(out_dir):
    """The same cases in this process, with no process group: the
    single-process step on the whole batch."""
    return dp_check.run_cases(CASES, "small", torch.device("cpu"), str(out_dir))


@pytest.fixture(scope="module")
def jax_sharded(out_dir):
    """Three guarded JAX updates, jitted with the state replicated and each
    batch sharded over a mesh of two devices."""
    cfg = _jax_cfg()
    model = jax_esrnet.build_generator(
        JaxModelConfig(num_rrdb=PRESET.rrdbs, channels=PRESET.channels,
                       growth_channels=PRESET.growth), cfg)
    lr_side = dp_check.UPDATE_SIZES[0]
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, lr_side, lr_side, 3)))["params"]
    tx = jax_esrnet.build_optimizer(cfg, dp_check.STEPS_PER_EPOCH)
    train_model = jax_esrnet.train_forward_model(model, "none")
    ema_decay = TrainConfig().ema_decay

    def update(p, ema, opt, guard, lr, hr):
        def loss_fn(q):
            return jnp.mean(jnp.abs(train_model.apply({"params": q}, lr) - hr))
        loss, grads = jax.value_and_grad(loss_fn)(p)
        p, ema, opt, guard, info = jax_guarded_update(
            tx, grads, opt, p, ema, guard, reject_limit=cfg.grad_reject_limit,
            rollback_after=cfg.rollback_after, ema_decay=ema_decay,
            reject_mult=cfg.grad_reject_mult)
        return p, ema, opt, guard, loss, info["grad_norm"]

    mesh = make_mesh(jax.devices()[:2])
    replicated, sharded = replicated_sharding(mesh), batch_sharding(mesh)
    p = jax.device_put(params, replicated)
    ema = jax.device_put(jax.tree_util.tree_map(jnp.copy, params), replicated)
    opt = jax.device_put(tx.init(params), replicated)
    guard = jax.device_put(jax_guard_init(), replicated)
    step = jax.jit(update)
    metrics = []
    for lr, hr in dp_check.update_batches(PRESET, PRESET.steps):
        p, ema, opt, guard, loss, gnorm = step(p, ema, opt, guard,
                                               jax.device_put(lr, sharded),
                                               jax.device_put(hr, sharded))
        metrics.append((float(loss), float(gnorm)))
    sd = lambda tree: state_dict_from_jax_params(jax.device_get(tree))  # noqa: E731
    return {"start": sd(params), "metrics": metrics, "params": sd(p), "ema": sd(ema)}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def _update_error(ours, ref, start, scale_ref=None):
    """Largest |ours - ref| over the largest change of ``scale_ref`` (default
    ``ref``) from ``start``."""
    scale_ref = ref if scale_ref is None else scale_ref
    scale = max(float((scale_ref[k] - start[k]).abs().max()) for k in start)
    return max(float((ours[k] - ref[k]).abs().max()) for k in start) / scale


def _same_bits(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("case", ["esrnet_step", "gan_step"])
def test_both_ranks_hold_the_same_state(ranks, case):
    a, b = ranks[0][case], ranks[1][case]
    for key in ("params", "ema", "d_params", "d_stats"):
        if key in a:
            assert _same_bits(a[key], b[key]), key
    assert a["metrics"] == b["metrics"]


def test_two_rank_esrnet_steps_equal_the_single_process_step(ranks, single):
    ours, ref = ranks[0]["esrnet_step"], single["esrnet_step"]
    assert len(ours["metrics"]) == PRESET.steps
    for m, r in zip(ours["metrics"], ref["metrics"]):
        assert _rel(m["loss"], r["loss"]) <= REL
        assert _rel(m["grad_norm"], r["grad_norm"]) <= REL
        assert m["rejected"] == r["rejected"] == 0.0
    assert _same_bits(ours["start"], ref["start"])
    errors = [_update_error(ours[k], ref[k], ref["start"], ref["params"])
              for k in ("params", "ema")]
    print(f"esrnet_step: params, EMA {errors} of the largest change")
    assert max(errors) <= UPDATE_BOUND


def test_two_rank_gan_steps_equal_the_single_process_step(ranks, single):
    """Every metric of the three steps within REL; the parameters after the
    first step (see the module docstring) by the G and D bounds."""
    ours, ref = ranks[0]["gan_step"], single["gan_step"]
    for m, r in zip(ours["metrics"], ref["metrics"]):
        for term in GAN_TERMS:
            assert _rel(m[term], r[term]) <= REL, term
        assert m["g_rejected"] == r["g_rejected"] == 0.0
        assert m["d_rejected"] == r["d_rejected"] == 0.0
    first, ref_first = ours["first"], ref["first"]
    error = _update_error(first["params"], ref_first["params"], ref["start"])
    assert error <= UPDATE_BOUND, error
    scale = max(float((ref_first["d_params"][k] - ref["d_start"][k]).abs().max())
                for k in ref["d_start"])
    diffs = torch.cat([(first["d_params"][k] - ref_first["d_params"][k]).abs().reshape(-1)
                       for k in ref["d_start"]]) / scale
    share = float((diffs > 1e-3).float().mean())
    print(f"gan_step, first step: G {error}, D share over 1e-3 {share}, worst "
          f"{float(diffs.max())}")
    assert share <= D_SHARE and float(diffs.max()) <= 1e-2
    # u follows D's weights, each power iteration from the last
    for k in ref_first["d_stats"]:
        assert torch.allclose(first["d_stats"][k], ref_first["d_stats"][k], atol=1e-5, rtol=0), k


def test_two_rank_updates_match_jax_sharded_step(ranks, jax_sharded):
    ours = ranks[0]["esrnet_update"]
    assert _same_bits(ours["params"], ranks[1]["esrnet_update"]["params"])
    for m, (loss, gnorm) in zip(ours["metrics"], jax_sharded["metrics"]):
        assert _rel(m["loss"], loss) <= REL
        assert _rel(m["grad_norm"], gnorm) <= REL
        assert m["grad_norm"] > dp_check.GRAD_CLIP  # the clip is at work
    errors = [_update_error(ours[k], jax_sharded[ref], jax_sharded["start"],
                            jax_sharded["params"])
              for k, ref in (("params", "params"), ("ema", "ema"))]
    print(f"esrnet_update against JAX's sharded step: params, EMA {errors}")
    assert max(errors) <= UPDATE_BOUND


def test_the_guard_decides_on_the_global_norm(ranks, single):
    ref = single["guard"]
    halves, whole, limits = ref["halves"], ref["whole"], ref["limits"]
    # each limit splits a rank's own norm from the global one
    assert max(halves) > limits["accept"] > whole
    assert min(halves) < limits["reject"] < whole
    assert ranks[0]["guard"]["limits"] == ranks[1]["guard"]["limits"]
    for r in ranks:
        g = r["guard"]
        assert all(_rel(g["limits"][k], limits[k]) <= REL for k in limits)
        assert g["accept"]["metrics"]["rejected"] == 0.0
        assert g["reject"]["metrics"]["rejected"] == 1.0
        for name in ("accept", "reject"):
            assert _rel(g[name]["metrics"]["grad_norm"], whole) <= REL
    for name in ("accept", "reject"):
        assert _same_bits(ranks[0]["guard"][name]["params"], ranks[1]["guard"][name]["params"])
        assert ref[name]["metrics"]["rejected"] == ranks[0]["guard"][name]["metrics"]["rejected"]


def test_pool_shares_make_the_one_gpu_batch():
    """Each rank's pool batch is its ``shard_slice`` of the one-rank batch of
    the global size, epoch after epoch; 8 bytes an image of its share cross."""
    pool = np.random.default_rng(0).integers(0, 255, (20, 8, 8, 3), dtype=np.uint8)
    one = DevicePoolLoader(pool, 8, seed=4, device="cpu")
    shares = [DevicePoolLoader(pool, 8, seed=4, device="cpu", rank=r, world=2) for r in (0, 1)]
    for _ in range(2):
        ref = list(one)
        parts = [list(s) for s in shares]
        assert len(ref) == len(parts[0]) == len(parts[1]) == 2
        for i, batch in enumerate(ref):
            assert torch.equal(torch.cat([parts[0][i], parts[1][i]]), batch)
    assert shares[0].index_bytes == shares[1].index_bytes == 2 * 2 * 4 * 8


@pytest.mark.parametrize("mode", ["threads", "grain", "device"])
def test_make_train_loader_takes_the_rank_shard(monkeypatch, tmp_path, mode):
    """Under a process group each rank's loader is its shard: a stride of the
    host loaders' set, a share of each pool batch; without ``sharded`` every
    rank iterates the whole set."""
    from real_esrgan_tpu_torch.data.dataset import TrainImageDataset
    from real_esrgan_tpu_torch.utils.imgio import write_png

    for i in range(8):
        write_png(str(tmp_path / f"{i}.png"), np.full((16, 16, 3), i * 20, np.uint8))
    monkeypatch.setattr(trainer, "rank", lambda: 1)
    monkeypatch.setattr(trainer, "world_size", lambda: 2)
    cfg = TrainConfig(loader=mode, num_workers=1, device_pool_budget_bytes=1 << 20)
    ds = TrainImageDataset(str(tmp_path), 16)
    loader = trainer.make_train_loader(ds, 2, cfg, PipelineGeometry(16, 16, 4), "cpu")
    if mode == "device":
        assert (loader.batch_size, loader.share) == (4, slice(2, 4))
    elif mode == "grain":
        assert (loader._key["shard_id"], loader._key["num_shards"]) == (1, 2)
    else:
        assert (loader.shard_id, loader.num_shards) == (1, 2)
    assert len(loader) == 2
    whole = trainer.make_train_loader(ds, 2, cfg, PipelineGeometry(16, 16, 4), "cpu",
                                      sharded=False)
    assert len(whole) == 4


def test_the_pool_is_refused_across_hosts(monkeypatch, tmp_path):
    monkeypatch.setattr(trainer, "world_size", lambda: 4)
    monkeypatch.setattr(mesh, "world_size", lambda: 4)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="single-host only"):
        trainer.make_train_loader([], 2, TrainConfig(loader="device"),
                                  PipelineGeometry(16, 16, 4), "cpu")


DEGRADE_GEO = PipelineGeometry(hr_size=64, crop_size=32, scale=4)
# ``degrade_for_step``'s draws (a SHA-256 over ``draws_to_arrays``, keys
# sorted) and outputs (8-bit levels) at step 3, seed 0, batch 4, hr 64 ->
# crop 32, with the default (approximate) Poisson sampler, for (up1, up2) =
# (0, 1) and (1, 0), as the tree gave them before the exact sampler's seeds
# joined the draws; the input is ``_degrade_input()``
DEGRADE_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                              "torch_degrade_for_step_b4_hr64.npz")


def _degrade_input() -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(16).integers(0, 256, (4, 64, 64, 3),
                                                                dtype=np.uint8))


@pytest.mark.parametrize("flags", [(False, True), (True, False), (True, True)])
def test_exact_poisson_ranks_degrade_the_global_batch(flags):
    """With the exact Poisson sampler (``poisson_approx`` off, both noise
    stages Poisson), ranks 0 and 1 of two each degrade their half of the
    global batch, and their outputs, concatenated, are the bits of one
    process degrading the whole batch: each sample's counts come from its
    own seed among the global batch's draws."""
    from real_esrgan_tpu_torch.configuration import DegradationConfig, KernelSynthesisConfig
    from real_esrgan_tpu_torch.train.esrnet import degrade_for_step

    dcfg = DegradationConfig(poisson_approx=False, gaussian_noise_prob1=0.0,
                             gaussian_noise_prob2=0.0)
    kcfg, hr = KernelSynthesisConfig(), _degrade_input()
    whole = degrade_for_step(5, hr, DEGRADE_GEO, kcfg, dcfg, 0, *flags)
    halves = [degrade_for_step(5, hr[2 * r:2 * r + 2], DEGRADE_GEO, kcfg, dcfg, 0, *flags,
                               rank_=r, world=2) for r in (0, 1)]
    for i in (0, 1):
        assert torch.equal(torch.cat([h[i] for h in halves]), whole[i])
    # the sampler draws counts a sample: another rank's slice is another noise
    assert not torch.equal(halves[0][0], halves[1][0])


@pytest.mark.parametrize("flags", [(False, True), (True, False)])
def test_default_sampler_draws_and_outputs_are_unchanged(flags):
    """The default approximate sampler draws no seeds: its draws and its
    degraded pairs are the bits recorded before the exact sampler's seeds
    were added (``DEGRADE_GOLDEN``)."""
    import hashlib

    from real_esrgan_tpu_torch.configuration import DegradationConfig, KernelSynthesisConfig
    from real_esrgan_tpu_torch.ops.degradation import (
        draw_degradation, draws_to_arrays, generator_seed,
    )
    from real_esrgan_tpu_torch.train.esrnet import degrade_for_step

    kcfg, dcfg = KernelSynthesisConfig(), DegradationConfig()
    assert dcfg.poisson_approx
    golden, tag = np.load(DEGRADE_GOLDEN), f"{int(flags[0])}{int(flags[1])}"
    seed = generator_seed(1, 3)
    draws = draw_degradation(torch.Generator().manual_seed(seed), 4, DEGRADE_GEO, kcfg, dcfg,
                             *flags, augment=True,
                             host_generator=torch.Generator().manual_seed(seed), device="cpu")
    arrays = draws_to_arrays(draws)
    assert not any("poisson_seed" in key for key in arrays)
    digest = hashlib.sha256()
    for key in sorted(arrays):
        digest.update(key.encode())
        digest.update(np.ascontiguousarray(arrays[key]).tobytes())
    assert digest.hexdigest() == str(golden[f"draws_sha256_{tag}"])
    lr, hr = degrade_for_step(3, _degrade_input(), DEGRADE_GEO, kcfg, dcfg, 0, *flags)
    np.testing.assert_array_equal(np.round(lr.numpy() * 255).astype(np.uint8),
                                  golden[f"lr_levels_{tag}"])
    np.testing.assert_array_equal(np.round(hr.numpy() * 255).astype(np.uint8),
                                  golden[f"hr_levels_{tag}"])
