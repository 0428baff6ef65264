"""The port's bench (``real_esrgan_tpu_torch/bench.py``): the output contract
of the JAX bench (tests/test_bench_cli.py) with the measure functions
stubbed, one real CPU run of each measure function at a tiny configuration,
and its FLOP counts: inference against the analytic sum over the
convolutions and against XLA's cost analysis of the JAX forward, tiled over
every tile batch (the JAX bench records one)."""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_esrgan_tpu.models import Generator as JaxGenerator
from real_esrgan_tpu_torch import bench
from real_esrgan_tpu_torch.configuration import DegradationConfig, ModelConfig, PipelineGeometry
from real_esrgan_tpu_torch.models import Generator

CPU = torch.device("cpu")
TINY = ModelConfig(num_rrdb=1, channels=16, growth_channels=8)
FLAGSHIP = "x4_sr_output_megapixels_per_sec_per_chip"


@pytest.fixture(autouse=True)
def private_lock(monkeypatch, tmp_path):
    # never wait on a real lock held by a job on this machine
    monkeypatch.setattr(bench, "GPU_BUSY_LOCK", str(tmp_path / "busy.lock"))


@pytest.fixture
def stubbed(monkeypatch):
    monkeypatch.setattr(bench, "measure", lambda b, s, i, device: bench.Measured(20.0, 2.0e12))
    monkeypatch.setattr(bench, "measure_train",
                        lambda b, i, device, mix=True: bench.Measured(95.0, 1.0e12))
    monkeypatch.setattr(bench, "measure_gan",
                        lambda b, i, device, mix=True: bench.Measured(58.0, 1.5e12))
    monkeypatch.setattr(bench, "measure_tiled",
                        lambda i, device, devices=None: bench.Measured(12.0, 2.1e12))


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(bench, "MODEL", TINY)
    monkeypatch.setattr(bench, "TRAIN_GEOMETRY", PipelineGeometry(hr_size=64, crop_size=32,
                                                                  scale=4))
    monkeypatch.setattr(bench, "DEGRADATION", DegradationConfig(usm_radius=13))
    torch.manual_seed(0)


def _run(capsys, argv):
    rc = bench.main(["--cpu", *argv])
    return rc, capsys.readouterr().out.strip().splitlines()


def _parsed(lines):
    return [json.loads(line) for line in lines if line.startswith("{")]


def test_all_mode_flagship_last_with_extras(stubbed, capsys):
    rc, lines = _run(capsys, [])
    parsed = _parsed(lines)
    assert rc == 0
    assert [p["metric"] for p in parsed] == [
        "x4_tiled_2k_to_8k_megapixels_per_sec", "x4_train_images_per_sec_per_chip",
        "x4_gan_train_images_per_sec_per_chip", FLAGSHIP]
    last = parsed[-1]
    assert (last["train_imgs_per_s"], last["gan_imgs_per_s"], last["tiled_mp_per_s"]) == \
        (95.0, 58.0, 12.0)
    for line in parsed:
        assert set(line) >= {"metric", "value", "unit", "device", "flops_per_unit",
                             "effective_tflops"}
        assert line["device"] == "cpu"
        # no TPU or A100 denominators; no H100 share for a CPU run
        assert not set(line) & {"vs_baseline", "baseline_note", "peak_fraction",
                                "ceiling_fraction", "mfu"}
    assert last["effective_tflops"] == round(20.0 * 2.0, 3)


def test_all_mode_budget_skips_heavy_stages(stubbed, monkeypatch, capsys):
    monkeypatch.setattr(bench.time, "perf_counter", iter([0.0, 1e6, 2e6, 3e6, 4e6]).__next__)
    rc, lines = _run(capsys, ["--budget", "10"])
    parsed = _parsed(lines)
    assert rc == 0
    assert len(parsed) == 1 and parsed[0]["metric"] == FLAGSHIP
    assert sum(line.startswith("# skipped") for line in lines) == 3


def test_a_failing_stage_is_reported_and_the_exit_is_not_zero(stubbed, monkeypatch, capsys):
    def boom(b, i, device, mix=True):
        raise RuntimeError("stage exploded")

    monkeypatch.setattr(bench, "measure_gan", boom)
    rc, lines = _run(capsys, [])
    parsed = _parsed(lines)
    assert rc == 1
    assert len(parsed) == 3 and parsed[-1]["metric"] == FLAGSHIP
    assert "gan_imgs_per_s" not in parsed[-1]
    assert any(line.startswith("# gan stage failed: RuntimeError: stage exploded")
               for line in lines)


@pytest.mark.parametrize("mode,metric", [("train", "x4_train_images_per_sec_per_chip"),
                                         ("inference", FLAGSHIP)])
def test_single_mode_one_line(stubbed, capsys, mode, metric):
    rc, lines = _run(capsys, ["--mode", mode])
    parsed = _parsed(lines)
    assert rc == 0 and len(parsed) == 1 and parsed[0]["metric"] == metric


def test_a_gpu_line_carries_mfu_against_the_h100_peak():
    line = bench._line("inference", FLAGSHIP, bench.Measured(20.0, 2.24e12), "MP/s",
                       torch.device("cuda"), "NVIDIA H100 80GB HBM3, 700.00 W")
    assert line["effective_tflops"] == round(20.0 * 2.24, 3)
    assert line["mfu"] == round(20.0 * 2.24 / 989.4, 5)
    assert line["peak_tflops"] == 989.4 and "H100" in line["peak_note"]
    assert line["device"] == "NVIDIA H100 80GB HBM3, 700.00 W"


def test_the_lock_path_comes_from_the_environment(monkeypatch, tmp_path):
    import importlib

    path = str(tmp_path / "other.lock")
    monkeypatch.setenv("GPU_BUSY_LOCK", path)
    try:
        assert importlib.reload(bench).GPU_BUSY_LOCK == path
    finally:
        monkeypatch.delenv("GPU_BUSY_LOCK")
        importlib.reload(bench)


def test_a_stale_lock_is_removed(monkeypatch, tmp_path):
    lock = tmp_path / "busy.lock"
    lock.write_text("train 999999999 0")  # no such PID
    monkeypatch.setattr(bench, "GPU_BUSY_LOCK", str(lock))
    assert bench.wait_for_idle_chip(max_wait_s=0) is False
    assert not lock.exists()


def test_measure_runs_on_the_cpu(tiny):
    m = bench.measure(2, 16, 2, CPU)
    assert m.value > 0 and m.flops_per_unit > 0
    assert m.extra["fused_rdb_launches"] == 0  # the CPU runs the plain RDB


@pytest.mark.parametrize("measure", ["measure_train", "measure_gan"])
def test_training_measures_run_on_the_cpu(tiny, measure):
    m = getattr(bench, measure)(2, 2, CPU)
    assert m.value > 0 and math.isfinite(m.value)
    assert m.flops_per_unit > 0


def test_measure_tiled_counts_every_tile_batch(tiny):
    # 40 px at 24/4: core 16, 3 x 3 tiles; batches of 4 -> 4, 4 and a tail of 1
    m = bench.measure_tiled(1, CPU, in_size=40, tile=24, tile_batch=4, overlap=4)
    assert m.value > 0
    assert m.extra["tile_batches"] == 3 and m.extra["geometry"] == [24, 4, 4]
    twin = bench._bf16_generator("meta", plain=True)

    def batch_flops(n):
        with torch.no_grad():
            return bench.count_flops(twin, torch.empty((n, 24, 24, 3), device="meta"))

    assert m.extra["flops_per_tile_batch"] == batch_flops(4)
    # 4 + 4 + 1 tiles, not one batch
    assert m.extra["flops_per_call"] == 2 * batch_flops(4) + batch_flops(1)
    assert m.flops_per_unit == m.extra["flops_per_call"] / ((40 * 4) ** 2 / 1e6)


def test_tiled_count_without_a_tail_is_batches_times_one_batch(tiny):
    m = bench.measure_tiled(1, CPU, in_size=40, tile=24, tile_batch=3, overlap=4)
    assert m.extra["tile_batches"] == 3
    assert m.extra["flops_per_call"] == 3 * m.extra["flops_per_tile_batch"]


def _analytic_conv_flops(cfg: ModelConfig, h: int, w: int) -> int:
    """2 * 9 * C_in * C_out per output pixel of every 3x3 convolution of the x4
    generator on an (h, w) input."""
    c, g = cfg.channels, cfg.growth_channels
    per = lambda cin, cout: 2 * 9 * cin * cout  # noqa: E731
    rdb = sum(per(c + k * g, g if k < 4 else c) for k in range(5))
    lr = h * w
    return (lr * (per(3, c) + 3 * cfg.num_rrdb * rdb + per(c, c))
            + 4 * lr * per(c, c) + 16 * lr * (per(c, c) + per(c, c) + per(c, 3)))


def test_inference_flops_equal_the_convolutions_and_xla(tiny, capsys):
    batch, size = 2, 16
    x = torch.empty((batch, size, size, 3), device="meta")
    twin = bench._bf16_generator("meta", plain=True)
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        twin(x)
    counts = counter.get_flop_counts()["Global"]
    total = counter.get_total_flops()
    analytic = batch * _analytic_conv_flops(TINY, size, size)
    assert counts[torch.ops.aten.convolution] == analytic
    # the rest is the subpixel upconvs' folding of their weights (a few small
    # einsums a forward, whatever the image size)
    assert set(counts) == {torch.ops.aten.convolution, torch.ops.aten.bmm}
    assert total == analytic + counts[torch.ops.aten.bmm] < analytic * 1.01
    assert bench.count_flops(twin, x) == total

    model = JaxGenerator(upscale_factor=4, num_rrdb=TINY.num_rrdb, channels=TINY.channels,
                         growth=TINY.growth_channels, dtype=jnp.bfloat16)
    xj = jnp.zeros((batch, size, size, 3), jnp.float32)
    params = model.init(jax.random.PRNGKey(0), xj)["params"]
    cost = jax.jit(lambda p, v: model.apply({"params": p}, v)).lower(params, xj).compile() \
        .cost_analysis()
    xla = float((cost[0] if isinstance(cost, (list, tuple)) else cost)["flops"])
    with capsys.disabled():
        print(f"\nFLOPs: port {total}, analytic {analytic}, XLA {xla:.0f}, "
              f"port/XLA {total / xla:.4f}")
    assert abs(total / xla - 1) <= 0.05


def test_jax_records_one_tile_batch_where_the_port_counts_all(tiny):
    """The JAX bench's count of the tiled program (XLA's cost analysis of the
    lax.map) is the count of one batch, whatever the number of batches."""
    from real_esrgan_tpu.parallel import tiling as jax_tiling

    model = JaxGenerator(upscale_factor=4, num_rrdb=TINY.num_rrdb, channels=TINY.channels,
                         growth=TINY.growth_channels, dtype=jnp.bfloat16)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))["params"]
    apply_fn = lambda p, v: model.apply({"params": p}, v)  # noqa: E731

    def xla_flops(fn, *args):
        cost = fn.lower(*args).compile().cost_analysis()
        return float((cost[0] if isinstance(cost, (list, tuple)) else cost)["flops"])

    # 40 px at 24/4: 3 x 3 tiles of 24, three batches of 3
    tiled = xla_flops(jax_tiling._build_tiled_fn(apply_fn, 3, 3, 24, 4, 3, 4, 3, None),
                      params, jnp.zeros((56, 56, 3), jnp.float32))
    one_batch = xla_flops(jax.jit(apply_fn), params, jnp.zeros((3, 24, 24, 3), jnp.float32))
    ours = bench.measure_tiled(1, CPU, in_size=40, tile=24, tile_batch=3, overlap=4)
    assert tiled < 1.5 * one_batch  # JAX: the map body once, not three times
    assert ours.extra["flops_per_call"] == 3 * ours.extra["flops_per_tile_batch"]
    assert abs(ours.extra["flops_per_tile_batch"] / one_batch - 1) <= 0.05


def test_the_twin_counts_what_the_kernel_path_computes():
    """The meta twin (plain RDBs) and the evaluation generator (packed RDBs,
    the kernel's path on a GPU) give the same output on the CPU, so the
    twin's count is the count of the forward that is timed."""
    x = torch.from_numpy(np.random.default_rng(0).random((1, 8, 8, 3)).astype(np.float32))
    kwargs = dict(num_rrdb=1, channels=64, growth=32, dtype=torch.bfloat16)
    plain = Generator(plain_rdb=True, **kwargs).eval()
    packed = Generator(**kwargs).eval()
    with torch.no_grad():
        assert torch.equal(plain(x), packed(x))
