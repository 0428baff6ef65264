"""The port's ``eval_pair`` against the JAX CLI on one InEnv10 instance.

The instance is built on the CPU with the JAX package's own tools, run as
they are: ``tools/make_inenv_dataset.py --textures`` (10 photographic
sources, spatially held-out eval regions) and ``scripts/make_degraded_eval.py
--seed 0 --hr-size 160 --crop-size 128 --cpu`` (62 degraded pairs, LR 32).
Only the same instance is compared: a regenerated one drifts.

What holds, and is asserted: the bicubic baseline is equal source by source
(25.244 dB in the mean); with the committed ESRNet weights in float32 the
two generators agree per source within 1e-3 dB; in the CLIs' bf16 the mean
agrees within 0.02 dB.  What does not: in bf16 two of nine sources differ by
0.08 dB (dogskin, wood; one tile by 0.18), where float32 agrees to 1e-6 in
the output.  The two frameworks round the bf16 convolutions' float32 sums in
other orders, and these noisy 32-pixel tiles carry one flipped rounding
through 69 blocks; on the worst tile the port's bf16 is nearer float32 than
JAX's.  The per-source values are printed under ``pytest -s``.  Several
minutes on the CPU: marked ``slow``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from real_esrgan_tpu_torch.scripts import eval_pair

pytestmark = pytest.mark.slow

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "assets", "inenv10_esrnet_ema.npz")


def _jax(*args):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    run = subprocess.run([sys.executable, *args], cwd=ROOT, env=env, check=True,
                         capture_output=True, text=True, timeout=1800)
    return run.stdout.strip().splitlines()


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    out = tmp_path_factory.mktemp("inenv10") / "InEnv10"
    _jax("tools/make_inenv_dataset.py", "--out", str(out), "--textures")
    _jax("scripts/make_degraded_eval.py", "--gt-dir", str(out / "eval_src"), "--output-dir",
         str(out / "eval_degraded"), "--seed", "0", "--hr-size", "160", "--crop-size", "128",
         "--cpu")
    lr, hr = out / "eval_degraded" / "LRx4", out / "eval_degraded" / "GTmod4"
    assert len(os.listdir(lr)) == len(os.listdir(hr)) > 50
    return str(lr), str(hr)


def _both(pairs, *flags):
    lr, hr = pairs
    ref = json.loads(_jax("scripts/eval_pair.py", "--cpu", *flags, "--lr-dir", lr,
                          "--hr-dir", hr)[-1])
    ours = eval_pair.main(["--cpu", *flags, "--lr-dir", lr, "--hr-dir", hr])
    print(flags[0], "JAX", ref["psnr_by_source"], "port", ours["psnr_by_source"])
    assert ref["n"] == ours["n"] and ref["psnr_by_source"].keys() == ours["psnr_by_source"].keys()
    return ref, ours


def test_bicubic_baseline_is_equal_by_source(pairs):
    ref, ours = _both(pairs, "--bicubic")
    assert ours["psnr_by_source"] == ref["psnr_by_source"]
    assert ours["psnr_mean"] == ref["psnr_mean"]


def test_esrnet_f32_agrees_by_source(pairs):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from real_esrgan_tpu.serve import SRPipeline as JaxSRPipeline
    from real_esrgan_tpu.train.checkpoint import load_generator_params as jax_load
    from real_esrgan_tpu_torch.serve import SRPipeline
    from real_esrgan_tpu_torch.train.checkpoint import load_generator_params
    from real_esrgan_tpu_torch.utils.imgio import read_png

    theirs = JaxSRPipeline(bfloat16=False)
    theirs.params = jax_load(WEIGHTS)
    ours = SRPipeline(bfloat16=False, device="cpu")
    ours.model.load_state_dict(load_generator_params(WEIGHTS))
    lr_dir, hr_dir = pairs
    by_source = {}
    for name in sorted(os.listdir(lr_dir)):
        lr = read_png(os.path.join(lr_dir, name)).astype(np.float32) / 255.0
        hr = read_png(os.path.join(hr_dir, name)).astype(np.float64) / 255.0
        scores = [10 * np.log10(1.0 / np.mean((np.asarray(p.upscale(lr), np.float64) - hr) ** 2))
                  for p in (theirs, ours)]
        by_source.setdefault(name.split("_")[0], []).append(scores)
    for source, scores in by_source.items():
        ref, port = np.mean(scores, axis=0)
        print(f"f32 {source}: JAX {ref:.4f} port {port:.4f}")
        assert abs(port - ref) <= 1e-3, source


def test_esrnet_bf16_mean_agrees_through_the_clis(pairs):
    ref, ours = _both(pairs, "--weights", WEIGHTS)
    assert abs(ours["psnr_mean"] - ref["psnr_mean"]) <= 0.02
