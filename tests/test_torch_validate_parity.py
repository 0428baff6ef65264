"""The port's parity harness (``scripts/validate_parity.py`` of the port)
on the synthetic stand-ins of tests/test_validate_parity.py: a 1-RRDB JAX
generator exported to the reference's ``.pth.tar`` grammar and two 56 px LR
images.  The three JAX tests, run on the port; the port's NIQE within 0.01
of the JAX script's on the same inputs; and the port's SR pixel-matching the
JAX script's saved outputs at 45 dB, both in float32 on the CPU."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from real_esrgan_tpu.models import Generator
from real_esrgan_tpu.models.convert import export_generator
from real_esrgan_tpu_torch.scripts import validate_parity

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))

import validate_parity as jax_validate_parity  # noqa: E402

torch.set_num_threads(2)
COMMON = ["--num-rrdb", "1", "--cpu"]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("parity")
    model = Generator(upscale_factor=4, num_rrdb=1)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"]
    sd = {k: torch.tensor(np.asarray(v)) for k, v in export_generator(params).items()}
    weights = root / "g_synthetic.pth.tar"
    torch.save({"state_dict": sd}, weights)

    lr_dir = root / "Set5_LR"
    lr_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        # 56px LR -> 224px SR: large enough for NIQE's 96px block grid
        Image.fromarray((rng.random((56, 56, 3)) * 255).astype(np.uint8)).save(
            lr_dir / f"img{i}.png")
    return {"weights": str(weights), "lr_dir": str(lr_dir), "root": root}


def _verdict(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_run(artifacts):
    """The JAX script's NIQE verdict, its SR outputs saved."""
    sr_dir = artifacts["root"] / "jax_sr"
    report = artifacts["root"] / "jax_report.json"
    rc = jax_validate_parity.main([
        "--weights", artifacts["weights"], "--model", "realesrnet",
        "--set5-lr", artifacts["lr_dir"], *COMMON, "--niqe-tol", "1000",
        "--sr-out-dir", str(sr_dir), "--report", str(report)])
    assert rc == 0
    with open(report) as f:
        return {"verdict": json.loads(f.read()), "sr_dir": sr_dir / "Set5"}


def test_niqe_table_and_verdict(artifacts, jax_run, capsys):
    report = artifacts["root"] / "report.json"
    rc = validate_parity.main([
        "--weights", artifacts["weights"], "--model", "realesrnet",
        "--set5-lr", artifacts["lr_dir"], *COMMON,
        "--niqe-tol", "1000",  # random weights: plumbing test, not quality
        "--report", str(report)])
    verdict = _verdict(capsys)
    assert rc == 0
    assert verdict["parity"] is True
    assert verdict["checks"][0]["check"] == "niqe_set5"
    assert os.path.exists(report)
    ours, ref = verdict["checks"][0]["value"], jax_run["verdict"]["checks"][0]["value"]
    print(f"NIQE Set5 stand-ins: port {ours}, JAX {ref}")
    assert abs(ours - ref) <= 0.01


def test_fail_exit_code_when_out_of_tolerance(artifacts, capsys):
    rc = validate_parity.main([
        "--weights", artifacts["weights"], "--model", "realesrgan",
        "--set5-lr", artifacts["lr_dir"], *COMMON,
        "--niqe-tol", "-100"])  # impossible bar -> must FAIL with exit 1
    assert rc == 1
    assert _verdict(capsys)["parity"] is False


def test_pixel_match_against_own_outputs(artifacts, capsys):
    sr_dir = artifacts["root"] / "own_sr"
    rc = validate_parity.main([
        "--weights", artifacts["weights"], "--set5-lr", artifacts["lr_dir"], *COMMON,
        "--niqe-tol", "1000", "--sr-out-dir", str(sr_dir)])
    assert rc == 0
    rc = validate_parity.main([
        "--weights", artifacts["weights"], "--set5-lr", artifacts["lr_dir"], *COMMON,
        "--niqe-tol", "1000", "--reference-sr-dir", str(sr_dir / "Set5")])
    verdict = _verdict(capsys)
    assert rc == 0
    pm = [c for c in verdict["checks"] if c["check"] == "pixel_match_psnr"]
    assert pm and pm[0]["ok"]


def test_pixel_match_against_the_jax_outputs(artifacts, jax_run, capsys):
    rc = validate_parity.main([
        "--weights", artifacts["weights"], "--set5-lr", artifacts["lr_dir"], *COMMON,
        "--niqe-tol", "1000", "--reference-sr-dir", str(jax_run["sr_dir"]),
        "--pixel-match-psnr", "45"])
    verdict = _verdict(capsys)
    pm = [c for c in verdict["checks"] if c["check"] == "pixel_match_psnr"][0]
    print(f"pixel match against the JAX script's SR: worst {pm['value']} dB")
    assert rc == 0 and pm["ok"] and pm["threshold"] == 45.0


def test_missing_weights_fail(artifacts, capsys):
    rc = validate_parity.main(["--weights", str(artifacts["root"] / "nope.pth.tar"),
                               "--set5-lr", artifacts["lr_dir"], *COMMON])
    assert rc == 1
    assert "FAIL: weights not found" in capsys.readouterr().out
