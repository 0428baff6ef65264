"""Port parity of the evaluation entry points on the CPU:
real_esrgan_tpu_torch/scripts/eval_pair.py against scripts/eval_pair.py, and
real_esrgan_tpu_torch/test.py against the root test.py.

Pairs: 224^2 HR crops of tests/data/tree_sr.png and their x1/4
``matlab_resize`` LR images (56^2), as 8-bit PNGs in a temp directory; the
committed trained weights assets/inenv10_esrnet_ema.npz at full depth (23
RRDBs).  Both CLIs are imported by path and run in process.

Bounds.  The CLIs print two decimals, so per-image numbers are compared as
printed (hence the 0.0001 of slack on each).

* PSNR: ``eval_pair`` runs the generator in bfloat16 in both packages (their
  default), within 0.02 dB per image; ``--bicubic`` is float32 on both sides,
  within 0.01 dB as printed and 1e-3 dB in the mean; ``test`` runs in
  float32, written pixels within one 8-bit level.
* NIQE end to end.  The generator's outputs are smooth, and there
  ``E[x^2] - mu^2`` in float32 is mostly rounding noise, so the score follows
  the last digits of the SR image: on the SAME float32 SR image of a 224^2
  crop (four 96^2 blocks) the two packages' scores differ by 0.106 (12.889
  against 12.783) and 0.028, and a float64 filter gives 12.969, further from
  both.  Larger crops do not cure it: at 392^2 (sixteen blocks) ``test`` in
  float32 (outputs equal to 2e-6) still differs by 0.04 and 0.07, and
  ``eval_pair`` in bfloat16 by 0.30 and 0.27.  So on the generator's outputs
  ``test`` is held to 0.15 per image and in the mean, and ``eval_pair`` in
  bfloat16, where the two generators round at other places (outputs differ
  by half an 8-bit level in the mean, PSNR by under 0.02 dB), to 0.75.
* NIQE wiring (border crop, batch axis, the clamp to 100, the means).  Held
  apart from the generator's rounding, on 488 x 584 images (thirty blocks)
  whose scores are well conditioned: ``eval_pair --bicubic`` on both sides,
  and the two ``test`` CLIs with ``SRPipeline`` replaced by one stand-in that
  answers both with the same float32 array.  There the packages agree to
  0.006 (measured), held to 0.01, as printed and in the mean; a border crop
  of 0 in place of 4 moves these scores by 0.03 and 0.07.  The tight parity
  of the NIQE module itself is tests/test_torch_niqe.py's, on the whole
  1024 x 2048 image (1e-3).
"""

import argparse
import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

from real_esrgan_tpu_torch import test as port_test
from real_esrgan_tpu_torch.ops.resize import matlab_resize
from real_esrgan_tpu_torch.scripts import eval_pair as port_eval_pair
from real_esrgan_tpu_torch.utils.imgio import load_image_rgb, read_png, write_png

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "assets", "inenv10_esrnet_ema.npz")
TREE_SR = os.path.join(ROOT, "tests", "data", "tree_sr.png")
CROPS = {"bark_heldout_001.png": (400, 900), "leaf_heldout_002.png": (100, 300)}
WIDE = (488, 584)  # 5 x 6 blocks of 96^2 after the 4-pixel border crop


def load_by_path(name, *parts):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, *parts))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    base = tmp_path_factory.mktemp("pairs")
    lr_dir, hr_dir = base / "lr", base / "hr"
    lr_dir.mkdir(), hr_dir.mkdir()
    tree = read_png(TREE_SR)
    for name, (top, left) in CROPS.items():
        hr = np.ascontiguousarray(tree[top:top + 224, left:left + 224])
        lr = matlab_resize(torch.from_numpy(hr.astype(np.float32) / 255.0), 0.25).numpy()
        write_png(str(hr_dir / name), hr)
        write_png(str(lr_dir / name), np.clip(np.round(lr * 255.0), 0, 255).astype(np.uint8))
    return str(lr_dir), str(hr_dir)


@pytest.fixture(scope="module")
def wide_pairs(tmp_path_factory):
    """The same two sources at 488 x 584 with their x1/4 LR images, and the
    MATLAB-bicubic x4 of each LR image keyed by the LR image's bytes."""
    base = tmp_path_factory.mktemp("wide_pairs")
    lr_dir, hr_dir = base / "lr", base / "hr"
    lr_dir.mkdir(), hr_dir.mkdir()
    tree = read_png(TREE_SR)
    upscaled = {}
    for name, (top, left) in CROPS.items():
        hr = np.ascontiguousarray(tree[top:top + WIDE[0], left:left + WIDE[1]])
        lr = matlab_resize(torch.from_numpy(hr.astype(np.float32) / 255.0), 0.25).numpy()
        write_png(str(hr_dir / name), hr)
        write_png(str(lr_dir / name), np.clip(np.round(lr * 255.0), 0, 255).astype(np.uint8))
        lr = load_image_rgb(str(lr_dir / name))
        upscaled[lr.tobytes()] = matlab_resize(torch.from_numpy(lr), 4.0).clamp(0, 1).numpy()
    return str(lr_dir), str(hr_dir), upscaled


def parse_eval_pair(out):
    """{file: (psnr, niqe)} and the summary of one eval_pair run's output."""
    lines = out.strip().splitlines()
    rows = {}
    for line in lines[:-1]:
        m = re.fullmatch(r"(\S+): PSNR\s+([\d.]+) dB  NIQE\s+([\d.]+)", line)
        assert m, line
        rows[m.group(1)] = (float(m.group(2)), float(m.group(3)))
    return rows, json.loads(lines[-1])


@pytest.mark.parametrize("flags", [["--weights", WEIGHTS], ["--bicubic"]], ids=["ema", "bicubic"])
def test_eval_pair_matches_jax(pairs, capsys, flags):
    lr_dir, hr_dir = pairs
    argv = [*flags, "--lr-dir", lr_dir, "--hr-dir", hr_dir, "--cpu"]
    load_by_path("jax_eval_pair", "scripts", "eval_pair.py").main(argv)
    ref_rows, ref_summary = parse_eval_pair(capsys.readouterr().out)
    summary = port_eval_pair.main(argv)
    rows, printed = parse_eval_pair(capsys.readouterr().out)

    assert printed == summary and sorted(rows) == sorted(ref_rows) == sorted(CROPS)
    bicubic = "--bicubic" in flags
    for name in CROPS:
        assert abs(rows[name][0] - ref_rows[name][0]) <= (0.0101 if bicubic else 0.0201), name
        assert abs(rows[name][1] - ref_rows[name][1]) <= (0.0501 if bicubic else 0.75), name
    assert set(summary) == set(ref_summary) and summary["n"] == ref_summary["n"] == 2
    assert summary["which"] == ref_summary["which"] == ("bicubic" if bicubic else "ema")
    assert abs(summary["psnr_mean"] - ref_summary["psnr_mean"]) <= (1e-3 if bicubic else 0.02)
    assert abs(summary["niqe_mean"] - ref_summary["niqe_mean"]) <= (0.05 if bicubic else 0.75)
    assert sorted(summary["psnr_by_source"]) == ["bark", "leaf"]


def test_eval_pair_niqe_wiring_matches_jax_on_thirty_block_images(wide_pairs, capsys):
    lr_dir, hr_dir, _ = wide_pairs
    argv = ["--bicubic", "--lr-dir", lr_dir, "--hr-dir", hr_dir, "--cpu"]
    load_by_path("jax_eval_pair", "scripts", "eval_pair.py").main(argv)
    ref_rows, ref_summary = parse_eval_pair(capsys.readouterr().out)
    summary = port_eval_pair.main(argv)
    rows, _ = parse_eval_pair(capsys.readouterr().out)
    for name in CROPS:
        assert abs(rows[name][0] - ref_rows[name][0]) <= 0.0101, name
        assert abs(rows[name][1] - ref_rows[name][1]) <= 0.0101, name
    assert abs(summary["psnr_mean"] - ref_summary["psnr_mean"]) <= 1e-3
    assert abs(summary["niqe_mean"] - ref_summary["niqe_mean"]) <= 0.01


def test_test_cli_niqe_wiring_matches_jax_on_the_same_outputs(wide_pairs, tmp_path, capsys,
                                                              monkeypatch):
    lr_dir, hr_dir, upscaled = wide_pairs

    class SameOutputs:
        """Stands in for both packages' SRPipeline: the bicubic x4 image."""

        def __init__(self, *args, **kwargs):
            pass

        def upscale(self, lr):
            return upscaled[np.ascontiguousarray(lr, np.float32).tobytes()]

    jax_cli = load_by_path("jax_test_cli", "test.py")
    monkeypatch.setattr(jax_cli, "SRPipeline", SameOutputs)
    monkeypatch.setattr(port_test, "SRPipeline", SameOutputs)
    common = dict(lr_dir=lr_dir, hr_dir=hr_dir, model_path=WEIGHTS, upscale_factor=4,
                  bfloat16=False)
    ref_avg = jax_cli.main(argparse.Namespace(
        sr_dir=str(tmp_path / "jax"), niqe_model_path=jax_cli.DEFAULT_MODEL_PATH, **common))
    ref_lines = capsys.readouterr().out.strip().splitlines()
    avg = port_test.main(port_test.build_parser().parse_args(
        ["--lr_dir", lr_dir, "--hr_dir", hr_dir, "--sr_dir", str(tmp_path / "port"),
         "--model_path", WEIGHTS, "--cpu"]))
    lines = capsys.readouterr().out.strip().splitlines()

    assert abs(avg - ref_avg) <= 0.01
    assert len(lines) == len(ref_lines) == 5
    pattern = r"\[(\d)/2\] (\S+)  NIQE\s+([\d.]+)  PSNR\s+([\d.]+) dB"
    for ours, ref in zip(lines[1:3], ref_lines[1:3]):
        a, b = re.fullmatch(pattern, ours), re.fullmatch(pattern, ref)
        assert a and b and a.group(1, 2, 4) == b.group(1, 2, 4)
        assert abs(float(a.group(3)) - float(b.group(3))) <= 0.0101
    assert lines[4] == ref_lines[4]
    for name in CROPS:  # both wrote the 8-bit image of the same array
        assert np.array_equal(read_png(str(tmp_path / "port" / name)),
                              read_png(str(tmp_path / "jax" / name)))


def test_test_cli_matches_jax(pairs, tmp_path, capsys):
    lr_dir, hr_dir = pairs
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    common = dict(lr_dir=lr_dir, hr_dir=hr_dir, model_path=WEIGHTS, upscale_factor=4,
                  bfloat16=False)
    jax_cli = load_by_path("jax_test_cli", "test.py")
    ref_avg = jax_cli.main(argparse.Namespace(
        sr_dir=jax_dir, niqe_model_path=jax_cli.DEFAULT_MODEL_PATH, **common))
    ref_lines = capsys.readouterr().out.strip().splitlines()
    avg = port_test.main(port_test.build_parser().parse_args(
        ["--lr_dir", lr_dir, "--hr_dir", hr_dir, "--sr_dir", port_dir, "--model_path", WEIGHTS,
         "--cpu"]))
    lines = capsys.readouterr().out.strip().splitlines()

    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir)) == sorted(CROPS)
    for name in CROPS:
        ours = read_png(os.path.join(port_dir, name)).astype(int)
        ref = read_png(os.path.join(jax_dir, name)).astype(int)
        assert ours.shape == ref.shape == (224, 224, 3)
        assert np.abs(ours - ref).max() <= 1, name
    assert abs(avg - ref_avg) <= 0.15
    assert len(lines) == len(ref_lines) == 5
    assert lines[0] == ref_lines[0] == f"Loaded `{WEIGHTS}` weights."
    for ours, ref in zip(lines[1:3], ref_lines[1:3]):
        pattern = r"\[(\d)/2\] (\S+)  NIQE\s+([\d.]+)  PSNR\s+([\d.]+) dB"
        a, b = re.fullmatch(pattern, ours), re.fullmatch(pattern, ref)
        assert a and b and a.group(1, 2) == b.group(1, 2)
        assert abs(float(a.group(3)) - float(b.group(3))) <= 0.1501
        assert abs(float(a.group(4)) - float(b.group(4))) <= 0.0101
    assert re.fullmatch(r"NIQE:\s+[\d.]+ 100u", lines[3]) and re.fullmatch(r"NIQE:\s+[\d.]+ 100u",
                                                                            ref_lines[3])
    assert re.fullmatch(r"PSNR:\s+[\d.]+ dB \(2 pairs\)", lines[4])
    assert ref_lines[4].endswith("(2 pairs)")


def test_test_cli_without_ground_truth_ends_with_the_niqe_line(pairs, tmp_path, capsys):
    lr_dir, _ = pairs
    args = port_test.build_parser().parse_args(
        ["--lr_dir", lr_dir, "--hr_dir", str(tmp_path / "none"), "--sr_dir", str(tmp_path / "sr"),
         "--model_path", WEIGHTS, "--bfloat16", "--cpu"])
    avg = port_test.main(args)
    lines = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"NIQE:\s+[\d.]+ 100u", lines[-1]) and "PSNR" not in "".join(lines)
    assert 0.0 < avg <= 100.0 and f"{avg:4.2f}" in lines[-1]


def test_cli_defaults_and_refusals(tmp_path):
    args = port_test.build_parser().parse_args([])
    assert (args.lr_dir, args.sr_dir, args.hr_dir, args.upscale_factor, args.bfloat16, args.cpu) == \
        ("./data/Set5/LRbicx4", "./results/test/RealESRNet_baseline", "./data/Set5/GTmod12", 4,
         False, False)
    empty = tmp_path / "empty"
    empty.mkdir()
    args = port_test.build_parser().parse_args(
        ["--lr_dir", str(empty), "--sr_dir", str(tmp_path / "sr"), "--cpu"])
    with pytest.raises(FileNotFoundError):
        port_test.main(args)
    dirs = ["--lr-dir", str(empty), "--hr-dir", str(empty), "--cpu"]
    with pytest.raises(SystemExit):
        port_eval_pair.main(dirs)  # no --weights and no --bicubic
    with pytest.raises(ValueError, match="Orbax"):
        port_eval_pair.main(["--weights", str(empty), *dirs])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_eval_pair.main(["--bicubic", "--lr-dir", str(empty), "--hr-dir", str(empty)])


def test_meters_print_what_the_jax_package_prints(capsys):
    from real_esrgan_tpu.utils import meters as jax_meters
    from real_esrgan_tpu_torch.utils import meters

    printed = []
    for module in (meters, jax_meters):
        loss = module.AverageMeter("Loss", ":6.3f")
        count = module.AverageMeter("N", ".0f", summary_mode="count")
        quiet = module.AverageMeter("Q", "f", summary_mode="none")
        for value, n in ((0.5, 2), (0.25, 6)):
            loss.update(value, n)
        count.update(3)
        progress = module.ProgressMeter(120, [loss, count, quiet], prefix="Epoch: [3]")
        progress.display(7)
        progress.display_summary()
        loss.reset()
        progress.display(8)
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]
    assert printed[0].splitlines()[0] == "Epoch: [3][  7/120]\tLoss  0.250 ( 0.312)\tN 3 (3)\tQ 0.000000 (0.000000)"
