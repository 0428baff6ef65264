"""Every entry point of the port that takes weights or a checkpoint, on an
Orbax directory of the JAX trainers, on the CPU:

* ``export_torch`` (the port's) writes the ``.pth.tar`` the root
  ``scripts/export_torch.py`` writes through JAX, tensor for tensor, from an
  Orbax directory, and the same payload from the port's own checkpoint;
* ``snapshot_weights``, ``inference``, ``test.py``, ``eval_pair`` and
  ``validate_parity`` load an Orbax directory, and give what they give
  from the same weights as an ``.npz``, bit for bit;
* the stage-1 trainer's ``--resume auto`` finds the JAX ``g_epoch_1`` in a
  samples folder and continues its step count;
* a directory of neither kind raises, naming both kinds.

The Orbax directories are the committed fixtures and a full-width 23-RRDB
one the JAX package writes here from ``assets/inenv10_esrnet_ema.npz``.
"""

import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
import torch

import _make_orbax_fixtures as fixtures
from real_esrgan_tpu.train.checkpoint import save_checkpoint as jax_save
from real_esrgan_tpu_torch import config as run_config
from real_esrgan_tpu_torch import inference, train_realesrnet
from real_esrgan_tpu_torch import test as port_test
from real_esrgan_tpu_torch.configuration import DegradationConfig, ModelConfig, PipelineGeometry
from real_esrgan_tpu_torch.configuration import TrainConfig
from real_esrgan_tpu_torch.scripts import eval_pair, export_torch, snapshot_weights
from real_esrgan_tpu_torch.scripts import validate_parity
from real_esrgan_tpu_torch.train import checkpoint as ckpt_lib
from real_esrgan_tpu_torch.utils.imgio import load_image_rgb, write_png

ROOT = fixtures.ROOT
NPZ = fixtures.NPZ
C64_B1 = os.path.join(fixtures.DATA, "g_c64_b1")

torch.set_num_threads(4)


def _tree(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A full-width Orbax g_ directory (EMA = the committed snapshot, params
    a perturbed copy), the snapshot cut to trunk_0, and small LR/HR pairs."""
    root = tmp_path_factory.mktemp("orbax_cli")
    with np.load(NPZ) as data:
        flat = {k: data[k].astype(np.float32) for k in data.files}
    params = {k: v + np.float32(0.25) for k, v in flat.items()}
    orbax = str(root / "g_epoch_7")
    jax_save(orbax, {"epoch": 7, "best_niqe": 4.5, "step": np.int32(70),
                     "params": _tree(params), "ema_params": _tree(flat)})
    cut = str(root / "c64_b1.npz")
    with np.load(NPZ) as data:
        np.savez(cut, **{k: data[k] for k in data.files
                         if not k.startswith("trunk_") or k.startswith("trunk_0/")})
    lr_dir, hr_dir = root / "lr", root / "hr"
    lr_dir.mkdir()
    hr_dir.mkdir()
    tree_lr = (load_image_rgb(os.path.join(ROOT, "tests", "data", "tree_lr.png")) * 255
               ).round().astype(np.uint8)
    set5 = root / "set5_lr"  # 56 px: NIQE's 96 px blocks fit the x4 output
    set5.mkdir()
    for i, (y, x) in enumerate(((0, 0), (40, 96))):
        write_png(str(lr_dir / f"img{i}.png"), tree_lr[y:y + 28, x:x + 28])
        hr = np.repeat(np.repeat(tree_lr[y:y + 28, x:x + 28], 4, 0), 4, 1)
        write_png(str(hr_dir / f"img{i}.png"), hr)
        write_png(str(set5 / f"img{i}.png"), tree_lr[y:y + 56, x:x + 56])
    return {"orbax": orbax, "cut": cut, "lr": str(lr_dir), "hr": str(hr_dir), "root": root,
            "set5": str(set5), "flat": flat}


def _root_export_torch():
    spec = importlib.util.spec_from_file_location(
        "root_export_torch", os.path.join(ROOT, "scripts", "export_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _same_payload(ours, theirs):
    assert set(ours) == set(theirs)
    for key in ("epoch", "best_niqe", "optimizer", "scheduler"):
        assert ours[key] == theirs[key], key
    for part in ("state_dict", "ema_state_dict"):
        assert ours[part].keys() == theirs[part].keys()
        for k in theirs[part]:
            assert ours[part][k].dtype == theirs[part][k].dtype == torch.float32
            assert torch.equal(ours[part][k], theirs[part][k]), k


@pytest.mark.parametrize("which", ["g_c64_b1", "full_width"])
def test_export_torch_equals_the_root_script(weights, which, tmp_path):
    import argparse
    source = C64_B1 if which == "g_c64_b1" else weights["orbax"]
    ours, theirs = str(tmp_path / "port.pth.tar"), str(tmp_path / "jax.pth.tar")
    export_torch.main(["--checkpoint", source, "--output", ours])
    _root_export_torch().main(argparse.Namespace(checkpoint=source, output=theirs))
    mine = torch.load(ours, weights_only=True)
    _same_payload(mine, torch.load(theirs, weights_only=False))
    if which == "full_width":
        assert (mine["epoch"], mine["best_niqe"]) == (7, 4.5)
        # the EMA and the params differ, and each went where it belongs
        assert torch.equal(mine["state_dict"]["conv1.bias"] - 0.25,
                           mine["ema_state_dict"]["model.conv1.bias"])
    else:
        assert torch.equal(mine["state_dict"]["conv1.weight"],
                           mine["ema_state_dict"]["model.conv1.weight"])  # no EMA saved


def test_export_torch_of_the_ports_own_checkpoint(weights, tmp_path):
    loaded = ckpt_lib.load_checkpoint(weights["orbax"])
    port_dir = str(tmp_path / "g_best")
    ckpt_lib.save_checkpoint(port_dir, loaded)
    a, b = str(tmp_path / "a.pth.tar"), str(tmp_path / "b.pth.tar")
    export_torch.main(["--checkpoint", port_dir, "--output", a])
    export_torch.main(["--checkpoint", weights["orbax"], "--output", b])
    _same_payload(torch.load(a, weights_only=True), torch.load(b, weights_only=True))
    sd = torch.load(a, weights_only=True)["ema_state_dict"]
    ckpt_lib.load_generator_params(a)  # the export loads as weights again
    assert len(sd) == 702


def test_snapshot_weights_of_an_orbax_directory(weights, tmp_path):
    out = str(tmp_path / "snap.npz")
    snapshot_weights.main(["--checkpoint", weights["orbax"], "--output", out])
    with np.load(out) as snap, np.load(NPZ) as committed:
        assert sorted(snap.files) == sorted(committed.files)
        for k in committed.files:
            assert snap[k].dtype == np.float16
            np.testing.assert_array_equal(snap[k], committed[k], err_msg=k)
    raw = str(tmp_path / "raw.npz")
    snapshot_weights.main(["--checkpoint", weights["orbax"], "--output", raw, "--use-params",
                           "--float32"])
    with np.load(raw) as snap:
        np.testing.assert_array_equal(snap["conv1/bias"], weights["flat"]["conv1/bias"] + 0.25)


def test_inference_cli_on_an_orbax_directory(weights, tmp_path):
    lr = os.path.join(weights["lr"], "img0.png")
    outs = []
    for source in (weights["orbax"], NPZ):
        out = str(tmp_path / f"sr_{len(outs)}.png")
        inference.main(inference.build_parser().parse_args(
            ["--cpu", "--inputs_path", lr, "--output_path", out, "--weights_path", source]))
        outs.append(load_image_rgb(out))
    assert outs[0].shape == (112, 112, 3)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_test_cli_on_an_orbax_directory(weights, tmp_path, capsys):
    srs = []
    for source in (weights["orbax"], NPZ):
        sr_dir = tmp_path / f"sr{len(srs)}"
        port_test.main(port_test.build_parser().parse_args(
            ["--cpu", "--lr_dir", weights["lr"], "--hr_dir", weights["hr"],
             "--sr_dir", str(sr_dir), "--model_path", source]))
        srs.append([load_image_rgb(str(sr_dir / f"img{i}.png")) for i in range(2)])
    assert f"Loaded `{weights['orbax']}` weights." in capsys.readouterr().out
    for a, b in zip(*srs):
        np.testing.assert_array_equal(a, b)


def test_eval_pair_and_validate_parity_on_the_full_width_fixture(weights, capsys):
    """``g_c64_b1`` at --num-rrdb 1 scores as the .npz cut to trunk_0."""
    dirs = ["--lr-dir", weights["lr"], "--hr-dir", weights["hr"], "--cpu", "--num-rrdb", "1"]
    ours = eval_pair.main(["--weights", C64_B1, *dirs])
    assert ours == eval_pair.main(["--weights", weights["cut"], *dirs])
    assert ours["n"] == 2 and ours["which"] == "ema"
    capsys.readouterr()
    common = ["--set5-lr", weights["set5"], "--num-rrdb", "1", "--cpu", "--niqe-tol", "1000"]
    sr_dirs = [str(weights["root"] / "vp_orbax"), str(weights["root"] / "vp_npz")]
    assert validate_parity.main(["--weights", C64_B1, *common, "--sr-out-dir", sr_dirs[0]]) == 0
    assert validate_parity.main(["--weights", weights["cut"], *common,
                                 "--sr-out-dir", sr_dirs[1]]) == 0
    verdicts = [json.loads(line) for line in capsys.readouterr().out.splitlines()
                if line.startswith("{")]
    assert verdicts[0]["parity"] is True and verdicts[0]["checks"] == verdicts[1]["checks"]
    for name in ("img0.png", "img1.png"):
        np.testing.assert_array_equal(
            load_image_rgb(os.path.join(sr_dirs[0], "Set5", name)),
            load_image_rgb(os.path.join(sr_dirs[1], "Set5", name)))


def test_resume_auto_finds_the_jax_epoch_checkpoint(tmp_path, monkeypatch, capsys):
    """A JAX run's samples folder: ``--resume auto`` picks ``g_epoch_1``
    (the JAX fixture) and the run continues at step 1, epoch 1."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(run_config, "geometry", PipelineGeometry(hr_size=64, crop_size=32,
                                                                 scale=4))
    monkeypatch.setattr(run_config, "model", ModelConfig(**fixtures.NARROW_MODEL))
    monkeypatch.setattr(run_config, "degradation", DegradationConfig(usm_radius=13))
    monkeypatch.setattr(run_config, "train_esrnet", TrainConfig(
        batch_size=8, print_frequency=1, epochs=2, num_workers=2, use_bfloat16=False,
        grad_clip_norm=0.5))
    samples = os.path.join("samples", run_config.exp_name)
    os.makedirs(samples)
    shutil.copytree(os.path.join(fixtures.DATA, "esrnet_c16", "g_epoch_1"),
                    os.path.join(samples, "g_epoch_1"))
    assert ckpt_lib.find_latest_checkpoint(samples) == os.path.join(samples, "g_epoch_1")
    args = train_realesrnet.build_parser().parse_args(
        ["--cpu", "--synthetic", "--epochs", "2", "--batch-size", "8", "--steps-per-epoch",
         "2", "--no-tensorboard", "--resume", "auto"])
    train_realesrnet.main(args)
    assert f"Resumed from `{os.path.join(samples, 'g_epoch_1')}` at epoch 1." in \
        capsys.readouterr().out
    tree = ckpt_lib.load_checkpoint(os.path.join("results", run_config.exp_name, "g_last"))
    assert (tree["step"], tree["epoch"], int(tree["opt_state"]["count"])) == (3, 2, 3)
    assert float(tree["guard"]["lr_scale"]) == fixtures.START_LR_SCALE


def test_a_directory_of_neither_kind_raises_naming_both(tmp_path):
    with pytest.raises(ValueError, match="neither a checkpoint directory of the port .* nor "
                                         "an Orbax checkpoint directory"):
        ckpt_lib.load_checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match="nor an Orbax"):
        export_torch.main(["--checkpoint", str(tmp_path), "--output", str(tmp_path / "x")])
