"""The research tools on the card, in a temporary INENV10_ROOT: the crop set
and its degraded pairs, ``perf_lab``, ``tail_exp``, ``nan_probe`` with
``explode_analysis``, ``grad_probe`` and the two-stage program at one epoch
a stage.  About eight minutes on an H100.

Marked ``cuda``: each test skips without a CUDA device.  This file imports
no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_research.py
"""

import hashlib
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_card import (  # noqa: F401  (cuda is a fixture)
    RDBS_PER_FORWARD, ROOT, TREE_SR, WEIGHTS, Launches, assert_tail_beside, cuda, printed,
)
from real_esrgan_tpu_torch.ops.fused_rdb import pack_rdb_weights, rdb_plain
from real_esrgan_tpu_torch.train.checkpoint import load_generator_params
from real_esrgan_tpu_torch.utils.imgio import read_png, write_png

pytestmark = pytest.mark.cuda

# the crop set's shape (tools/make_inenv_dataset.py's regions, steps and
# --hopper-repeat 6 on the 1024 x 2048 tree and a 600 x 512 hopper)
HOPPER_SHAPE, HOPPER_SEED = (600, 512, 3), 16
INENV_CROPS = {"tree": 177, "hopper": 90}  # 3x24 + 3x35, 15 x 6
ITERS = 3
MFU_CEILING = 1.05
BF16_TOLERANCE = (2e-2, 2e-2)  # atol, rtol
PROGRAM = os.path.join(ROOT, "real_esrgan_tpu_torch", "tools", "run_inenv10_program.sh")
PROGRAM_ENV = {"S1_EPOCHS": "1", "S2_EPOCHS": "1", "S1_BUDGET": "300", "S2_BUDGET": "300"}
PROGRAM_TIMEOUT = 900.0
POISONED = "trunk.5.rdb1.conv1.weight"


def _within(out, ref, tolerance=BF16_TOLERANCE) -> bool:
    atol, rtol = tolerance
    out, ref = out.float(), ref.float()
    return bool(torch.isfinite(out).all()) and bool(((out - ref).abs() <= atol + rtol * ref.abs())
                                                    .all())


@pytest.fixture(scope="module")
def inenv10(tmp_path_factory):
    """``tools.make_inenv_dataset --textures`` on tree_sr.png and a seeded
    600 x 512 stand-in for the hopper photograph (the installed JPEG and the
    textures are absent on the card's machine: each texture is skipped),
    then ``scripts.make_degraded_eval`` on its eval_src with the flags of
    tests/test_torch_inenv10.py; the run's root."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from real_esrgan_tpu_torch.scripts import make_degraded_eval
    from real_esrgan_tpu_torch.tools import make_inenv_dataset

    tmp = tmp_path_factory.mktemp("research")
    data = tmp / "inenv10" / "data" / "InEnv10"
    hopper = str(tmp / "hopper_stand_in.png")
    write_png(hopper, np.random.default_rng(HOPPER_SEED).integers(0, 256, HOPPER_SHAPE,
                                                                  dtype=np.uint8))
    printed(make_inenv_dataset.main, ["--out", str(data), "--tree", TREE_SR, "--hopper", hopper,
                                      "--textures"])
    printed(make_degraded_eval.main, ["--gt-dir", str(data / "eval_src"), "--output-dir",
                                      str(data / "eval_degraded"), "--seed", "0", "--hr-size",
                                      "160", "--crop-size", "128"])
    return tmp / "inenv10"


def test_make_inenv_dataset_and_its_degraded_pairs_on_the_card(cuda, inenv10):
    """177 tree and 90 hopper crops beside any texture crops, two held-out
    sources with GTmod4/LRbicx4 pairs, aligned degraded pairs."""
    data = inenv10 / "data" / "InEnv10"
    train = sorted(os.listdir(data / "train"))
    counts = {src: sum(n.startswith(src + "_") for n in train) for src in INENV_CROPS}
    assert counts == INENV_CROPS
    pairs = {kind: sorted(os.listdir(data / "eval" / kind)) for kind in ("GTmod4", "LRbicx4")}
    assert pairs["GTmod4"] == pairs["LRbicx4"] == ["hopper_heldout.png", "tree_heldout.png"]
    degraded = {kind: sorted(os.listdir(data / "eval_degraded" / kind))
                for kind in ("GTmod4", "LRx4")}
    assert degraded["GTmod4"] == degraded["LRx4"] and degraded["LRx4"]


def test_perf_lab_on_the_card(cuda):
    """``tools.perf_lab all`` at the JAX defaults (batch 8, 256^2), then
    ``gen --no-subpixel``: every reading finite and above 0 (a FAILED
    degradation case fails), the matmul peak at most 1.05 x 989.4 TFLOP/s;
    on one input the four RDB formulations within the bf16 bound of
    ``rdb_plain``, and the bf16 generator with and without subpixel within
    it; gen launches the RDB kernel and the tail kernel."""
    from real_esrgan_tpu_torch.bench import H100_BF16_PEAK_TFLOPS
    from real_esrgan_tpu_torch.models import Generator
    from real_esrgan_tpu_torch.tools import perf_lab

    with Launches() as launched:
        result, _ = printed(perf_lab.main, ["all", "--iters", str(ITERS)])
        no_subpixel, _ = printed(perf_lab.main, ["gen", "--no-subpixel", "--iters", str(ITERS)])
    result["gen_no_subpixel"] = no_subpixel["gen"]
    records = [r for rs in result.values() for r in (rs if isinstance(rs, list) else [rs])]
    for record in records:
        rate = record.get("tflops", record.get("mp_per_s", record.get("ms")))
        assert "failed" not in record and rate is not None and math.isfinite(rate) and rate > 0, \
            record
    assert max(r["tflops"] for r in result["peak"]) <= MFU_CEILING * H100_BF16_PEAK_TFLOPS
    assert result["gen"]["fused_rdb_launches"] > 0 and not result["gen_no_subpixel"]["subpixel"]
    assert launched.tail > 0  # gen 3 a forward, gen --no-subpixel 1 (conv3)

    kernels, biases = perf_lab.rand_weights("cuda")
    x = (torch.rand((2, 64, 96, perf_lab.C), generator=torch.Generator().manual_seed(3))
         .to("cuda", torch.bfloat16))
    with torch.no_grad():
        ref = rdb_plain(x, pack_rdb_weights([k.permute(3, 2, 0, 1) for k in kernels], biases,
                                            perf_lab.C, perf_lab.G, torch.bfloat16))
        for name, fn in perf_lab.RDB_FORMS.items():
            assert _within(fn(kernels, biases, x), ref), name
        lr = torch.rand((1, 48, 64, 3), generator=torch.Generator().manual_seed(4)).cuda()
        outs = [Generator(dtype=torch.bfloat16, subpixel=subpixel, device="cuda",
                          generator=torch.Generator().manual_seed(0)).eval()(lr)
                for subpixel in (True, False)]
    assert _within(outs[1], outs[0])


def test_tail_exp_on_the_card(cuda):
    """``tools.tail_exp`` in its three modes: every time finite and above 0;
    ``conv_i8`` on the card bit-exact against the int64 sums on the CPU at
    every per-conv shape, on a small input."""
    from real_esrgan_tpu_torch.tools import tail_exp

    for mode in tail_exp.MODES:
        records, _ = printed(tail_exp.main, ["--mode", mode, "--iters", str(ITERS)])
        for record in records:
            times = [v for k, v in record.items() if k.endswith("ms")]
            assert times and all(math.isfinite(t) and t > 0 for t in times), (mode, record)
    gen = torch.Generator().manual_seed(5)
    for cin, cout in tail_exp.INT8_SHAPES:
        xq = torch.randint(-127, 128, (2, 16, 24, cin), generator=gen, dtype=torch.int8)
        kq = torch.randint(-127, 128, (3, 3, cin, cout), generator=gen, dtype=torch.int8)
        out = tail_exp.conv_i8(xq.cuda(), kq.cuda()).cpu()
        assert torch.equal(out, tail_exp.conv_i8_reference(xq, kq)), (cin, cout)


def test_nan_probe_and_explode_analysis_locate_a_poisoned_block_on_the_card(cuda, inenv10,
                                                                            tmp_path):
    """``tools.nan_probe`` for one epoch of the crop set at batch 16 and full
    width (16 steps); then ``dissect`` on the initial state with one weight
    of trunk.5 set to inf: the first non-finite output is in trunk.5, the
    artifacts are written; ``tools.explode_analysis`` reads them back and,
    in both dtypes, records non-finite outputs of conv3, the first in
    trunk.5.  Neither launches the RDB kernel (the training model runs
    rdb_plain), nor so the tail kernel."""
    from real_esrgan_tpu_torch import config as run_config
    from real_esrgan_tpu_torch.tools import explode_analysis, nan_probe

    train_dir, out = str(inenv10 / "data" / "InEnv10" / "train"), str(tmp_path / "nan_probe")
    argv = ["--train-dir", train_dir, "--epochs", "1", "--batch-size", "16", "--out", out]
    with Launches() as launched:
        result, _ = printed(nan_probe.main, argv)
        probe, state = nan_probe.build_probe(nan_probe.build_parser().parse_args(argv),
                                             result["steps"], torch.device("cuda"))
        state.params[POISONED][0, 0, 1, 1] = float("inf")
        up1, up2 = explode_analysis.replay_coins(probe.cfg.seed, 1, 0, run_config.degradation)
        names = sorted(os.listdir(train_dir))[:16]
        hr = torch.from_numpy(np.stack([read_png(os.path.join(train_dir, n))
                                        for n in names])).cuda()
        report, _ = printed(nan_probe.dissect, probe, state, hr, up1, up2, "step0_e1")
        explode, _ = printed(explode_analysis.main, ["--dir", out, "--step", "0", "--epoch", "1",
                                                     "--batch", "0"])
    assert launched.rdb == 0
    assert_tail_beside(launched)
    assert result["steps"] == 16
    first = (report.get("forward_nonfinite_layers") or [["none"]])[0][0]
    assert first.startswith("trunk.5"), first
    assert sorted(os.listdir(out)) == ["step0_e1.json", "step0_e1_hr_uint8.npy",
                                       "step0_e1_params.npz"]
    for dtype in ("bf16", "f32"):
        bad = explode[dtype]["nonfinite_outputs"]
        assert {"conv3", "conv3.0"} <= {name for name, _, _ in bad}, dtype
        assert bad and bad[0][0].startswith("trunk.5"), (dtype, bad[:3])


def test_grad_probe_on_the_card(cuda, inenv10):
    """``tools.grad_probe`` with the committed ESRNet weights, 2 draws of 8:
    one row a source of the crop set, all finite."""
    from real_esrgan_tpu_torch.tools import grad_probe

    train_dir = str(inenv10 / "data" / "InEnv10" / "train")
    rows, _ = printed(grad_probe.main, ["--weights", WEIGHTS, "--train-dir", train_dir,
                                        "--draws", "2", "--batch", "8"])
    assert sorted(rows) == sorted(grad_probe.group_by_source(train_dir))
    for src, row in rows.items():
        assert all(math.isfinite(v) for v in row.values()), (src, row)


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _log_tails(results) -> str:
    """The ends of the program's two stage logs, where they exist."""
    tails = ""
    for stage in ("s1", "s2"):
        path = results / f"inenv10_{stage}.log"
        if path.exists():
            with open(path) as f:
                tails += f"\n# {stage} log tail:\n" + f.read()[-3000:]
    return tails


def test_the_inenv10_program_on_the_card(cuda, inenv10, tmp_path):
    """``tools/run_inenv10_program.sh`` in the crop set's root at one epoch a
    stage: rc 0; 8 score lines (4 tags x 2 sets), each PSNR finite; both
    snapshots load; the committed ``assets/*.npz`` unchanged (SHA-256); its
    eval_pair runs launch the RDB kernel 69 times a pair
    (FUSED_RDB_LAUNCH_LOG)."""
    assets = {n: _sha256(os.path.join(ROOT, "assets", n))
              for n in sorted(os.listdir(os.path.join(ROOT, "assets"))) if n.endswith(".npz")}
    log = str(tmp_path / "fused_rdb_launches.jsonl")
    env = dict(os.environ, INENV10_ROOT=str(inenv10), PYTHON=sys.executable,
               FUSED_RDB_LAUNCH_LOG=log, GPU_BUSY_LOCK=str(tmp_path / "gpu_busy.lock"),
               **PROGRAM_ENV)
    run = subprocess.run(["bash", PROGRAM], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=PROGRAM_TIMEOUT)
    assert run.returncode == 0, run.stderr[-2000:] + _log_tails(inenv10 / "results")
    scores = []
    with open(inenv10 / "results" / "inenv10_scores.jsonl") as f:
        for line in f:
            try:
                scores.append(json.loads(line))
            except json.JSONDecodeError:  # an eval_pair run that printed no summary
                scores.append({"unparsed": line.strip()})
    assert len(scores) == 8 and {(s.get("tag"), s.get("set")) for s in scores} == {
        (t, s) for t in ("s1_ema", "s1_params", "gan_ema", "gan_params")
        for s in ("degraded", "clean")}, scores
    assert all(math.isfinite(s["result"]["psnr_mean"]) for s in scores), scores
    for name in ("inenv10_esrnet_ema.npz", "inenv10_esrgan_ema.npz"):
        assert load_generator_params(str(inenv10 / "assets" / name)), name
    assert {n: _sha256(os.path.join(ROOT, "assets", n)) for n in assets} == assets
    eval_pair = 0
    with open(log) as f:
        for line in f:
            entry = json.loads(line)
            if os.path.splitext(os.path.basename(entry["argv"][0]))[0] == "eval_pair":
                eval_pair += entry["launches"]
    data = inenv10 / "data" / "InEnv10"
    pairs = sum(len(os.listdir(data / d)) for d in ("eval_degraded/LRx4", "eval/LRbicx4"))
    assert eval_pair == 4 * RDBS_PER_FORWARD * pairs
