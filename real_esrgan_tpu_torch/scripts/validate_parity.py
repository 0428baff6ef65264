"""One-command quality-parity validation against the reference's published
results: the port of ``scripts/validate_parity.py``.

    python -m real_esrgan_tpu_torch.scripts.validate_parity \\
        --weights results/pretrained_models/RealESRGAN_x4-DFO2K.pth.tar \\
        --model realesrgan \\
        --set5-lr data/Set5/LRbicx4  --set14-lr data/Set14/LRbicx4 \\
        [--reference-sr-dir <another stack's SR outputs for pixel match>] [--cpu]

Checks (each only when its inputs were provided):
  1. NIQE table vs the published numbers, within --niqe-tol.
  2. Pixel match vs another stack's own SR outputs of the Set5 inputs:
     per-image PSNR must reach --pixel-match-psnr.

``--inenv`` instead scores a trained checkpoint against the InEnv10
held-out sets and their recorded no-model baselines.  Prints a human table
plus ONE machine-readable JSON verdict line and exits 0 on PASS / 1 on
FAIL.  Runs on the GPU in bfloat16; ``--cpu`` runs on the CPU in float32.
Weights: ``.pth.tar``, ``.npz`` or a checkpoint directory of the port's
trainers or the JAX trainers' Orbax one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from real_esrgan_tpu_torch.metrics.niqe import NIQE
from real_esrgan_tpu_torch.serve import SRPipeline
from real_esrgan_tpu_torch.utils.imgio import (
    array_to_image, load_image_rgb, natsorted_files, save_image_rgb,
)

# Published NIQE results of the reference README (lower = better).
PUBLISHED = {
    "realesrnet": {"Set5": 9.80, "Set14": 7.08},
    "realesrgan": {"Set5": 7.09, "Set14": 4.74},
}


def mean_niqe(pipeline, niqe_model, lr_dir: str, sr_out_dir: str = "") -> float:
    files = natsorted_files(lr_dir)
    if not files:
        raise FileNotFoundError(f"no images in {lr_dir}")
    total = 0.0
    for path in files:
        sr = pipeline.upscale(load_image_rgb(path))[None]
        total += min(float(niqe_model(sr)[0]), 100.0)
        if sr_out_dir:
            os.makedirs(sr_out_dir, exist_ok=True)
            save_image_rgb(os.path.join(sr_out_dir, os.path.basename(path)),
                           array_to_image(sr))
    return total / len(files)


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b) ** 2))
    return 10 * np.log10(1.0 / mse) if mse > 0 else 99.0


def pixel_match(pipeline, lr_dir: str, ref_sr_dir: str) -> float:
    """Worst-case PSNR (dB) between this stack's SR and another stack's SR
    outputs for the same (natural-sorted) inputs."""
    worst = float("inf")
    for path in natsorted_files(lr_dir):
        ref_path = os.path.join(ref_sr_dir, os.path.basename(path))
        if not os.path.exists(ref_path):
            raise FileNotFoundError(f"reference SR missing: {ref_path}")
        ours = pipeline.upscale(load_image_rgb(path))
        ref = load_image_rgb(ref_path)
        if ours.shape != ref.shape:
            return 0.0
        worst = min(worst, _psnr(ours, ref))
    return worst


def mean_pair_psnr(pipeline, lr_dir: str, hr_dir: str) -> tuple:
    """(mean PSNR dB, n) over same-named (LR, HR) pairs."""
    psnrs = []
    for path in natsorted_files(lr_dir):
        hr_path = os.path.join(hr_dir, os.path.basename(path))
        if not os.path.exists(hr_path):
            continue
        sr = pipeline.upscale(load_image_rgb(path))
        hr = load_image_rgb(hr_path)
        if sr.shape != hr.shape:
            raise ValueError(f"{path}: SR {sr.shape} vs HR {hr.shape}")
        psnrs.append(_psnr(sr, hr))
    if not psnrs:
        raise FileNotFoundError(f"no (LR, HR) pairs under {lr_dir} / {hr_dir}")
    return float(np.mean(psnrs)), len(psnrs)


def _report(verdict: dict, path: str) -> int:
    line = json.dumps(verdict)
    print(line)
    if path:
        with open(path, "w") as f:
            f.write(line + "\n")
    return 0 if verdict["parity"] else 1


def run_inenv(a, pipeline: SRPipeline) -> int:
    """--inenv: score a trained checkpoint against the InEnv10 held-out sets
    and the recorded no-model baselines.  The blind task is the degraded-LR
    set: PASS iff the model beats the bicubic PSNR there.  The clean-bicubic
    set is reported informationally (blind-SR models are expected to lose to
    bicubic on clean LR)."""
    with open(a.inenv_baselines) as f:
        baselines = json.load(f)

    checks = []
    deg = baselines["degraded_lr"]
    psnr, n = mean_pair_psnr(pipeline, deg["lr_dir"], deg["hr_dir"])
    ok = psnr > deg["psnr_mean"]
    checks.append({"check": "inenv_degraded_psnr", "value": round(psnr, 3),
                   "baseline_bicubic": deg["psnr_mean"], "n": n, "ok": ok})
    print(f"InEnv10 degraded-LR (blind task): PSNR {psnr:.3f} dB over {n} tiles vs bicubic "
          f"{deg['psnr_mean']:.3f} dB -> {'PASS' if ok else 'FAIL'}")

    clean = baselines["clean_bicubic_lr"]
    cpsnr, cn = mean_pair_psnr(pipeline, clean["lr_dir"], clean["hr_dir"])
    niqe_model = NIQE(crop_border=a.upscale_factor, device=pipeline.device)
    cniqe = mean_niqe(pipeline, niqe_model, clean["lr_dir"])
    checks.append({"check": "inenv_clean_informational", "psnr": round(cpsnr, 3),
                   "niqe": round(cniqe, 3), "baseline_psnr": clean["psnr_mean"],
                   "baseline_niqe": clean["niqe_mean"], "n": cn, "ok": True,
                   "note": "informational: blind-SR loses to bicubic on clean LR"})
    print(f"InEnv10 clean-LR (informational): PSNR {cpsnr:.3f} dB / NIQE {cniqe:.3f} vs "
          f"bicubic {clean['psnr_mean']:.3f} dB / {clean['niqe_mean']}")
    return _report({"parity": all(c["ok"] for c in checks), "mode": "inenv",
                    "weights": a.weights, "checks": checks}, a.report)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--weights", default="",
                   help="generator weights (.pth.tar, .npz or a checkpoint directory)")
    p.add_argument("--inenv", action="store_true",
                   help="score --weights (default: the InEnv10 stage-1 g_best) against the "
                        "InEnv10 held-out sets and the recorded baselines JSON instead of "
                        "the published Set5/Set14 table")
    p.add_argument("--inenv-baselines", default="docs/inenv10_baselines.json")
    p.add_argument("--model", choices=sorted(PUBLISHED), default="realesrgan",
                   help="which published row to compare against")
    p.add_argument("--set5-lr", default="", help="Set5 LRbicx4 directory")
    p.add_argument("--set14-lr", default="", help="Set14 LRbicx4 directory")
    p.add_argument("--reference-sr-dir", default="",
                   help="another stack's SR outputs for the Set5 inputs "
                        "(enables the pixel-match check)")
    p.add_argument("--niqe-tol", type=float, default=0.30,
                   help="allowed NIQE excess over the published value")
    p.add_argument("--pixel-match-psnr", type=float, default=45.0,
                   help="min per-image PSNR (dB) vs the other stack's SR")
    p.add_argument("--num-rrdb", type=int, default=23)
    p.add_argument("--upscale-factor", type=int, default=4)
    p.add_argument("--sr-out-dir", default="", help="optionally save this stack's SR outputs here")
    p.add_argument("--report", default="", help="also write the JSON verdict here")
    p.add_argument("--cpu", action="store_true", help="run on the CPU, in float32")
    a = p.parse_args(argv)

    if a.inenv:
        a.weights = a.weights or "results/RealESRNet_inenv10/g_best"
    elif not a.weights:
        p.error("--weights is required (except in --inenv mode)")
    elif not (a.set5_lr or a.set14_lr or a.reference_sr_dir):
        p.error("nothing to check: provide --set5-lr/--set14-lr and/or --reference-sr-dir")
    elif a.reference_sr_dir and not a.set5_lr:
        p.error("--reference-sr-dir needs --set5-lr (the matching inputs)")
    if not os.path.exists(a.weights):
        print(f"FAIL: weights not found: {a.weights}")
        return 1
    pipeline = SRPipeline(weights_path=a.weights, num_rrdb=a.num_rrdb,
                          upscale_factor=a.upscale_factor, bfloat16=not a.cpu,
                          device="cpu" if a.cpu else None)
    if a.inenv:
        return run_inenv(a, pipeline)
    niqe_model = NIQE(crop_border=a.upscale_factor, device=pipeline.device)

    checks = []
    for name, lr_dir in (("Set5", a.set5_lr), ("Set14", a.set14_lr)):
        if not lr_dir:
            continue
        published = PUBLISHED[a.model][name]
        score = mean_niqe(pipeline, niqe_model, lr_dir,
                          os.path.join(a.sr_out_dir, name) if a.sr_out_dir else "")
        ok = score <= published + a.niqe_tol
        checks.append({"check": f"niqe_{name.lower()}", "value": round(score, 3),
                       "published": published, "tol": a.niqe_tol, "ok": ok})
        print(f"NIQE {name}: {score:.3f} vs published {published:.2f} "
              f"(+{a.niqe_tol} tol) -> {'PASS' if ok else 'FAIL'}")
    if a.reference_sr_dir:
        worst = float(pixel_match(pipeline, a.set5_lr, a.reference_sr_dir))
        ok = bool(worst >= a.pixel_match_psnr)
        checks.append({"check": "pixel_match_psnr", "value": round(worst, 2),
                       "threshold": a.pixel_match_psnr, "ok": ok})
        print(f"Pixel match: worst PSNR {worst:.2f} dB vs >= {a.pixel_match_psnr} dB -> "
              f"{'PASS' if ok else 'FAIL'}")
    return _report({"parity": all(c["ok"] for c in checks), "model": a.model,
                    "weights": a.weights, "checks": checks}, a.report)


if __name__ == "__main__":
    sys.exit(main())
