#!/bin/bash
# The two-stage InEnv10 quality program on the port's CLIs: the port of
# tools/run_inenv10_program.sh.
#
# Stage 1: ESRNet training on the 10-source dataset (from scratch with
# elastic --resume auto); eval on both held-out sets.
# Stage 2: GAN continuation with the trunk-feature perceptual loss
# (--content-backbone trunk: no VGG weights needed); re-eval.
#
# It works in INENV10_ROOT (default: the repository root) and reads there
#   data/InEnv10/{train,eval/{GTmod4,LRbicx4},eval_src}   (tools.make_inenv_dataset)
#   data/InEnv10/eval_degraded/{GTmod4,LRx4}               (scripts.make_degraded_eval)
# and writes there results/ and samples/ (the checkpoints),
# results/inenv10_{s1,s2}.log, results/inenv10_scores.jsonl (one line a
# score: 4 tags x 2 sets) and assets/inenv10_{esrnet,esrgan}_ema.npz (the
# snapshots).  Run from the repository root these overwrite the committed
# snapshots, as the JAX program does; set INENV10_ROOT to keep a run apart.
# Environment: S1_BUDGET / S2_BUDGET (seconds a stage), S1_EPOCHS /
# S2_EPOCHS, PYTHON (the interpreter; default python).
set -u
REPO="$(cd "$(dirname "$0")/../.." && pwd)"
ROOT="${INENV10_ROOT:-$REPO}"
PY="${PYTHON:-python}"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
cd "$ROOT" || exit 1
mkdir -p results
SCORES=results/inenv10_scores.jsonl
: > "$SCORES"

# GPU lock: the bench (python -m real_esrgan_tpu_torch.bench) waits while
# this run holds the GPU, so it records no numbers taken mid-training.
LOCK="$("$PY" -c 'from real_esrgan_tpu_torch.bench import GPU_BUSY_LOCK; print(GPU_BUSY_LOCK)')"
echo "inenv10 $$ $(date +%s)" > "$LOCK"
trap 'rm -f "$LOCK"' EXIT

note() { echo "[inenv10 $(date +%H:%M:%S)] $*"; }

# run_stage <budget_s> <cmd...> — elastic restart loop.  The trainers are
# crash-recoverable by design (--resume auto / --resume-g auto picks up the
# newest checkpoint), and the rc=4 host-RAM failsafe (utils/hostmem.py) is an
# expected, non-fatal exit.  Loop until the stage finishes (rc=0), declares
# divergence (rc=3, not retryable), or the budget runs out (124).
run_stage() {
  local deadline=$(( $(date +%s) + $1 )); shift
  local rc attempt=0
  while :; do
    attempt=$((attempt + 1))
    local left=$(( deadline - $(date +%s) ))
    if [ "$left" -le 120 ]; then note "stage budget exhausted"; return 124; fi
    timeout "$left" "$@"; rc=$?
    case $rc in
      0|3) return $rc ;;
      124) note "stage hit its wall-clock budget"; return 124 ;;
    esac
    note "trainer exited rc=$rc (attempt $attempt); elastic resume in 15s"
    sleep 15
  done
}

score() { # score <tag> <weights> [extra eval_pair args...]
  local tag=$1 weights=$2; shift 2
  for set in degraded clean; do
    local lr hr
    if [ $set = degraded ]; then
      lr=data/InEnv10/eval_degraded/LRx4; hr=data/InEnv10/eval_degraded/GTmod4
    else
      lr=data/InEnv10/eval/LRbicx4; hr=data/InEnv10/eval/GTmod4
    fi
    note "eval $tag ($set)"
    local line
    line=$(timeout 2400 "$PY" -m real_esrgan_tpu_torch.scripts.eval_pair --weights "$weights" \
        --lr-dir $lr --hr-dir $hr "$@" 2>/dev/null | tail -1)
    echo "{\"tag\": \"$tag\", \"set\": \"$set\", \"result\": $line}" >> "$SCORES"
    echo "$tag/$set: $line"
  done
}

# Uniform 256px validation tiles (one eval shape); the trainer's
# per-saving-epoch NIQE eval reads these.
if [ ! -d data/InEnv10/valid ]; then
  "$PY" - <<'PYEOF'
import os
from real_esrgan_tpu_torch.utils.imgio import read_png, write_png
src, dst = "data/InEnv10/eval_src", "data/InEnv10/valid"
os.makedirs(dst, exist_ok=True)
for f in sorted(os.listdir(src)):
    img = read_png(os.path.join(src, f))
    h, w = img.shape[:2]
    if h < 256 or w < 256:
        continue
    t, l = (h - 256) // 2, (w - 256) // 2
    write_png(os.path.join(dst, f), img[t:t+256, l:l+256])
PYEOF
fi

# The stage-1 regime: train_clamp "none" (config default; the loss on the
# unclamped output); lr 1e-4 at batch 16; warmup 500 steps; abort-on-storm,
# so a diverged run exits rc=3 instead of burning its budget.
note "stage 1: ESRNet from scratch on InEnv10 (elastic resume auto)"
run_stage "${S1_BUDGET:-14400}" "$PY" -m real_esrgan_tpu_torch.train_realesrnet \
    --train-dir data/InEnv10/train --valid-dir data/InEnv10/valid \
    --test-lr-dir data/InEnv10/eval/LRbicx4 \
    --test-hr-dir data/InEnv10/eval/GTmod4 \
    --exp-name RealESRNet_inenv10 \
    --resume auto --epochs "${S1_EPOCHS:-700}" --batch-size 16 \
    --lr 1e-4 --warmup-steps 500 --abort-on-storm \
    --checkpoint-frequency 25 --no-tensorboard \
    >> results/inenv10_s1.log 2>&1
rc=$?
note "stage 1 rc=$rc (log tail below)"; tail -3 results/inenv10_s1.log
if [ $rc -ne 0 ] && [ ! -e results/RealESRNet_inenv10/g_best ]; then
  note "stage 1 failed with no checkpoint; aborting"; exit 1
fi

score s1_ema results/RealESRNet_inenv10/g_best
score s1_params results/RealESRNet_inenv10/g_best --use-params
"$PY" -m real_esrgan_tpu_torch.scripts.snapshot_weights \
    --checkpoint results/RealESRNet_inenv10/g_best \
    --output assets/inenv10_esrnet_ema.npz

note "stage 2: GAN with trunk-feature content loss"
run_stage "${S2_BUDGET:-9600}" "$PY" -m real_esrgan_tpu_torch.train_realesrgan \
    --train-dir data/InEnv10/train --valid-dir data/InEnv10/valid \
    --test-lr-dir data/InEnv10/eval/LRbicx4 \
    --test-hr-dir data/InEnv10/eval/GTmod4 \
    --exp-name RealESRGAN_inenv10 \
    --resume results/RealESRNet_inenv10/g_best --content-backbone trunk \
    --resume-g auto --resume-d auto \
    --lr 5e-5 --warmup-steps 200 --abort-on-storm \
    --epochs "${S2_EPOCHS:-70}" --batch-size 16 \
    --checkpoint-frequency 14 --no-tensorboard \
    >> results/inenv10_s2.log 2>&1
rc=$?
note "stage 2 rc=$rc (log tail below)"; tail -3 results/inenv10_s2.log
if [ $rc -ne 0 ] && [ ! -e results/RealESRGAN_inenv10/g_best ]; then
  note "stage 2 failed with no checkpoint; stopping before GAN evals"; exit 1
fi

score gan_ema results/RealESRGAN_inenv10/g_best
score gan_params results/RealESRGAN_inenv10/g_best --use-params
"$PY" -m real_esrgan_tpu_torch.scripts.snapshot_weights \
    --checkpoint results/RealESRGAN_inenv10/g_best \
    --output assets/inenv10_esrgan_ema.npz

note "done; scores:"
cat "$SCORES"
