#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``real_esrgan_tpu_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, no arguments

1. prints the card's name and power limit, as nvidia-smi gives them;
2. builds the CUDA kernels of the port from ``real_esrgan_tpu_torch/csrc``
   with nvcc (one process a source, all at once), printing each source's
   build seconds, registers, spills and shared memory, the tensor-core, TMA,
   mbarrier and shared-memory instructions of each kernel as ``cuobjdump
   -sass`` shows them (the bf16 RDB kernel, every ``mm_grid``, every
   ``mm_resident`` and every ``conv3x3`` kernel must have ``HGMMA`` and
   ``UTMALDG`` and no ``HMMA``, the f32 RDB kernel ``HMMA``; neither RDB
   kernel, nor ``conv3x3``, nor ``mm_resident`` may have ``LDL``/``STL``; no
   build may warn C7520, serialised ``wgmma``), the RDB kernels' block plan
   (``rdb_plan``: tile, threads, shared memory, ring), ``mm_grid``'s and
   ``mm_resident``'s at the gate's shapes (``mm_grid_plan``,
   ``mm_resident_plan``) and ``conv3x3``'s at the tool's default shape
   (``conv3x3_plan``), each beside what the built library reports;
3. drives the x4 serving path: ``SRPipeline`` with
   ``assets/inenv10_esrnet_ema.npz`` answers requests in bfloat16 and in
   float32 (the whole test image, a bucketed crop, a tiled wide image, and
   the ragged crop the committed JAX golden output covers), with every
   kernel's launch count set to 0 just before and read just after, and the
   shape of every input the RDB kernel and the tail kernel get recorded; one
   more forward of the test image in each dtype keeps the inputs of all 69
   RDBs;
4. checks the outputs: finite, in [0, 1], the f32 crop within 1e-4 of the
   JAX golden output, the bf16 crop's PSNR against it, and the tiled image's
   interior seam error against a whole-image forward; profiles one warm
   forward of the test image (device busy time, idle share, time by kernel);
5. drives the conv/matmul experiment tool (``tools/conv_exp.py``: default
   run, ``--mm``, ``--gate``, and the ``mm_grid`` probe) on the card, with the
   launch counts of ``conv3x3``, ``mm_grid`` and ``mm_resident`` set to 0
   just before and read just after, and holds those three kernels against
   their plain versions at every shape that run gave them, smaller and
   ragged ones, and ``mm_grid``, ``mm_resident`` and ``conv3x3`` to exact
   one-hot probes of their operand layouts (and ``mm_resident``'s k split);
6. drives the evaluation path: ``real_esrgan_tpu_torch.test`` (float32 and
   ``--bfloat16``) and ``scripts.eval_pair`` on three crops of the test
   image, recording the RDB kernel's input shapes here too, and NIQE of
   ``tests/data/tree_sr.png`` on the card against the committed JAX score
   and against the port's own CPU score, with TF32 allowed, so a filter that
   fell into TF32 would fail here;
7. holds the RDB kernel against its plain PyTorch version on the card, with
   the trained weights of several RDBs, at every shape the serving and the
   evaluation path gave it in each dtype, a ragged batch, a block smaller
   than a tile and a batch of three ragged images, and in each dtype on the
   real inputs of all 69 RDBs kept in step 3 (|x| up to about 59, where the
   f32 kernel's three bf16 products have the least room), and checks that
   it raises under autograd (it has no backward); holds the tail kernel
   (``ops/tail_epilogue.py::bias_lrelu``) against ``bias_lrelu_plain`` with
   ``torch.equal`` at every shape the serving path gave it in each dtype,
   and checks that it too raises under autograd;
8. drives the second-order degradation (``ops/degradation.py``, stock
   PyTorch ops, no kernel of its own) under PyTorch's default TF32 flags:
   at the CLI's geometry (hr 400 -> crop 256, batch 8) one CPU draw for
   each (up1, up2) applied on the CPU and on the card, and the JAX golden
   ``tests/data/jax_degrade_b2_hr128.npz`` applied on the card (at least 99%
   of the 8-bit LR values equal, LR PSNR >= 50 dB, HR crops bit-identical);
   ``python -m real_esrgan_tpu_torch.scripts.make_degraded_eval`` on the
   card on the 10 tiles of ``tests/data/tree_sr.png`` (10 aligned pairs,
   each degraded), scored by ``eval_pair`` with ``--bicubic`` and with the
   committed weights, and again with ``--cpu``: identical HR files and at
   least 99% equal LR values, since every draw of a batch comes from (seed,
   batch start) on the CPU; ``degrade`` (draw + apply) timed per batch at
   batch 8 and 48 for each (up1, up2), one batch of each size profiled, and
   the port's bf16 blur timed beside cuDNN's at batch 48;
9. drives the stage-1 trainer, ``python -m
   real_esrgan_tpu_torch.train_realesrnet``, in-process at full width,
   batch 48, hr 400 -> crop 256, bf16, remat, on 96 crops of
   ``tests/data/tree_sr.png`` with 3 validation images: ``--epochs 1``,
   then ``--epochs 2 --resume auto`` (the checkpoint must reach step 4,
   epoch 2); the RDB kernel launches no time in the training steps and 69
   times an image in validation; times ESRNet images/s over 8 steps after 3
   warm-up steps with the peak memory, splits one step into the
   degradation, the forward and backward and the guarded update, profiles
   one step, and holds one f32 update at 2 RRDBs on the card against the
   CPU (loss and grad norm within 1e-4 relative, TF32 off);
10. drives the trainers' data path on the same 96 crops, each ``--loader``
   choice through ``make_train_loader``: ``threads`` (with the decode
   cache), ``device`` (the pool on the card), ``native`` (the C++ loader,
   where it builds: else it prints why not) and ``grain`` (the resumable
   stream); the first epochs of threads, device and native are the same
   uint8 batches on the card, the grain stream's first batch is the CPU
   stream's, the pool sends only its int64 index vector a step; times the
   full-width stage-1 step fed by each loader through ``DevicePrefetcher``
   (images/s, the host's wait in ``next()``) beside two synthetic batches
   on the card, then the loaders again in the opposite order; and runs ``train_realesrnet --loader grain`` for
   one epoch, then two through ``--resume auto``: loader_state_p0.bin is
   written and restored, and the resumed run's first batch is the unbroken
   stream's;
11. drives the stage-2 trainer, ``python -m
   real_esrgan_tpu_torch.train_realesrgan``, in-process the same way, D at
   64 channels, warm-started from the committed ESRNet weights with the
   frozen-trunk content backbone: ``--epochs 1``, then ``--epochs 2
   --resume-g auto --resume-d auto`` (resumed at epoch 1; ``AsyncSaver``
   writes g_epoch_1 and d_epoch_1, which load back); the RDB kernel launches
   no time in the G+D steps and 69 times an image in validation; serves
   g_last's EMA as an ``.npz`` snapshot against the checkpoint itself (PSNR
   >= 40 dB); times GAN images/s with the random VGG19 backbone over 8 steps
   after 3 with the peak memory, splits one step into the degradation, G's
   forward and backward and update, D's forward and backward and update,
   profiles one step, and holds one f32 G+D update at 2 RRDBs on the card
   against the CPU (loss terms, grad norms and D's sigmas within 1e-4
   relative, TF32 off);
12. drives data parallelism (``parallel/mesh.py``): a one-rank NCCL group
   on the card (``all_reduce_mean`` of the full-width generator's gradients
   run through NCCL and timed; two full-width stage-1 steps with the group
   up bit-identical to the same steps with none, cuDNN held deterministic
   for both); two ranks sharing the card over gloo (``tools/dp_check.py``'s
   ``card`` preset: one stage-1 step and one G+D step at 24 a rank against
   the single-process step at 48 on the same crops and draws, 2 RRDBs x 64,
   D 64, VGG19 to conv5_4, f32, TF32 off: losses and grad norms within 1e-4
   relative, both ranks' parameters, EMA and D ``u`` the same bits), then the
   stage-1 CLI at full width as two ranks, each in its own working
   directory, for one epoch and again with ``--resume auto`` (both ranks
   print the resumed epoch, rank 1 writes no checkpoint); the draws of the
   global batch against a rank's (batch 48 and 24, timed); and tiled serving
   over two replicas on the one card (``devices=[cuda:0, cuda:0]``) on the
   wide image against one device: f32 the same bits, bf16 within the seam
   bound and 40 dB of the one-device output, the RDB kernel's launches
   counted;
13. drives the front end: ``utils.profiling.trace`` around one bf16
   forward (the Chrome trace names the bf16 RDB kernel) and ``StepTimer``
   over five; the HTTP server (``scripts/serve_http.py``, bf16, the
   committed weights, warmup 256) on 127.0.0.1 answering the test image and
   the wide (tiled) image, each PNG the bits of ``SRPipeline.upscale``
   quantised alike, ``/healthz`` and ``/stats``; ``python -m
   real_esrgan_tpu_torch.bench --mode all --iters 3`` in a subprocess (four
   lines, the flagship last, every rate finite and above 0, a FLOP count
   and an mfu of at most 1.05 on each, the tiled count over every tile
   batch); ``graft_entry.entry()`` on the card and ``dryrun_multichip(2)``;
   ``scripts.make_lr`` on the card over three crops of
   ``tests/data/tree_sr.png``, then ``scripts.validate_parity`` on the card
   against a ``--cpu`` run's outputs (pixel match at 40 dB); and
   ``tools.tile_sweep --combos "528,8,8;272,8,16" --seam``; the RDB
   kernel's launches counted on every path;
14. times each kernel against its plain version, its bound and, where one
   PyTorch call computes the same function, that call (K1 and its plain
   version, K2 and cuDNN, K3, K4 and cuBLAS also inside a CUDA graph,
   without the host's gaps; the tail kernel and its plain version at the
   bf16 batch cell's upconv2 shape and the f32 tree image's), and prints
   one JSON line ``{"kernels": [...]}``; the last line is
   ``{"ok": true, "device": {...}}``;
15. before step 14's ``kernels`` line, drives the research tools in a
   temporary directory: ``tools.make_inenv_dataset --textures`` on
   ``tests/data/tree_sr.png`` and a seeded 600 x 512 stand-in for the hopper
   photograph (177 tree and 90 hopper crops, two held-out sources with their
   pairs; a texture it cannot read is skipped) and
   ``scripts.make_degraded_eval`` on them; ``tools.perf_lab all`` at batch 8 x
   256^2 and ``gen --no-subpixel`` (every reading finite and above 0, the
   matmul peak at most 1.05 x 989.4 TFLOP/s, the four RDB formulations and
   the generator without subpixel within the bf16 bound of ``rdb_plain`` and
   of the generator); ``tools.tail_exp`` in its three modes (``conv_i8`` on the
   card bit-exact against int64 sums on the CPU); ``tools.nan_probe`` for one
   epoch at batch 16 and full width, then ``dissect`` with one weight of
   trunk.5 set to inf (located in trunk.5, artifacts written) and
   ``tools.explode_analysis`` on them in both dtypes; ``tools.grad_probe``
   (one finite row a source); and ``tools/run_inenv10_program.sh`` at one
   epoch a stage in that directory (rc 0, 8 finite scores, both snapshots
   load, the committed ``assets/*.npz`` unchanged); the RDB kernel's launches
   of ``perf_lab gen`` and of the program's CLIs (``FUSED_RDB_LAUNCH_LOG``)
   join ``fused_rdb_launches`` and the ``kernels`` line;
17. after the autograd guard, before the Orbax phase, SwinIR-L
   (``SRPipeline(arch="swinir_l")``, the benchmark's configuration and
   seeded weights) serves the test image whole and the wide image in
   528/8/8 tiles in bfloat16 and float32, each against the plain reference
   (``benchmark/reference/swinir.py``) on the same geometry: float32 within
   SWINIR_F32_BOUND, bf16 within the ``swinir_l.batch256`` cell's
   ``out_err_ratio`` limit; 54 window-attention and 3 tail-kernel launches a
   forward; the ``kernels`` line times the window-attention kernel at that
   cell's shape in both dtypes against ``window_attn_plain`` and its byte
   bound;
16. after the autograd guard, the Orbax phase: builds the port's zstd
   decoder (``csrc/zstd_decode.cpp``, g++) and prints its build line; reads
   every checkpoint fixture of ``tests/data/jax_orbax`` (the JAX trainers'
   Orbax directories) and holds each leaf to ``leaves.json``; serves the
   test image through ``SRPipeline`` from the full-width one-RRDB Orbax
   directory ``g_c64_b1`` in bfloat16 and float32 (3 RDB kernel launches
   each, counted) and holds the output, bit for bit, to the same pipeline
   loaded from ``assets/inenv10_esrnet_ema.npz`` cut to ``trunk_0``; runs
   ``python -m real_esrgan_tpu_torch.scripts.eval_pair`` on that directory
   and the evaluation pairs of step 6 (its launches through
   ``FUSED_RDB_LAUNCH_LOG``); resumes the narrow stage-1 and stage-2 states
   on the card through the trainers' ``resume_state`` /
   ``resume_generator`` / ``resume_discriminator`` and takes one float32
   step each (finite losses; ``step``, Adam's ``count`` and the guard's
   ``lr_scale`` carry on from the JAX values); and times the decoder on
   every zstd frame of the fixtures for at least a second (MB/s on this
   host).

On every in-process path that runs the generator, the tail kernel's
launches are counted beside the RDB kernel's: TAIL_PER_FORWARD a forward
under no_grad, none in a training step (``bias_lrelu_launches``; the
subprocesses of the bench, the program's CLIs and the Orbax ``eval_pair``
are not counted).

Every check raises on failure, so the script exits non-zero and prints no
result; without CUDA it exits non-zero at once.  f32 phases run with TF32
off, the degradation with PyTorch's defaults.  Needs one GPU and no network.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import torch

from real_esrgan_tpu_torch import configuration as degrade_cfg
from real_esrgan_tpu_torch import test as test_cli
from real_esrgan_tpu_torch.metrics.niqe import NIQE, niqe_features
from real_esrgan_tpu_torch.models import rrdbnet
from real_esrgan_tpu_torch.models.rrdbnet import ResidualDenseBlock
from real_esrgan_tpu_torch.ops import _build
from real_esrgan_tpu_torch.ops.degradation import (
    apply_degradation, degrade, draw_degradation, draws_from_arrays,
)
from real_esrgan_tpu_torch.ops.conv3x3 import (
    built_conv3x3_plan, conv3x3, conv3x3_plain, conv3x3_plan,
)
from real_esrgan_tpu_torch.ops.fused_rdb import (
    BUILT_PLAN_KEYS, box_rdb_weights, built_rdb_plan, fused_rdb, pack_rdb_weights, rdb_plain,
    rdb_plan, split_rdb_weights,
)
from real_esrgan_tpu_torch.ops.mm_probe import (
    RESIDENT_MAX_K_BOXES, RESIDENT_WIDTHS, built_mm_grid_plan, built_mm_resident_plan, mm_grid,
    mm_grid_plain, mm_grid_plan, mm_resident, mm_resident_plain, mm_resident_plan,
)
from real_esrgan_tpu_torch.ops.resize import matlab_resize
from real_esrgan_tpu_torch.ops.tail_epilogue import bias_lrelu, bias_lrelu_plain
from real_esrgan_tpu_torch.ops.window_attn import window_attn, window_attn_plain
from real_esrgan_tpu_torch.parallel import mesh
from real_esrgan_tpu_torch.parallel.tiling import pad_for_tiles, tile_grid
from real_esrgan_tpu_torch.scripts import eval_pair, make_degraded_eval
from real_esrgan_tpu_torch.serve import SRPipeline
from real_esrgan_tpu_torch.tools import conv_exp, dp_check
from real_esrgan_tpu_torch.train.checkpoint import load_checkpoint, load_generator_params
from real_esrgan_tpu_torch.utils import zstd
from real_esrgan_tpu_torch.utils.imgio import load_image_rgb, read_png, write_png
from real_esrgan_tpu_torch.utils.ocdbt import OcdbtStore
from real_esrgan_tpu_torch.utils.orbax_read import read_pytree

ROOT = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(ROOT, "assets", "inenv10_esrnet_ema.npz")
TREE = os.path.join(ROOT, "tests", "data", "tree_lr.png")
GOLDEN = os.path.join(ROOT, "tests", "data", "jax_sr_tree_crop67x93_f32.npy")
TREE_SR = os.path.join(ROOT, "tests", "data", "tree_sr.png")
NIQE_GOLDEN = os.path.join(ROOT, "tests", "data", "jax_niqe_tree_sr.json")
DEGRADE_GOLDEN = os.path.join(ROOT, "tests", "data", "jax_degrade_b2_hr128.npz")
CROP = (slice(64, 131), slice(128, 221))  # the golden file's input crop

RDBS_PER_FORWARD = 69  # 23 RRDBs x 3 RDBs
TAIL_PER_FORWARD = 3  # the tail kernel after upsampling1, upsampling2 and conv3
# the tail kernel's launches by dtype name and path, as count_tail read them
TAIL_LAUNCHES = {"bf16": {}, "f32": {}}
# 2 * 9 * (64*32 + 96*32 + 128*32 + 160*32 + 192*64) FLOP per pixel
RDB_FLOP_PER_PIXEL = 479_232
RDB_WEIGHTS = RDB_FLOP_PER_PIXEL // 2
# H100 SXM, NVIDIA data sheet: dense bf16 tensor-core rate, f32 rate on the
# CUDA cores, HBM3 rate.  K1 runs on the tensor cores in both dtypes: bf16 as
# it is (wgmma), f32 as three bf16 products (hi*hi + hi*lo + lo*hi), so its operation
# bound is PRODUCTS x its FLOPs at the bf16 rate; the f32 record gives beside
# it the bound of the same FLOPs on the CUDA cores.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_CUDA_CORE_FLOPS = 67e12
PRODUCTS = {torch.bfloat16: 1, torch.float32: 3}
PEAK_BYTES = 3.35e12
CHECK_RDBS = ("trunk.0.rdb1", "trunk.11.rdb2", "trunk.22.rdb3")
TOLERANCE = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-2, 2e-2)}  # atol, rtol
DTYPE_NAME = {torch.float32: "f32", torch.bfloat16: "bf16"}
# K1's kernels in csrc/fused_rdb.cu, as the profiler names them
RDB_KERNEL_NAMES = ("rdb_bf16_wgmma_kernel", "rdb_f32_split_kernel")
# the kernels sass_counts names, by the name in their mangled symbols
KERNEL_NAMES = RDB_KERNEL_NAMES + ("mm_grid_kernel", "mm_resident_kernel", "conv3x3_kernel")
# SASS instructions counted per kernel: tensor cores (HMMA: mma.sync; HGMMA:
# wgmma), ldmatrix, cp.async, TMA loads, mbarrier operations, barriers,
# local memory
SASS_OPS = ("HMMA", "HGMMA", "LDSM", "LDGSTS", "UTMALDG", "SYNCS", "BAR", "LDL", "STL")
# mm_grid's ragged edges beyond the tool's shapes: k = 96 (a chunk past k)
# with m = 64, n = 32 (a 64-wide block past n), n = 160 (192-wide)
MM_RAGGED_SHAPES = ((64, 96, 192), (128, 64, 32), (128, 96, 160))
# beyond the main paths' shapes: a ragged batch, a block smaller than a tile
# (fragment tail and clamp), three ragged images (masks at T=16, batch index)
K1_EXTRA_SHAPES = {(2, 67, 93, 64), (1, 5, 3, 64), (3, 17, 40, 64)}
# interior seam error of the bf16 tiled output against a whole-image forward,
# 8-bit levels: bf16 rounding gives a max near 5 and a mean near 0.12; a tile
# computed wrong gives far more
SEAM_LIMIT = {"max": 16.0, "mean": 0.5}
KERNEL_SOURCES = ("fused_rdb", "conv3x3", "mm_probe", "window_attn")
# SwinIR-L (models/swinir.py) at the benchmark's configuration and seeded
# weights: 54 window-attention launches and 3 of the tail kernel a forward;
# the serve path against the plain reference, float32 within SWINIR_F32_BOUND
# (TF32 off; sums in another order), bf16 by the cell's GapRatio limit
SWINIR_CONFIG = os.path.join(ROOT, "benchmark", "configs", "swinir_l_realsr_x4.json")
SWINIR_LIMITS = os.path.join(ROOT, "benchmark", "limits", "swinir_l.batch256.json")
SWINIR_SEED = 2 ** 31 + 22
WINDOW_ATTN_PER_FORWARD = 54
WINDOW_ATTN_LAUNCHES = {"bf16": 0, "f32": 0}
SWINIR_F32_BOUND = 1e-3
# the window-attention kernel's timed shape: the SwinIR cell's 16 x 256^2
# tokens of 3 x 240 channels
WINDOW_ATTN_SHAPE = (16, 256, 256, 720)
CONV_SHAPE = (8, 256, 256, 64, 192, 32)  # the tool's default: B, H, W, Cin, Cout, tile
# K2's shapes beside the tool's default ((B, H, W, Cin), Cout, tile): Cin = 32
# (zeros past Cin), W = 48 and Cout = 64 (the 64-wide kernel)
CONV_EXTRA_SHAPES = (((2, 64, 48, 32), 96, 16), ((1, 64, 48, 64), 64, 16))
# K2's one-hot probes: ((B, H, W, Cin), Cout, tile), each at all nine taps
CONV_PROBE_SHAPES = (((1, 64, 48, 64), 64, 16), ((2, 16, 32, 32), 96, 8),
                     ((1, 16, 32, 64), 192, 8))
MM_REPS = 32
# K4's one-hot probes: the k of each (64 a box, split between the two
# warpgroups in the middle of one at 192 and 576) and the reps
RESIDENT_PROBE_K = (192, 576)
RESIDENT_PROBE_REPS = (1, MM_REPS)
BF16_TOLERANCE = TOLERANCE[torch.bfloat16]
# crops of the test image the evaluation path scores: (top, left, height, width)
EVAL_CROPS = {"a_64x64.png": (0, 0, 64, 64), "b_96x128.png": (100, 200, 96, 128),
              "c_50x70.png": (30, 400, 50, 70)}
# the degradation: the CLI's geometry (hr 400 -> crop 256, x4) at its batch
# of 8 and at the trainer's batch of 48 (TrainConfig.batch_size); each
# (up1, up2) combination picks its own canvases
DEGRADE_GEO = degrade_cfg.PipelineGeometry(hr_size=400, crop_size=256, scale=4)
DEGRADE_BATCHES = (8, 48)
UP_FLAGS = ((False, False), (False, True), (True, False), (True, True))
# card against the port's CPU on the same draws, and against the JAX golden:
# 8-bit LR values equal, LR PSNR, HR crops bit-identical
DEGRADE_LR_EQUAL_SHARE, DEGRADE_LR_PSNR_DB = 0.99, 50.0
DEGRADE_WARMUP, DEGRADE_TIMED = 3, 10
# the trainer: batch 48 (TrainConfig.batch_size) on 96 crops of 400 of
# tests/data/tree_sr.png (2 steps an epoch), validated on 3 crops of 300
# (centre-cropped to 256, LR 64); imgs/s over 8 steps after 3 warm-up steps;
# card against CPU on one f32 update at 2 RRDBs
TRAIN_BATCH, TRAIN_CROPS, TRAIN_STRIDE = 48, 96, 64
TRAIN_VALID_CORNERS = ((0, 0), (400, 900), (700, 1700))
TRAIN_WARMUP, TRAIN_TIMED = 3, 8
TRAIN_CARD_CPU_REL = 1e-4
# the stage-2 trainer: the same data and batch; GAN imgs/s over 8 steps after
# 3; card against CPU on one f32 G+D update at 2 RRDBs; the .npz snapshot of
# g_last's EMA served against the checkpoint itself (f16 weights)
GAN_WARMUP, GAN_TIMED = 3, 8
GAN_CARD_CPU_REL = 1e-4
NPZ_PSNR_DB = 40.0
# data parallelism: two ranks against one process on the same crops and
# draws, held as the card against the CPU (f32, TF32 off); each two-rank
# launch ends within DDP_TIMEOUT seconds; the CLI's two ranks run at full
# width, one step an epoch at 24 a rank
DDP_REL = TRAIN_CARD_CPU_REL
DDP_TIMEOUT = 400.0
DDP_BATCHES = (24, 48)
DDP_CLI = """
import sys
from real_esrgan_tpu_torch import train_realesrnet as trainer
from real_esrgan_tpu_torch.parallel.mesh import process_group
with process_group("gloo"):  # NCCL refuses two ranks on one device
    for more in ([], ["--epochs", "2", "--resume", "auto"]):
        trainer.main(trainer.build_parser().parse_args(sys.argv[1:] + more))
"""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def rdb_pack(state_dict, name: str, dtype: torch.dtype):
    convs = [(state_dict[f"{name}.conv{k}.weight"], state_dict[f"{name}.conv{k}.bias"])
             for k in range(1, 6)]
    packed = pack_rdb_weights([w for w, _ in convs], [b for _, b in convs], 64, 32, dtype)
    return [t.cuda() for t in packed]


def kernel_name(symbol: str) -> str:
    """A kernel's name from its mangled symbol, with its integer template
    arguments: ``mm_grid_kernel<192>``, ``conv3x3_kernel<96,1>``."""
    base = next((k for k in KERNEL_NAMES if k in symbol), symbol)
    args = re.search(rf"{base}I((?:Li\d+E)+)E", symbol)
    if args is None:
        return base
    return f"{base}<{','.join(re.findall(r'Li(-?\d+)E', args.group(1)))}>"


def sass_counts(name: str) -> dict:
    """The SASS_OPS instructions of each kernel in the built library, as
    ``cuobjdump -sass`` lists them (whole words: HMMA does not match HGMMA);
    empty where the toolkit lacks cuobjdump."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(_build.library_path(name))], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            kernel = kernel_name(found.group(1))
            counts[kernel] = dict.fromkeys(SASS_OPS, 0)
        elif kernel is not None:
            for op in counts[kernel]:
                counts[kernel][op] += bool(re.search(rf"\b{op}\b", line))
    return counts


def build_kernels() -> None:
    """Builds every kernel source anew, all at once, so the build times and
    the ptxas lines printed are this run's."""
    for name in KERNEL_SOURCES:
        _build.library_path(name).unlink(missing_ok=True)
    t0 = time.perf_counter()
    _build.build_all(KERNEL_SOURCES)
    wall = time.perf_counter() - t0
    for name in KERNEL_SOURCES:
        log = _build.BUILD_LOG[name]
        emit(build={name: {"nvcc_seconds": round(log["seconds"], 3),
                           "ptxas": [line.strip() for line in log["log"].splitlines()
                                     if re.search(r"Used \d+ registers|spill|entry function|C7520",
                                                  line)]}})
        check("C7520" not in log["log"], f"ptxas serialised wgmma in {name}.cu (C7520)")
    emit(build_wall_seconds=round(wall, 3))
    sass = {name: sass_counts(name) for name in KERNEL_SOURCES}
    emit(sass=sass)
    if sass["fused_rdb"]:
        check(sorted(sass["fused_rdb"]) == sorted(RDB_KERNEL_NAMES),
              f"fused_rdb.cu builds {sorted(sass['fused_rdb'])}, not {RDB_KERNEL_NAMES}")
    for kernel, ops in sass["fused_rdb"].items():
        check(ops["LDL"] + ops["STL"] == 0, f"{kernel} uses local memory: {ops}")
    f32_rdb = sass["fused_rdb"].get("rdb_f32_split_kernel", {"HMMA": 1})
    check(f32_rdb["HMMA"] > 0, f"rdb_f32_split_kernel is not an mma.sync kernel: {f32_rdb}")
    hopper = {k: v for name in ("mm_probe", "conv3x3", "fused_rdb") for k, v in sass[name].items()
              if k.startswith(("mm_grid_kernel", "mm_resident_kernel", "conv3x3_kernel",
                               "rdb_bf16_wgmma_kernel"))}
    built = sorted(k.split("<")[0] for k in hopper)
    resident_instances = len(RESIDENT_WIDTHS) * RESIDENT_MAX_K_BOXES  # (BN, k boxes)
    check(not sass["mm_probe"] or built == ["conv3x3_kernel"] * 5 + ["mm_grid_kernel"] * 4
          + ["mm_resident_kernel"] * resident_instances + ["rdb_bf16_wgmma_kernel"],
          f"TMA + wgmma kernels built: {sorted(hopper)}")
    for kernel, ops in hopper.items():
        check(ops["HGMMA"] > 0 and ops["UTMALDG"] > 0 and ops["HMMA"] == 0,
              f"{kernel} is not a TMA + wgmma kernel: {ops}")
        check(not kernel.startswith(("conv3x3", "mm_resident")) or ops["LDL"] + ops["STL"] == 0,
              f"{kernel} uses local memory: {ops}")
    rdb_blocks = {DTYPE_NAME[d]: {**rdb_plan(d), "built": built_rdb_plan(d)} for d in TOLERANCE}
    emit(fused_rdb_blocks=rdb_blocks)
    for name, plan in rdb_blocks.items():
        stated = {key: plan[key] for key in BUILT_PLAN_KEYS}
        check(plan["built"] == stated,
              f"fused_rdb {name}: built {plan['built']}, rdb_plan {stated}")
    blocks = {f"{m}x{k}x{n}": {"plan": mm_grid_plan(m, k, n), "built": built_mm_grid_plan(m, k, n)}
              for m, k, n in conv_exp.GATE_SHAPES}
    emit(mm_grid_blocks=blocks)
    for shape, pair in blocks.items():
        check(pair["plan"] == pair["built"], f"mm_grid at {shape}: built {pair['built']}, "
                                             f"mm_grid_plan {pair['plan']}")
    resident = {f"{m}x{k}x{n}": {"plan": mm_resident_plan(m, k, n),
                                 "built": built_mm_resident_plan(m, k, n)}
                for m, k, n in conv_exp.GATE_SHAPES}
    emit(mm_resident_blocks=resident)
    for shape, pair in resident.items():
        check(pair["plan"] == pair["built"], f"mm_resident at {shape}: built {pair['built']}, "
                                             f"mm_resident_plan {pair['plan']}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    conv = {"plan": conv3x3_plan(*CONV_SHAPE, sms), "built": built_conv3x3_plan(*CONV_SHAPE, sms)}
    emit(conv3x3_blocks={"shape": list(CONV_SHAPE), "sms": sms, **conv})
    check(conv["plan"] == conv["built"], f"conv3x3 at {CONV_SHAPE}: built {conv['built']}, "
                                         f"conv3x3_plan {conv['plan']}")
    emit(dynamic_smem_bytes={
        "conv3x3[64->192, 96 channels a block]": conv["plan"]["smem_bytes"],
        **{f"mm_resident[k={k}, {pair['plan']['bn']} columns a block]": pair["plan"]["smem_bytes"]
           for (_, k, _), pair in zip(conv_exp.GATE_SHAPES, resident.values())}})


def record_rdb_shapes(shapes: dict):
    """Adds the NHWC shape of every input any RDB in the process gets to
    ``shapes[dtype]``, whoever built the model; returns the hook's handle."""
    def hook(module, args):
        if isinstance(module, ResidualDenseBlock):
            b, c, h, w = args[0].shape
            shapes[args[0].dtype].add((b, h, w, c))
    return torch.nn.modules.module.register_module_forward_pre_hook(hook)


@contextlib.contextmanager
def record_tail_shapes(shapes: dict):
    """While open, adds (shape, shuffle) of every input the generator hands
    the tail kernel to ``shapes[dtype]``."""
    def recorded(y, bias, shuffle):
        shapes[y.dtype].add((tuple(y.shape), shuffle))
        return bias_lrelu(y, bias, shuffle)
    rrdbnet.bias_lrelu = recorded
    try:
        yield
    finally:
        rrdbnet.bias_lrelu = bias_lrelu


def count_tail(path: str, dtype: torch.dtype, launched: int, rdb_launched: int,
               rdbs_per_forward: int = RDBS_PER_FORWARD) -> None:
    """The tail kernel launched TAIL_PER_FORWARD times beside each forward's
    ``rdbs_per_forward`` RDB launches on ``path``, so none in a training
    step; adds its launches to TAIL_LAUNCHES."""
    counts = TAIL_LAUNCHES[DTYPE_NAME[dtype]]
    counts[path] = counts.get(path, 0) + launched
    check(launched * rdbs_per_forward == TAIL_PER_FORWARD * rdb_launched,
          f"{path}: the tail kernel launched {launched} times beside {rdb_launched} RDB "
          f"launches, not {TAIL_PER_FORWARD} a forward of {rdbs_per_forward}")


def rdb_weights(packed) -> dict:
    """The weights the dtype's kernel reads, made once a pack as the model
    makes them: the f32 split or the bf16 boxes, as fused_rdb's keyword."""
    if packed[0].dtype == torch.float32:
        return {"split": split_rdb_weights(packed)}
    return {"boxes": box_rdb_weights(packed)}


def capture_trunk_inputs(pipe: SRPipeline, image: np.ndarray) -> dict:
    """The NHWC input of each of the 69 RDBs in one forward of ``image``."""
    inputs, hooks = {}, []
    for name, module in pipe.model.named_modules():
        if isinstance(module, ResidualDenseBlock):
            def keep(module, args, name=name):
                inputs[name] = args[0].permute(0, 2, 3, 1).contiguous().clone()
            hooks.append(module.register_forward_pre_hook(keep))
    pipe.apply(torch.from_numpy(image)[None].cuda())
    for hook in hooks:
        hook.remove()
    check(len(inputs) == RDBS_PER_FORWARD, f"kept the inputs of {len(inputs)} RDBs")
    return inputs


def check_trunk_activations(state_dict, inputs: dict, dtype: torch.dtype) -> None:
    """K1 against rdb_plain on the real inputs of every RDB of the tree
    forward in ``dtype`` (|x| up to about 59): the f32 split's 16 bits have
    the least room there, bf16 rounds in its largest steps, and N(0, 0.5^2)
    reaches neither.  A line for each of CHECK_RDBS, and one for the worst
    of all 69."""
    atol, rtol = TOLERANCE[dtype]
    worst = {"max_abs_diff": -1.0}
    for name, x in inputs.items():
        packed = rdb_pack(state_dict, name, dtype)
        ok, err = within(fused_rdb(x, packed, **rdb_weights(packed)), rdb_plain(x, packed),
                         TOLERANCE[dtype])
        line = {"dtype": DTYPE_NAME[dtype], "rdb": name, "shape": list(x.shape),
                "max_abs_x": x.abs().max().item(), "max_abs_diff": err, "atol": atol,
                "rtol": rtol, "ok": ok}
        if name in CHECK_RDBS:
            emit(k1_trunk_check=line)
        if err > worst["max_abs_diff"]:
            worst = line
        check(ok, f"fused_rdb {DTYPE_NAME[dtype]} {name} disagrees with rdb_plain on the trunk's "
                  f"activations: {err}")
    emit(k1_trunk_worst={"rdbs": len(inputs), **worst})


def check_kernels(state_dict, main_shapes: dict) -> None:
    """K1 against rdb_plain on the card, trained weights, N(0, 0.5^2) inputs,
    at every shape the main paths gave it in each dtype and K1_EXTRA_SHAPES."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype, (atol, rtol) in TOLERANCE.items():
        for name in CHECK_RDBS:
            packed = rdb_pack(state_dict, name, dtype)
            weights = rdb_weights(packed)
            for shape in sorted(main_shapes[dtype] | K1_EXTRA_SHAPES):
                x = (torch.randn(shape, generator=gen, device="cuda") * 0.5).to(dtype)
                out = fused_rdb(x, packed, **weights).float()
                ref = rdb_plain(x, packed).float()
                torch.cuda.synchronize()
                diff = (out - ref).abs()
                ok = bool(torch.isfinite(out).all()) and bool((diff <= atol + rtol * ref.abs()).all())
                emit(k1_check={"dtype": DTYPE_NAME[dtype], "rdb": name, "shape": list(shape),
                               "max_abs_diff": diff.max().item(), "atol": atol, "rtol": rtol,
                               "ok": ok})
                check(ok, f"fused_rdb {DTYPE_NAME[dtype]} {name} {shape} disagrees with rdb_plain")


def tail_inputs(shape, shuffle: bool, dtype: torch.dtype, gen: torch.Generator):
    """y (N, G C, H, W) in channels_last from N(0, 2^2) and a float32 bias of C
    from N(0, 0.1^2), for the tail kernel."""
    n, gc, h, w = shape
    y = (torch.randn((n, h, w, gc), generator=gen, device="cuda") * 2.0).to(dtype)
    bias = torch.randn(gc // (4 if shuffle else 1), generator=gen, device="cuda") * 0.1
    return y.permute(0, 3, 1, 2), bias


def check_tail_kernel(shapes: dict) -> None:
    """The tail kernel against bias_lrelu_plain on the card, ``torch.equal``,
    at every (shape, shuffle) the serving path gave it in each dtype."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    for dtype in (torch.bfloat16, torch.float32):
        check(any(shuffle for _, shuffle in shapes[dtype])
              and not all(shuffle for _, shuffle in shapes[dtype]),
              f"the serving path gave the tail kernel {shapes[dtype]} in {DTYPE_NAME[dtype]}")
        for shape, shuffle in sorted(shapes[dtype]):
            y, bias = tail_inputs(shape, shuffle, dtype, gen)
            ref = bias_lrelu_plain(y, bias, shuffle)
            out = bias_lrelu(y.clone(memory_format=torch.channels_last), bias, shuffle)
            same = bool(torch.equal(out, ref)) and out.stride() == ref.stride()
            emit(tail_check={"dtype": DTYPE_NAME[dtype], "shape": list(shape),
                             "shuffle": shuffle, "equal": same})
            check(same, f"the tail kernel {DTYPE_NAME[dtype]} {shape} shuffle={shuffle} "
                        "differs from bias_lrelu_plain")
            del y, ref, out
            torch.cuda.empty_cache()


def check_autograd_guard(state_dict) -> None:
    """fused_rdb has no backward: with autograd on, a CUDA input or packed
    weight that requires grad raises instead of cutting the graph; under
    no_grad the same call runs."""
    packed = rdb_pack(state_dict, "trunk.0.rdb1", torch.float32)
    x = torch.zeros(1, 16, 16, 64, device="cuda", requires_grad=True)
    before = fused_rdb.launches
    raised = {}
    for name, args in (("input", (x, packed)),
                       ("weight", (x.detach(), [packed[0].clone().requires_grad_()] + packed[1:]))):
        try:
            fused_rdb(*args)
            raised[name] = False
        except RuntimeError as err:
            raised[name] = "no backward" in str(err)
    with torch.no_grad():
        fused_rdb(x, packed)
    y = torch.zeros(1, 4, 16, 64, device="cuda").permute(0, 3, 1, 2).requires_grad_()
    bias, tail_before = torch.zeros(16, device="cuda"), bias_lrelu.launches
    try:
        bias_lrelu(y, bias, True)
        raised["tail"] = False
    except RuntimeError as err:
        raised["tail"] = "no backward" in str(err)
    with torch.no_grad():
        bias_lrelu(y, bias, True)
    torch.cuda.synchronize()
    emit(autograd_guard={"raised": raised, "launches_under_no_grad": fused_rdb.launches - before,
                         "tail_launches_under_no_grad": bias_lrelu.launches - tail_before})
    check(all(raised.values()), f"fused_rdb or the tail kernel did not raise under autograd: "
                                f"{raised}")
    check(fused_rdb.launches - before == 1, "fused_rdb under no_grad did not launch once")
    check(bias_lrelu.launches - tail_before == 1,
          "the tail kernel under no_grad did not launch once")


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return math.inf if mse == 0 else 10.0 * math.log10(1.0 / mse)


def serve(pipe: SRPipeline, dtype: torch.dtype, tree: np.ndarray, wide: np.ndarray) -> dict:
    """The main path's requests through one pipeline; checks each output and
    its launch count.  Returns the outputs the later checks need."""
    core = pipe.tile - 2 * pipe.tile_overlap
    n_tiles = math.ceil(wide.shape[0] / core) * math.ceil(wide.shape[1] / core)
    requests = [("tree", tree, 1), ("tree_again", tree, 1), ("crop50x70", tree[:50, :70], 1),
                ("wide_tiled", wide, math.ceil(n_tiles / pipe.tile_batch))]
    outputs = {}
    for name, image, forwards in requests:
        before, tail_before = fused_rdb.launches, bias_lrelu.launches
        t0 = time.perf_counter()
        out = pipe.upscale(image)
        seconds = time.perf_counter() - t0
        launched, tail = fused_rdb.launches - before, bias_lrelu.launches - tail_before
        h, w, _ = image.shape
        emit(request={"dtype": DTYPE_NAME[dtype], "name": name, "in": [h, w],
                      "out": list(out.shape), "seconds": round(seconds, 4),
                      "fused_rdb_launches": launched, "bias_lrelu_launches": tail})
        check(out.shape == (4 * h, 4 * w, 3), f"{name} output shape {out.shape}")
        check(bool(np.isfinite(out).all()), f"{name} output not finite")
        check(float(out.min()) >= 0.0 and float(out.max()) <= 1.0, f"{name} output outside [0, 1]")
        check(launched == RDBS_PER_FORWARD * forwards,
              f"{name}: fused_rdb launched {launched} times, expected {RDBS_PER_FORWARD * forwards}")
        count_tail(f"serve.{name}", dtype, tail, launched)
        outputs[name] = out
    # the golden crop is a plain Generator forward of the ragged 67x93 input
    before, tail_before = fused_rdb.launches, bias_lrelu.launches
    crop = torch.from_numpy(np.ascontiguousarray(tree[CROP]))[None].cuda()
    outputs["crop67x93"] = pipe.apply(crop)[0].cpu().numpy()
    check(fused_rdb.launches - before == RDBS_PER_FORWARD, "crop67x93 launch count")
    count_tail("serve.crop67x93", dtype, bias_lrelu.launches - tail_before, RDBS_PER_FORWARD)
    return outputs


def seam_error(pipe: SRPipeline, wide: np.ndarray, tiled: np.ndarray) -> dict:
    """Tiled against whole-image output in 8-bit levels, as tools/tile_sweep.py
    measures it: the 64-pixel output border (16 input pixels) is left out of
    the interior, since reflect padding and zero padding differ there."""
    whole = pipe.apply(torch.from_numpy(wide)[None].cuda())[0].float().cpu().numpy()
    diff = np.abs(whole - tiled) * 255.0
    interior = diff[64:-64, 64:-64]
    stats = lambda d: {"max": float(d.max()), "mean": float(d.mean()),  # noqa: E731
                       "p999": float(np.quantile(d, 0.999))}
    return {"all_8bit": stats(diff), "interior_8bit": stats(interior)}


def profile_device(call) -> dict:
    """One call under torch.profiler: its device activities' union (busy
    time) against the host wall clock around the call, and device time by
    kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return {"wall_ms": wall_ms, "device": "not measured: the profiler saw no device activity"}
    busy_us, reach = 0.0, spans[0][0]
    for start, end in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e3 / wall_ms, "by_name": by_name}


def profile_forward(pipe: SRPipeline, image: np.ndarray) -> dict:
    """Where one warm forward's time goes on the card (``profile_device``),
    with the RDB kernel's share of the busy time and the six longest kernels."""
    x = torch.from_numpy(image)[None].cuda()
    pipe.apply(x)
    torch.cuda.synchronize()
    profile = profile_device(lambda: pipe.apply(x))
    if "by_name" not in profile:
        return profile
    by_name = profile.pop("by_name")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    rdb_ms = sum(ms for name, (ms, _) in by_name.items()
                 if any(kernel in name for kernel in RDB_KERNEL_NAMES))
    return {**profile, "fused_rdb_ms": rdb_ms,
            "fused_rdb_share_of_busy": rdb_ms / profile["device_busy_ms"],
            "top": [[name[:70], ms, n] for name, (ms, n) in top]}


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(kernel, plain, reps: int):
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    plain_a, kernel_a = time_ms(plain, reps), time_ms(kernel, reps)
    kernel_b, plain_b = time_ms(kernel, reps), time_ms(plain, reps)
    return (kernel_a + kernel_b) / 2, (plain_a + plain_b) / 2


def graph_ms(fn, launches: int) -> float:
    """Time of one call of ``fn`` inside a CUDA graph of ``launches`` calls:
    the device's time for the launch alone, without the host's gaps between
    launches, so it reads a kernel that is shorter than its launch through
    the host."""
    return conv_exp.time_in_graph(fn, launches, torch.device("cuda")) * 1e3


def kernel_record(state_dict, dtype: torch.dtype, launches: int) -> dict:
    """fused_rdb at the tree image's trunk shape (1, 256, 512, 64): its time,
    its plain version's, both in turns (plain, kernel, kernel, plain), both
    again inside a CUDA graph of 10 launches (``device_ms``,
    ``plain_device_ms``: the plain version's 15 cuDNN convolutions and
    elementwise passes without the host's gaps between them), and its bound,
    the larger of its tensor-core FLOPs (PRODUCTS x the RDB's) over the bf16
    rate and bytes over HBM's rate.  f32 adds ``cuda_core_bound_ms``, the
    RDB's FLOPs over the CUDA cores' f32 rate, and ``device_tc_tflops``, the
    tensor-core FLOPs a second.  The f32 weights are split, the bf16 ones
    laid out as boxes, before the timing, as the model does once a pack."""
    shape = (1, 256, 512, 64)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = (torch.randn(shape, generator=gen, device="cuda") * 0.5).to(dtype)
    packed = rdb_pack(state_dict, "trunk.11.rdb2", dtype)
    weights = rdb_weights(packed)
    out, ref = fused_rdb(x, packed, **weights).float(), rdb_plain(x, packed).float()
    atol, rtol = TOLERANCE[dtype]
    check(bool(((out - ref).abs() <= atol + rtol * ref.abs()).all()),
          f"fused_rdb {DTYPE_NAME[dtype]} disagrees with rdb_plain at {shape}")
    err = (out - ref).abs().max().item()
    kernel, plain = (lambda: fused_rdb(x, packed, **weights)), (lambda: rdb_plain(x, packed))
    ms, plain_ms = in_turns(kernel, plain, 10)
    plain_device_ms = graph_ms(plain, 10)
    device_ms = graph_ms(kernel, 10)
    pixels = shape[0] * shape[1] * shape[2]
    flops = RDB_FLOP_PER_PIXEL * pixels
    moved = (2 * pixels * 64 + RDB_WEIGHTS) * x.element_size() + 5 * 64 * 4
    t_ops = PRODUCTS[dtype] * flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = moved / PEAK_BYTES * 1e3
    record = {"name": f"fused_rdb[{DTYPE_NAME[dtype]}]", "route": "cuda",
              "source": "real_esrgan_tpu_torch/csrc/fused_rdb.cu",
              "replaces": "real_esrgan_tpu/ops/pallas_rdb.py:188",
              "launches": launches, "max_abs_err": err, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
              "bound_by": "operations" if t_ops >= t_bytes else "bytes",
              "library_ms": None, "device_ms": device_ms, "plain_device_ms": plain_device_ms,
              "shape": list(shape), "products": PRODUCTS[dtype], "tflops": flops / ms / 1e9,
              "device_tflops": flops / device_ms / 1e9}
    if dtype == torch.float32:
        record.update(cuda_core_bound_ms=flops / PEAK_F32_CUDA_CORE_FLOPS * 1e3,
                      device_tc_tflops=PRODUCTS[dtype] * flops / device_ms / 1e9)
    return record


def within(out: torch.Tensor, ref: torch.Tensor, tolerance=BF16_TOLERANCE):
    """(all within atol + rtol |ref|, max abs difference), after a synchronize."""
    torch.cuda.synchronize()
    atol, rtol = tolerance
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    ok = bool(torch.isfinite(out).all()) and bool((diff <= atol + rtol * ref.abs()).all())
    return ok, diff.max().item()


def conv_operands(shape, cout, seed=2):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(shape, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(3, 3, shape[-1], cout, generator=gen, device="cuda") * 0.05
    return x, w


def one_hot_probes():
    """Exact probes of mm_grid's operand layouts, (name, a, b): a = I with b
    coded by position (arange mod 251, integers bf16 holds exactly), so c =
    b; and b = three 64-column identities scaled by 1, 2, 4 with a coded by
    position, so c's column block j is 2^j a.  A wrong swizzle, LBO or SBO
    shows as a permutation of the codes."""
    code = lambda r, c: (torch.arange(r * c, device="cuda") % 251).reshape(r, c)  # noqa: E731
    eye = torch.eye(64, device="cuda")
    scaled = torch.cat([eye * 2.0 ** j for j in range(3)], dim=1)
    return [(name, a.to(torch.bfloat16), b.to(torch.bfloat16))
            for name, a, b in (("a_identity", eye, code(64, 192)),
                               ("b_identity", code(128, 64), scaled))]


def resident_one_hot_probes(k: int):
    """Exact probes of mm_resident's operand layouts and k split, (name, a,
    b): a = I (k x k) with b (k x 192) coded by position, so c = reps b; and
    b (k x k) diagonal, 1, 2, 4 by 64-column box, with a (128 x k) coded, so
    c's column c is 2^(c // 64 % 3) reps a's.  Each output is one product,
    the other warpgroup adds exact zeros, and 32 equal products sum exactly
    in f32: a wrong fragment, swizzle, descriptor or reduction shows as a
    permutation of the codes."""
    code = lambda r, c: (torch.arange(r * c, device="cuda") % 251).reshape(r, c)  # noqa: E731
    scale = 2.0 ** (torch.arange(k, device="cuda") // 64 % 3)
    return [(name, a.to(torch.bfloat16), b.to(torch.bfloat16))
            for name, a, b in (("a_identity", torch.eye(k, device="cuda"), code(k, 192)),
                               ("b_identity", code(128, k), torch.diag(scale)))]


def conv_one_hot_probe(shape, cout: int, tap: int):
    """An exact probe of conv3x3's window and weight layouts, (x, w): x coded
    by position (7 * flat index mod 61: integers bf16 holds exactly; a chunk
    of 8 channels or a pixel apart always differ) and w zero but for tap
    ``tap`` = (dy, dx), where output channel o takes input channel o % Cin
    scaled by 2^(o // Cin).  The output is x shifted by the tap, exactly; a
    wrong swizzle, halo, tap or weight row shows as a permutation."""
    b, h, width, cin = shape
    x = (torch.arange(b * h * width * cin, device="cuda") * 7 % 61).reshape(shape)
    w = torch.zeros(3, 3, cin, cout, device="cuda")
    o = torch.arange(cout, device="cuda")
    w[tap // 3, tap % 3, o % cin, o] = 2.0 ** (o // cin).float()
    return x.to(torch.bfloat16), w


def check_tool_kernels() -> None:
    """K2-K4 against their plain versions on the card, at every shape the
    tool's run gives them (its default conv, the five of ``--mm``), smaller
    and ragged ones, which between them take every width the kernels are
    built for: atol/rtol 2e-2 for the products, equality for the conv's copy
    modes and the one-hot probes of mm_grid, mm_resident and conv3x3, the
    shape alone for ``dots``."""
    atol, rtol = BF16_TOLERANCE
    b, h, w_, cin, cout, tile = CONV_SHAPE
    for shape, n_out, rows in (((b, h, w_, cin), cout, tile), *CONV_EXTRA_SHAPES):
        x, w = conv_operands(shape, n_out)
        ok, err = within(conv3x3(x, w, tile=rows), conv3x3_plain(x, w))
        exact = {mode: bool(torch.equal(conv3x3(x, w, tile=rows, mode=mode),
                                        conv3x3_plain(x, w, mode))) for mode in ("patch", "dma")}
        dots = conv3x3(x, w, tile=rows, mode="dots")
        torch.cuda.synchronize()
        ok = ok and all(exact.values()) and tuple(dots.shape) == (*shape[:3], n_out)
        emit(kernel_check={"kernel": "conv3x3", "shape": [*shape, n_out], "tile": rows,
                           "max_abs_diff": err, "atol": atol, "rtol": rtol,
                           "copy_modes_equal": exact, "ok": ok})
        check(ok, f"conv3x3 disagrees with conv3x3_plain at {shape} -> {n_out}")
    for shape, n_out, rows in CONV_PROBE_SHAPES:
        exact = {}
        for tap in range(9):
            x, w = conv_one_hot_probe(shape, n_out, tap)
            out = conv3x3(x, w, tile=rows)
            torch.cuda.synchronize()
            exact[f"{tap // 3}{tap % 3}"] = bool(torch.equal(out, conv3x3_plain(x, w)))
        ok = all(exact.values())
        emit(kernel_check={"kernel": "conv3x3", "probe": "one_hot_taps", "shape": [*shape, n_out],
                           "tile": rows, "exact": exact, "ok": ok})
        check(ok, f"conv3x3's one-hot probes at {shape} -> {n_out} are not exact: {exact}")
    for name, a, bm in one_hot_probes():
        out = mm_grid(a, bm)
        torch.cuda.synchronize()
        exact = bool(torch.equal(out, mm_grid_plain(a, bm)))
        emit(kernel_check={"kernel": "mm_grid", "probe": name,
                           "shape": [a.shape[0], a.shape[1], bm.shape[1]], "exact": exact,
                           "ok": exact})
        check(exact, f"mm_grid's one-hot probe {name} is not exact")
    for k in RESIDENT_PROBE_K:
        for name, a, bm in resident_one_hot_probes(k):
            exact = {}
            for reps in RESIDENT_PROBE_REPS:
                out = mm_resident(a, bm, reps)
                torch.cuda.synchronize()
                exact[f"reps{reps}"] = bool(torch.equal(out, mm_resident_plain(a, bm, reps)))
            ok = all(exact.values())
            emit(kernel_check={"kernel": "mm_resident", "probe": name,
                               "shape": [a.shape[0], a.shape[1], bm.shape[1]], "exact": exact,
                               "ok": ok})
            check(ok, f"mm_resident's one-hot probe {name} at k = {k} is not exact: {exact}")
    for m, k, n in (*conv_exp.MM_SHAPES, (256, 96, 160), (128, 64, 64), *MM_RAGGED_SHAPES):
        a, bm = conv_exp.mm_operands(m, k, n, 0.05, torch.device("cuda"), seed=3)
        for name, out, ref in (("mm_grid", mm_grid(a, bm), mm_grid_plain(a, bm)),
                               ("mm_resident", mm_resident(a, bm, MM_REPS),
                                mm_resident_plain(a, bm, MM_REPS))):
            ok, err = within(out, ref)
            emit(kernel_check={"kernel": name, "shape": [m, k, n], "max_abs_diff": err,
                               "atol": atol, "rtol": rtol, "ok": ok})
            check(ok, f"{name} disagrees with its plain version at ({m}, {k}) @ ({k}, {n})")


def drive_conv_exp() -> dict:
    """The experiment tool in process on the card: default run, ``--mm``,
    ``--gate``, and the ``mm_grid`` probe, which the tool keeps callable.
    Returns the launch counts of the run and the gate's verdict."""
    wrappers = {"conv3x3": conv3x3, "mm_grid": mm_grid, "mm_resident": mm_resident}
    for wrapper in wrappers.values():
        wrapper.launches = 0
    conv_exp.main([])
    conv_exp.main(["--mm"])
    verdict = conv_exp.main(["--gate"])
    for m, k, n in conv_exp.GATE_SHAPES:  # one launch is shorter than its launch through the host
        conv_exp.bench_mm_grid(m, k, n, 200, torch.device("cuda"), timer=conv_exp.time_in_graph)
    launches = {name: wrapper.launches for name, wrapper in wrappers.items()}
    emit(conv_exp={"launches": launches, "gate": verdict})
    for name, count in launches.items():
        check(count > 0, f"the experiment tool never launched {name}")
    check(set(verdict) >= {"value", "threshold", "library_tflops", "unparked", "device", "shapes"},
          "gate verdict lacks a key")
    return launches


def write_eval_pairs(tree: np.ndarray, root: str) -> tuple:
    """EVAL_CROPS of the test image as LR PNGs and their x4 MATLAB-bicubic
    upscales as HR PNGs, under ``root``/lr and ``root``/hr."""
    lr_dir, hr_dir = os.path.join(root, "lr"), os.path.join(root, "hr")
    os.makedirs(lr_dir), os.makedirs(hr_dir)
    for name, (top, left, h, w) in EVAL_CROPS.items():
        lr = np.ascontiguousarray(tree[top:top + h, left:left + w])
        hr = matlab_resize(torch.from_numpy(lr).cuda(), 4.0).clamp(0, 1).cpu().numpy()
        write_png(os.path.join(lr_dir, name), np.round(lr * 255.0).astype(np.uint8))
        write_png(os.path.join(hr_dir, name), np.round(hr * 255.0).astype(np.uint8))
    return lr_dir, hr_dir


def drive_eval(tree: np.ndarray, rdb_shapes: dict) -> dict:
    """The evaluation entry points on three crops of the test image at full
    width and depth, with the RDB kernel's input shapes added to
    ``rdb_shapes``.  Returns fused_rdb's launch counts by dtype."""
    launches = {}
    seen = {dtype: set() for dtype in rdb_shapes}
    hook = record_rdb_shapes(seen)
    with tempfile.TemporaryDirectory() as tmp:
        lr_dir, hr_dir = write_eval_pairs(tree, tmp)

        def run(label, dtype, call):
            fused_rdb.launches = bias_lrelu.launches = 0
            t0 = time.perf_counter()
            result = call()
            seconds = time.perf_counter() - t0
            launched = fused_rdb.launches
            count_tail(f"eval.{label}", dtype, bias_lrelu.launches, launched)
            launches[dtype] = launches.get(dtype, 0) + launched
            emit(eval={"entry": label, "dtype": DTYPE_NAME[dtype], "seconds": round(seconds, 3),
                       "fused_rdb_launches": launched, "result": result})
            check(launched == RDBS_PER_FORWARD * len(EVAL_CROPS),
                  f"{label}: fused_rdb launched {launched} times for {len(EVAL_CROPS)} images")
            return result

        for flag, dtype in (([], torch.float32), (["--bfloat16"], torch.bfloat16)):
            sr_dir = os.path.join(tmp, "sr_" + DTYPE_NAME[dtype])
            args = test_cli.build_parser().parse_args(
                ["--lr_dir", lr_dir, "--hr_dir", hr_dir, "--sr_dir", sr_dir,
                 "--model_path", WEIGHTS, *flag])
            avg = run("test", dtype, lambda: test_cli.main(args))
            check(math.isfinite(avg) and 0.0 < avg <= 100.0, f"test: mean NIQE {avg}")
            check(sorted(os.listdir(sr_dir)) == sorted(EVAL_CROPS), "test: files written")
            for name, (_, _, h, w) in EVAL_CROPS.items():
                check(read_png(os.path.join(sr_dir, name)).shape == (4 * h, 4 * w, 3),
                      f"test: {name} is not 4x its input")
        summary = run("eval_pair", torch.bfloat16, lambda: eval_pair.main(
            ["--weights", WEIGHTS, "--lr-dir", lr_dir, "--hr-dir", hr_dir]))
        check(summary["n"] == len(EVAL_CROPS) and math.isfinite(summary["psnr_mean"])
              and summary["niqe_mean"] is not None and math.isfinite(summary["niqe_mean"]),
              f"eval_pair summary {summary}")
    hook.remove()
    for dtype, shapes in seen.items():
        emit(rdb_shapes={"path": "eval", "dtype": DTYPE_NAME[dtype],
                         "shapes": [list(s) for s in sorted(shapes)]})
        check(len(shapes) > 0, f"the evaluation path gave fused_rdb no {DTYPE_NAME[dtype]} input")
        rdb_shapes[dtype] |= shapes
    return launches


def check_niqe() -> None:
    """NIQE of tests/data/tree_sr.png on the card, with TF32 allowed for
    float32 products and convolutions, against the committed JAX score (1e-2)
    and the port's own CPU score of this run (1e-3); times the features on
    the card and the float64 tail on the host."""
    with open(NIQE_GOLDEN) as f:
        golden = json.load(f)
    image = load_image_rgb(TREE_SR)[None]
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        card = float(NIQE(crop_border=golden["crop_border"], device="cuda")(image)[0])
        batch = torch.from_numpy(image).cuda()
        features_ms = time_ms(lambda: niqe_features(batch, golden["crop_border"]), 5)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    scorer = NIQE(crop_border=golden["crop_border"], device="cpu")
    feats = niqe_features(torch.from_numpy(image), golden["crop_border"]).numpy()
    t0 = time.perf_counter()
    cpu = float(scorer.score_features(feats)[0])
    tail_ms = (time.perf_counter() - t0) * 1e3
    emit(niqe={"image": "tests/data/tree_sr.png", "card": card, "cpu": cpu,
               "jax_golden": golden["score"], "card_minus_cpu": card - cpu,
               "card_minus_golden": card - golden["score"], "tf32_allowed": True,
               "features_ms_on_card": features_ms, "host_f64_tail_ms": tail_ms})
    check(abs(card - golden["score"]) <= 1e-2, f"NIQE {card} on the card, JAX {golden['score']}")
    check(abs(card - cpu) <= 1e-3, f"NIQE {card} on the card, {cpu} on the CPU")


class pytorch_default_tf32:
    """PyTorch's default TF32 flags (cuDNN convolutions in TF32, matrix
    products not) for the block, restored after it: a float32 product or
    convolution of the degradation that missed its guard would show."""

    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved


def lr_agreement(ours: torch.Tensor, ref: torch.Tensor) -> dict:
    """Share of equal 8-bit LR values, the largest difference in levels and
    the PSNR of ``ours`` against ``ref``."""
    ours, ref = ours.detach().cpu().double(), ref.detach().cpu().double()
    levels = (torch.round(ours * 255.0) - torch.round(ref * 255.0)).abs()
    mse = float(((ours - ref) ** 2).mean())
    return {"equal_share": float((levels == 0).double().mean()), "max_levels": float(levels.max()),
            "psnr_db": math.inf if mse == 0 else 10.0 * math.log10(1.0 / mse)}


def check_lr_agreement(name: str, stats: dict) -> None:
    check(stats["equal_share"] >= DEGRADE_LR_EQUAL_SHARE and stats["psnr_db"] >= DEGRADE_LR_PSNR_DB,
          f"{name}: LR agreement {stats} below {DEGRADE_LR_EQUAL_SHARE} / {DEGRADE_LR_PSNR_DB} dB")


def degrade_tiles(tree_sr: np.ndarray) -> np.ndarray:
    """The 2 x 5 grid of 400-pixel uint8 tiles of the 1024 x 2048 test image,
    as the CLI cuts them."""
    size = DEGRADE_GEO.hr_size
    return np.stack([tree_sr[y:y + size, x:x + size]
                     for y in range(0, tree_sr.shape[0] - size + 1, size)
                     for x in range(0, tree_sr.shape[1] - size + 1, size)])


def check_degrade_card_against_cpu(tiles: np.ndarray) -> None:
    """The degradation at the CLI's geometry and batch of 8, each (up1, up2):
    one draw on the CPU, applied on the CPU and, moved there, on the card."""
    kcfg, dcfg = degrade_cfg.KernelSynthesisConfig(), degrade_cfg.DegradationConfig()
    hr = torch.from_numpy(tiles[:8])
    for i, (up1, up2) in enumerate(UP_FLAGS):
        gen = torch.Generator().manual_seed(100 + i)
        draws = draw_degradation(gen, 8, DEGRADE_GEO, kcfg, dcfg, up1, up2, augment=True)
        t0 = time.perf_counter()
        lr_cpu, hr_cpu = apply_degradation(hr, draws, DEGRADE_GEO, kcfg, dcfg, up1, up2)
        cpu_seconds = time.perf_counter() - t0
        lr, hr_card = apply_degradation(hr.cuda(), draws.to("cuda"), DEGRADE_GEO, kcfg, dcfg,
                                        up1, up2)
        stats = lr_agreement(lr, lr_cpu)
        hr_identical = bool(torch.equal(hr_card.cpu(), hr_cpu))
        emit(degrade_card_vs_cpu={"up1": up1, "up2": up2, "batch": 8, "lr": list(lr.shape),
                                  "hr_identical": hr_identical, "cpu_seconds": cpu_seconds,
                                  "branches": {"gaussian": [draws.noise1.gaussian,
                                                            draws.noise2.gaussian],
                                               "blur2": draws.blur2, "order": draws.order,
                                               "methods": [draws.method1, draws.method2,
                                                           draws.method3]},
                                  **stats})
        check(hr_identical, f"degrade ({up1}, {up2}): HR crops differ between the card and the CPU")
        check_lr_agreement(f"degrade ({up1}, {up2}) card against CPU", stats)


def check_degrade_golden() -> None:
    """The port on the card, applied to the JAX package's own draws, against
    JAX's LR and HR (tests/test_torch_degradation.py writes the golden)."""
    with np.load(DEGRADE_GOLDEN) as g:
        draws = draws_from_arrays({k[6:]: g[k] for k in g.files if k.startswith("draws.")})
        hr_in, lr_ref, hr_ref = (torch.from_numpy(g[k]) for k in ("hr_uint8", "lr", "hr"))
        key = int(g["key"])
    geo = degrade_cfg.PipelineGeometry(hr_size=128, crop_size=64, scale=4)
    lr, hr = apply_degradation(hr_in.cuda(), draws.to("cuda"), geo,
                               degrade_cfg.KernelSynthesisConfig(),
                               degrade_cfg.DegradationConfig(), True, True)
    stats = lr_agreement(lr, lr_ref)
    hr_identical = bool(torch.equal(hr.cpu(), hr_ref))
    emit(degrade_jax_golden={"golden": os.path.relpath(DEGRADE_GOLDEN, ROOT), "key": key,
                             "hr_identical": hr_identical, **stats})
    check(hr_identical, "degrade: HR crops differ from the JAX golden")
    check_lr_agreement("degrade card against the JAX golden", stats)


def drive_degraded_eval_cli(tiles: np.ndarray) -> None:
    """The CLI end to end on the card (no --cpu): 10 tiles of 400, seed 0, 2
    batches of 8 (the second padded); 10 aligned pairs, each LR more than 2
    levels from a clean area downscale of its HR; both pairs scored by
    eval_pair, --bicubic and with the committed weights.  Then the same with
    --cpu: the set does not depend on the device, so the HR files are
    identical and at least 99% of the 8-bit LR values equal."""
    with tempfile.TemporaryDirectory() as tmp:
        gt_dir, out = os.path.join(tmp, "gt"), os.path.join(tmp, "pairs")
        os.makedirs(gt_dir)
        for i, tile in enumerate(tiles):
            write_png(os.path.join(gt_dir, f"tree_{i:02d}.png"), tile)
        t0 = time.perf_counter()
        make_degraded_eval.main(["--gt-dir", gt_dir, "--output-dir", out, "--seed", "0"])
        seconds = time.perf_counter() - t0
        lr_dir, hr_dir = os.path.join(out, "LRx4"), os.path.join(out, "GTmod4")
        names = sorted(os.listdir(lr_dir))
        check(names == sorted(os.listdir(hr_dir)) and len(names) == len(tiles),
              f"make_degraded_eval wrote {len(names)} LR files for {len(tiles)} tiles")
        min_levels = math.inf
        for name in names:
            lr, hr = read_png(os.path.join(lr_dir, name)), read_png(os.path.join(hr_dir, name))
            check(lr.shape == (64, 64, 3) and hr.shape == (256, 256, 3),
                  f"{name}: LR {lr.shape}, HR {hr.shape}")
            clean = hr.astype(np.float64).reshape(64, 4, 64, 4, 3).mean(axis=(1, 3))
            levels = float(np.abs(lr.astype(np.float64) - clean).max())
            min_levels = min(min_levels, levels)
            check(levels > 2, f"{name}: LR within {levels} levels of a clean downscale")
        scores = {}
        for which, flags in (("bicubic", ["--bicubic"]),
                             ("inenv10_esrnet_ema", ["--weights", WEIGHTS])):
            summary = eval_pair.main([*flags, "--lr-dir", lr_dir, "--hr-dir", hr_dir])
            check(summary["n"] == len(names) and math.isfinite(summary["psnr_mean"]),
                  f"eval_pair {which}: {summary}")
            scores[which] = summary["psnr_mean"]
        cpu_out = os.path.join(tmp, "pairs_cpu")
        t0 = time.perf_counter()
        make_degraded_eval.main(["--gt-dir", gt_dir, "--output-dir", cpu_out, "--seed", "0",
                                 "--cpu"])
        cpu_seconds = time.perf_counter() - t0
        hr_identical, equal, total = True, 0, 0
        for name in names:
            with open(os.path.join(hr_dir, name), "rb") as a, \
                    open(os.path.join(cpu_out, "GTmod4", name), "rb") as b:
                hr_identical &= a.read() == b.read()
            lr_card = read_png(os.path.join(lr_dir, name))
            lr_cpu = read_png(os.path.join(cpu_out, "LRx4", name))
            equal, total = equal + int((lr_card == lr_cpu).sum()), total + lr_card.size
    card_vs_cpu = {"cpu_seconds": cpu_seconds, "hr_files_identical": hr_identical,
                   "lr_equal_share": equal / total}
    emit(degraded_eval_cli={"tiles": len(tiles), "pairs": len(names), "seconds": seconds,
                            "min_levels_from_clean_downscale": min_levels,
                            "psnr_mean_db": scores, "card_vs_cpu": card_vs_cpu})
    check(hr_identical, "make_degraded_eval: HR files differ between the card and --cpu")
    check(equal / total >= DEGRADE_LR_EQUAL_SHARE,
          f"make_degraded_eval: {equal / total} of LR values equal between the card and --cpu")


def time_degrade(tiles: np.ndarray) -> None:
    """degrade (draw + apply) a batch on the card, between two CUDA events
    around DEGRADE_TIMED batches after DEGRADE_WARMUP, at each batch size and
    (up1, up2); then one profiled batch of each size with both flags up."""
    kcfg, dcfg = degrade_cfg.KernelSynthesisConfig(), degrade_cfg.DegradationConfig()
    gen = torch.Generator(device="cuda").manual_seed(0)
    host = torch.Generator().manual_seed(0)
    for batch in DEGRADE_BATCHES:
        hr = torch.from_numpy(tiles[np.arange(batch) % len(tiles)]).cuda()

        def one(up1, up2):
            return degrade(gen, hr, DEGRADE_GEO, kcfg, dcfg, True, up1, up2, host)
        for up1, up2 in UP_FLAGS:
            for _ in range(DEGRADE_WARMUP):
                one(up1, up2)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(DEGRADE_TIMED):
                lr, _ = one(up1, up2)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / DEGRADE_TIMED
            check(bool(torch.isfinite(lr).all()), "degrade gave a non-finite LR")
            emit(degrade_time={"batch": batch, "up1": up1, "up2": up2,
                               "canvases": [DEGRADE_GEO.canvas1_for(up1),
                                            DEGRADE_GEO.canvas2_for(up2)],
                               "ms_per_batch": ms, "images_per_second": batch / ms * 1e3,
                               "batches_timed": DEGRADE_TIMED})
        profile = profile_device(lambda: one(True, True))
        by_name = profile.pop("by_name", {})
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
        emit(degrade_profile={"batch": batch, "up1": True, "up2": True, **profile,
                              "kernel_launches": sum(n for _, n in by_name.values()),
                              "top5": [[name[:80], ms, n] for name, (ms, n) in top]})


def time_degrade_blur() -> None:
    """The second blur at batch 48 on the up canvas (608 + 20 pixels of
    reflect padding, per-sample 21 x 21 kernels), as the port takes it (bf16
    operands, the sum in float64, one rounding) beside cuDNN's bf16 depthwise
    convolution of the same operands (its own float32 sum, then the
    rounding): times in a CUDA-event window of 5 calls, and the share of
    outputs the two round alike."""
    from real_esrgan_tpu_torch.ops.filter2d import filter2d

    gen = torch.Generator(device="cuda").manual_seed(3)
    b, size, k = 48, DEGRADE_GEO.canvas1_for(True), 21
    x = torch.rand(b, size, size, 3, generator=gen, device="cuda")
    kernels = torch.rand(b, k, k, generator=gen, device="cuda") ** 4
    kernels = kernels / kernels.sum(dim=(1, 2), keepdim=True)
    planes = x.permute(0, 3, 1, 2).reshape(1, b * 3, size, size).bfloat16()
    planes = torch.nn.functional.pad(planes, (k // 2,) * 4, mode="reflect")
    weight = kernels.bfloat16().repeat_interleave(3, dim=0)[:, None]

    def library():
        return torch.nn.functional.conv2d(planes, weight, groups=b * 3)
    port = filter2d(x, kernels, compute_dtype=torch.bfloat16)
    cudnn = library().reshape(b, 3, size, size).permute(0, 2, 3, 1).float()
    emit(degrade_blur={"batch": b, "canvas": size, "kernel": k,
                       "port_f64_sum_ms": time_ms(lambda: filter2d(x, kernels, torch.bfloat16), 5),
                       "cudnn_bf16_ms": time_ms(library, 5),
                       "rounded_alike_share": float((port == cudnn).float().mean())})


def drive_degrade(tree_sr: np.ndarray) -> None:
    """The degradation phase, under PyTorch's default TF32 flags."""
    tiles = degrade_tiles(tree_sr)
    with pytorch_default_tf32():
        check_degrade_card_against_cpu(tiles)
        check_degrade_golden()
        drive_degraded_eval_cli(tiles)
        time_degrade(tiles)
        time_degrade_blur()


def train_crops(tree_sr: np.ndarray) -> list:
    """TRAIN_CROPS crops of 400 of the 1024 x 2048 test image, at a stride of
    64 in row-major order (260 fit)."""
    size, stride = DEGRADE_GEO.hr_size, TRAIN_STRIDE
    corners = [(y, x) for y in range(0, tree_sr.shape[0] - size + 1, stride)
               for x in range(0, tree_sr.shape[1] - size + 1, stride)]
    return [tree_sr[y:y + size, x:x + size] for y, x in corners[:TRAIN_CROPS]]


def write_train_data(tmp: str, tree_sr: np.ndarray):
    """The trainers' data under ``tmp``: TRAIN_CROPS crops of 400 in
    ``train/`` and the TRAIN_VALID_CORNERS crops of 300 in ``valid/``."""
    train_dir, valid_dir = os.path.join(tmp, "train"), os.path.join(tmp, "valid")
    os.makedirs(train_dir), os.makedirs(valid_dir)
    for i, crop in enumerate(train_crops(tree_sr)):
        write_png(os.path.join(train_dir, f"crop_{i:03d}.png"), crop)
    for i, (y, x) in enumerate(TRAIN_VALID_CORNERS):
        write_png(os.path.join(valid_dir, f"valid_{i}.png"), tree_sr[y:y + 300, x:x + 300])
    return train_dir, valid_dir


def drive_train_cli(tree_sr: np.ndarray) -> int:
    """The trainer's CLI in-process at full width (23 RRDBs, 64 channels,
    growth 32), batch 48, hr 400 -> crop 256, bf16, remat, on 96 crops of the
    test image with a validation directory of TRAIN_VALID images: --epochs 1,
    then --epochs 2 --resume auto.  fused_rdb's launches are counted apart
    for the validation passes (69 an image) and the training steps (none).
    Returns the validation launches."""
    from real_esrgan_tpu_torch import train_realesrnet as trainer
    from real_esrgan_tpu_torch.train import checkpoint as ckpt_lib

    validations = []
    validate = trainer.validate

    def counted(*args, **kwargs):
        before, tail_before = fused_rdb.launches, bias_lrelu.launches
        score = validate(*args, **kwargs)
        validations.append((fused_rdb.launches - before, len(args[2]), score,
                            bias_lrelu.launches - tail_before))
        return score

    cwd = os.getcwd()
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        train_dir, valid_dir = write_train_data(tmp, tree_sr)
        trainer.validate = counted
        os.chdir(tmp)
        try:
            for epochs, resume in ((1, []), (2, ["--resume", "auto"])):
                args = trainer.build_parser().parse_args(
                    ["--train-dir", train_dir, "--valid-dir", valid_dir,
                     "--test-lr-dir", os.path.join(tmp, "none"),
                     "--test-hr-dir", os.path.join(tmp, "none"), "--batch-size",
                     str(TRAIN_BATCH), "--epochs", str(epochs), "--exp-name", "chip_smoke",
                     "--no-tensorboard", *resume])
                fused_rdb.launches = bias_lrelu.launches = 0
                seen = len(validations)
                t0 = time.perf_counter()
                trainer.main(args)
                seconds = time.perf_counter() - t0
                launched = validations[seen:]
                validation = sum(n for n, _, _, _ in launched)
                tail = sum(t for _, _, _, t in launched)
                count_tail("train_cli.validation", torch.bfloat16, tail, validation)
                count_tail("train_cli.steps", torch.bfloat16, bias_lrelu.launches - tail,
                           fused_rdb.launches - validation)
                runs.append({"epochs": epochs, "resume": bool(resume), "seconds": seconds,
                             "fused_rdb_launches_training": fused_rdb.launches - validation,
                             "fused_rdb_launches_validation": validation,
                             "bias_lrelu_launches_validation": tail,
                             "validated_images": sum(k for _, k, _, _ in launched),
                             "valid_niqe": [score for _, _, score, _ in launched]})
            tree = ckpt_lib.load_checkpoint(os.path.join(tmp, "results", "chip_smoke", "g_last"))
        finally:
            os.chdir(cwd)
            trainer.validate = validate
    steps_per_epoch = TRAIN_CROPS // TRAIN_BATCH
    finite = all(bool(torch.isfinite(v).all()) for v in tree["params"].values())
    emit(train_cli={"model": "23 RRDBs, 64 channels, growth 32, bf16, remat",
                    "batch": TRAIN_BATCH, "geometry": "hr 400 -> crop 256, x4",
                    "train_crops": TRAIN_CROPS, "steps_per_epoch": steps_per_epoch,
                    "checkpoint": {"step": tree["step"], "epoch": tree["epoch"],
                                   "update_count": int(tree["opt_state"]["count"]),
                                   "rejected_total": int(tree["guard"]["rejected_total"]),
                                   "params_finite": finite},
                    "runs": runs})
    check(tree["step"] == 2 * steps_per_epoch and tree["epoch"] == 2,
          f"trainer checkpoint at step {tree['step']}, epoch {tree['epoch']}")
    check(finite, "trainer checkpoint holds non-finite parameters")
    for run in runs:
        check(run["fused_rdb_launches_training"] == 0,
              f"the training steps launched fused_rdb {run['fused_rdb_launches_training']} times")
        check(run["validated_images"] == len(TRAIN_VALID_CORNERS)
              and run["fused_rdb_launches_validation"] == RDBS_PER_FORWARD * run["validated_images"],
              f"validation launched fused_rdb {run['fused_rdb_launches_validation']} times for "
              f"{run['validated_images']} images")
        check(all(math.isfinite(score) for score in run["valid_niqe"]), "validation NIQE")
    return sum(run["fused_rdb_launches_validation"] for run in runs)


def time_train(gpu: str) -> None:
    """ESRNet images/s at batch 48, full width, bf16, remat: TRAIN_TIMED
    steps of make_train_step between two CUDA events after TRAIN_WARMUP, on
    SyntheticHRDataset batches with the trainer's up/down coins; the peak
    memory; one step split by CUDA events into the degradation, the forward
    and backward, and the guarded update; one step under torch.profiler."""
    from real_esrgan_tpu_torch.configuration import ModelConfig, TrainConfig
    from real_esrgan_tpu_torch.train import esrnet
    from real_esrgan_tpu_torch.train_realesrnet import SyntheticHRDataset

    cfg = TrainConfig()
    model = esrnet.build_generator(ModelConfig(), cfg, "cuda",
                                   generator=torch.Generator().manual_seed(0))
    opt = esrnet.build_optimizer(cfg, 1000)
    step = esrnet.make_train_step(
        model, opt, DEGRADE_GEO, degrade_cfg.KernelSynthesisConfig(),
        degrade_cfg.DegradationConfig(), cfg.ema_decay, seed=cfg.seed,
        reject_limit=cfg.grad_reject_limit, rollback_after=cfg.rollback_after,
        reject_mult=cfg.grad_reject_mult, clamp_mode=cfg.train_clamp)
    state = esrnet.init_state(model, opt)
    data = SyntheticHRDataset(DEGRADE_GEO.hr_size, length=2 * TRAIN_BATCH, seed=0)
    batches = [torch.from_numpy(np.stack([data.load(b * TRAIN_BATCH + i, None)
                                          for i in range(TRAIN_BATCH)])).cuda() for b in range(2)]
    coins = np.random.default_rng((0, 0, 17))
    dcfg = degrade_cfg.DegradationConfig()
    flags = [(bool(coins.random() < dcfg.resize_probs1[0]),
              bool(coins.random() < dcfg.resize_probs2[0]))
             for _ in range(TRAIN_WARMUP + TRAIN_TIMED)]
    before, tail_before = fused_rdb.launches, bias_lrelu.launches
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_WARMUP):
        state, metrics = step(state, batches[i % 2], *flags[i])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_TIMED):
        state, metrics = step(state, batches[i % 2], *flags[i])
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / TRAIN_TIMED
    check(bool(torch.isfinite(metrics["loss"])), "a timed training step gave a non-finite loss")
    check(fused_rdb.launches == before, "a training step launched fused_rdb")
    count_tail("train_time", torch.bfloat16, bias_lrelu.launches - tail_before, 0)
    emit(train_time={"card": gpu, "batch": TRAIN_BATCH, "steps_timed": TRAIN_TIMED,
                     "warmup_steps": TRAIN_WARMUP, "up_flags": flags[TRAIN_WARMUP:],
                     "ms_per_step": ms, "images_per_second": TRAIN_BATCH / ms * 1e3,
                     "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                     "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                     "rejected_total": int(state.guard.rejected_total)})

    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    events[0].record()
    lr, hr = step.degrade_batch(state, batches[0], True, True)
    events[1].record()
    loss, grads = step.loss_and_grads(state.params, lr, hr)
    events[2].record()
    step.apply(state, grads)
    events[3].record()
    torch.cuda.synchronize()
    split = {name: events[i].elapsed_time(events[i + 1])
             for i, name in enumerate(("degradation", "forward_backward", "update"))}
    profile = profile_device(lambda: step(state, batches[0], True, True))
    by_name = profile.pop("by_name", {})
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    emit(train_profile={"card": gpu, "batch": TRAIN_BATCH, "up1": True, "up2": True,
                        "event_split_ms": split, **profile,
                        "kernel_launches": sum(n for _, n in by_name.values()),
                        "top6": [[name[:80], ms, n] for name, (ms, n) in top]})


def check_train_card_vs_cpu() -> None:
    """One update with the degradation bypassed, at 2 RRDBs (64 channels,
    growth 32) in f32 with TF32 off, on the same params and batch (2 LR
    crops of 64) on the card and on the CPU: loss and grad norm within
    TRAIN_CARD_CPU_REL relative."""
    from real_esrgan_tpu_torch.configuration import ModelConfig, TrainConfig
    from real_esrgan_tpu_torch.train import esrnet

    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on for the card-against-CPU update")
    cfg = TrainConfig(use_bfloat16=False, remat_rrdb=False)
    rng = np.random.default_rng(6)
    lr = torch.from_numpy(rng.random((2, 64, 64, 3)).astype(np.float32))
    hr = torch.from_numpy(rng.random((2, 256, 256, 3)).astype(np.float32))
    weights, results = None, {}
    for device in ("cpu", "cuda"):
        model = esrnet.build_generator(ModelConfig(num_rrdb=2), cfg, device,
                                       generator=torch.Generator().manual_seed(5))
        if weights is None:
            weights = model.state_dict()
        model.load_state_dict(weights)
        opt = esrnet.build_optimizer(cfg, 10)
        step = esrnet.make_train_step(model, opt, None, None, None, cfg.ema_decay)
        state, metrics = step.update(esrnet.init_state(model, opt), lr.to(device), hr.to(device))
        results[device] = (float(metrics["loss"]), float(metrics["grad_norm"]),
                           {k: v.cpu() for k, v in state.params.items()})
    (loss_cpu, gn_cpu, p_cpu), (loss, gn, p) = results["cpu"], results["cuda"]
    param_diff = max(float((p[k] - p_cpu[k]).abs().max()) for k in p)
    emit(train_card_vs_cpu={"rrdbs": 2, "dtype": "f32", "tf32": False, "loss": [loss, loss_cpu],
                            "grad_norm": [gn, gn_cpu],
                            "loss_rel": abs(loss - loss_cpu) / abs(loss_cpu),
                            "grad_norm_rel": abs(gn - gn_cpu) / gn_cpu,
                            "max_param_diff_after_update": param_diff,
                            "bound_rel": TRAIN_CARD_CPU_REL})
    check(abs(loss - loss_cpu) <= TRAIN_CARD_CPU_REL * abs(loss_cpu),
          f"training loss {loss} on the card, {loss_cpu} on the CPU")
    check(abs(gn - gn_cpu) <= TRAIN_CARD_CPU_REL * gn_cpu,
          f"grad norm {gn} on the card, {gn_cpu} on the CPU")


def drive_train(tree_sr: np.ndarray, gpu: str) -> int:
    """The trainer phase; returns fused_rdb's validation launches."""
    launches = drive_train_cli(tree_sr)
    time_train(gpu)
    check_train_card_vs_cpu()
    return launches


# the loaders phase: each --loader choice of the trainers on the trainer's 96
# crops of 400 (crop = image, so every loader yields whole images), the
# stage-1 step at full width timed over LOADER_TIMED steps after
# LOADER_WARMUP, fed through DevicePrefetcher as the CLI feeds it, beside
# two synthetic batches already on the card; then the loaders again in the
# opposite order after LOADER_REWARM steps each (their caches and workers
# are warm by then), so an effect of the order shows
LOADER_WARMUP, LOADER_TIMED, LOADER_REWARM = 3, 6, 1
# the loaders whose first epoch must be equal byte for byte on the card
SAME_BYTES = ("threads", "device", "native")


def loader_choices(native: bool) -> dict:
    """name -> (TrainConfig of that --loader choice, the class it must give)."""
    import dataclasses

    from real_esrgan_tpu_torch.configuration import TrainConfig
    from real_esrgan_tpu_torch.data import dataset, device_pool, grain_loader, native_loader

    cfg = TrainConfig()
    choices = {"threads": (dataclasses.replace(cfg, loader="threads"), dataset.ThreadedLoader),
               "device": (dataclasses.replace(cfg, loader="device"),
                          device_pool.DevicePoolLoader)}
    if native:  # auto without the pool's budget: the C++ loader
        choices["native"] = (dataclasses.replace(cfg, loader="auto", device_pool_budget_bytes=0),
                             native_loader.NativeThreadedLoader)
    choices["grain"] = (dataclasses.replace(cfg, loader="grain"), grain_loader.GrainLoader)
    return choices


def first_epochs(loaders: dict) -> dict:
    """Each loader's first epoch through DevicePrefetcher onto the card, with
    the host-to-device bytes a step it took."""
    from real_esrgan_tpu_torch.data.prefetcher import DevicePrefetcher

    out = {}
    for name, (ds, loader) in loaders.items():
        index_before = getattr(loader, "index_bytes", 0)
        pf = DevicePrefetcher(loader, "cuda")
        batches = [b.clone() for b in pf]
        torch.cuda.synchronize()
        steps = len(batches)
        out[name] = {"batches": batches, "steps": steps,
                     "h2d_bytes_per_step": (pf.h2d_bytes + getattr(loader, "index_bytes", 0)
                                            - index_before) / steps}
    return out


def loader_feed(loader):
    """The loader's batches on the card, epoch after epoch, as the CLI takes them."""
    from real_esrgan_tpu_torch.data.prefetcher import DevicePrefetcher

    while True:
        yield from DevicePrefetcher(loader, "cuda")


def time_loader(step, state, feed, flags, warmup: int) -> tuple:
    """``warmup`` steps, then LOADER_TIMED between two CUDA events, each on
    the next batch of ``feed``; the host's wait in ``next()`` is summed over
    the timed steps."""
    t0 = time.perf_counter()
    for i in range(LOADER_WARMUP - warmup, LOADER_WARMUP):
        state, metrics = step(state, next(feed), *flags[i])
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    wait_s = 0.0
    start.record()
    for i in range(LOADER_WARMUP, LOADER_WARMUP + LOADER_TIMED):
        t0 = time.perf_counter()
        batch = next(feed)
        wait_s += time.perf_counter() - t0
        state, metrics = step(state, batch, *flags[i])
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / LOADER_TIMED
    check(bool(torch.isfinite(metrics["loss"])), "a loader's timed step gave a non-finite loss")
    return state, {"ms_per_step": ms, "images_per_second": TRAIN_BATCH / ms * 1e3,
                   "next_wait_ms_per_step": wait_s / LOADER_TIMED * 1e3,
                   "warmup_seconds": warmup_s}


def drive_grain_resume(train_dir: str, tmp: str) -> dict:
    """``train_realesrnet --loader grain`` in-process at full width, batch 48:
    --epochs 1, then --epochs 2 --resume auto.  The first run writes
    loader_state_p0.bin (epoch tag 1), the second restores it, and its first
    batch is batch 2 of an unbroken stream of the same seed (read on the CPU
    with no workers), not batch 0."""
    from real_esrgan_tpu_torch import train_realesrnet as trainer
    from real_esrgan_tpu_torch.configuration import TrainConfig
    from real_esrgan_tpu_torch.data import grain_loader

    firsts, restored = [], []
    prefetcher, restore = trainer.DevicePrefetcher, grain_loader.restore_loader_state

    class Recording(prefetcher):
        def __iter__(self):
            for i, batch in enumerate(super().__iter__()):
                if i == 0:
                    firsts.append(batch.cpu().numpy())
                yield batch

    def recorded(*args, **kwargs):
        restored.append(restore(*args, **kwargs))
        return restored[-1]

    cwd = os.getcwd()
    state_tags = []
    trainer.DevicePrefetcher, grain_loader.restore_loader_state = Recording, recorded
    os.chdir(tmp)
    try:
        for epochs, resume in ((1, []), (2, ["--resume", "auto"])):
            args = trainer.build_parser().parse_args(
                ["--train-dir", train_dir, "--valid-dir", os.path.join(tmp, "none"),
                 "--test-lr-dir", os.path.join(tmp, "none"), "--test-hr-dir",
                 os.path.join(tmp, "none"), "--batch-size", str(TRAIN_BATCH), "--epochs",
                 str(epochs), "--exp-name", "chip_smoke_grain", "--loader", "grain",
                 "--no-tensorboard", *resume])
            trainer.main(args)
            with open(os.path.join(tmp, "samples", "chip_smoke_grain",
                                   "loader_state_p0.bin"), "rb") as f:
                state_tags.append(int.from_bytes(f.read(8), "little"))
    finally:
        os.chdir(cwd)
        trainer.DevicePrefetcher, grain_loader.restore_loader_state = prefetcher, restore
    files = sorted(os.path.join(train_dir, f) for f in os.listdir(train_dir))
    unbroken = grain_loader.GrainLoader(files, TRAIN_BATCH, DEGRADE_GEO.hr_size, num_workers=0,
                                        seed=TrainConfig().seed)
    stream = [b.copy() for _ in range(2) for b in unbroken]
    result = {"state_file_epoch_tags": state_tags, "restored": restored,
              "first_batch_equals_stream": [bool(np.array_equal(firsts[0], stream[0])),
                                            bool(np.array_equal(firsts[1], stream[2]))],
              "resumed_batch_differs_from_batch_0": not np.array_equal(firsts[1], stream[0])}
    check(state_tags == [1, 2], f"loader_state_p0.bin epoch tags {state_tags}")
    check(restored == [True], f"the resumed run restored the stream: {restored}")
    check(all(result["first_batch_equals_stream"]) and result["resumed_batch_differs_from_batch_0"],
          f"the resumed grain stream is not the unbroken one: {result}")
    return result


def drive_loaders(tree_sr: np.ndarray, gpu: str) -> None:
    """Every --loader choice of the trainers on the card, on the trainer's
    96 crops of 400 (write_train_data): ``make_train_loader`` gives the
    loader of each choice (``native`` only where the C++ loader builds:
    ``native_loader`` says why not); the first epochs of threads, device and
    native are the same uint8 batches on the card, byte for byte; the grain
    stream's first batch equals the CPU stream's; the pool's host-to-device
    traffic a step is its index vector; each loader's imgs/s feeding the full-width stage-1 step, with
    the host's wait in next(), in two rounds of opposite order beside two
    synthetic batches on the card; the pool's device bytes and the decode
    caches; then the grain resume through the CLI."""
    from real_esrgan_tpu_torch.configuration import ModelConfig, TrainConfig
    from real_esrgan_tpu_torch.data import grain_loader, native_loader
    from real_esrgan_tpu_torch.data.dataset import TrainImageDataset
    from real_esrgan_tpu_torch.train import esrnet
    from real_esrgan_tpu_torch.train_realesrnet import SyntheticHRDataset, make_train_loader

    t_phase = time.perf_counter()
    native = native_loader.available()
    emit(native_loader={"available": native, "reason": native_loader.unavailable_reason()})
    choices = loader_choices(native)
    with tempfile.TemporaryDirectory() as tmp:
        train_dir, _ = write_train_data(tmp, tree_sr)
        loaders = {}
        for name, (cfg, kind) in choices.items():
            ds = TrainImageDataset(train_dir, DEGRADE_GEO.hr_size,
                                   cache_bytes=cfg.decoded_cache_bytes)
            loader = make_train_loader(ds, TRAIN_BATCH, cfg, DEGRADE_GEO, torch.device("cuda"))
            check(type(loader) is kind, f"--loader {cfg.loader} gave {type(loader).__name__}")
            loaders[name] = (ds, loader)
        pool = loaders["device"][1]
        check(pool.pool.is_cuda, "the device pool does not lie on the card")
        firsts = first_epochs(loaders)
        same = [name for name in SAME_BYTES if name in loaders]
        reference = firsts["threads"]["batches"]
        for name in same:
            check(len(firsts[name]["batches"]) == len(reference)
                  and all(torch.equal(a, b) for a, b in zip(firsts[name]["batches"], reference)),
                  f"the first epoch of {name} is not the threaded loader's on the card")
        files = sorted(os.path.join(train_dir, f) for f in os.listdir(train_dir))
        cpu_stream = grain_loader.GrainLoader(files, TRAIN_BATCH, DEGRADE_GEO.hr_size,
                                              num_workers=0, seed=TrainConfig().seed)
        grain_equal = bool(np.array_equal(firsts["grain"]["batches"][0].cpu().numpy(),
                                          next(iter(cpu_stream))))
        check(grain_equal, "the grain stream's first batch on the card is not the CPU stream's")
        index_bytes = TRAIN_BATCH * 8
        check(firsts["device"]["h2d_bytes_per_step"] == index_bytes,
              f"the pool moved {firsts['device']['h2d_bytes_per_step']} bytes a step to the card")
        emit(loaders_same_bytes={
            "loaders": same, "steps": len(reference), "batch": list(reference[0].shape),
            "grain_first_batch_equals_cpu_stream": grain_equal,
            "h2d_bytes_per_step": {n: f["h2d_bytes_per_step"] for n, f in firsts.items()},
            "pool_device_bytes": pool.pool.nbytes,
            "pool_device": str(pool.pool.device)})
        del firsts, reference

        cfg = TrainConfig()
        model = esrnet.build_generator(ModelConfig(), cfg, "cuda",
                                       generator=torch.Generator().manual_seed(0))
        opt = esrnet.build_optimizer(cfg, 1000)
        step = esrnet.make_train_step(
            model, opt, DEGRADE_GEO, degrade_cfg.KernelSynthesisConfig(),
            degrade_cfg.DegradationConfig(), cfg.ema_decay, seed=cfg.seed,
            reject_limit=cfg.grad_reject_limit, rollback_after=cfg.rollback_after,
            reject_mult=cfg.grad_reject_mult, clamp_mode=cfg.train_clamp)
        state = esrnet.init_state(model, opt)
        coins = np.random.default_rng((0, 0, 17))
        dcfg = degrade_cfg.DegradationConfig()
        flags = [(bool(coins.random() < dcfg.resize_probs1[0]),
                  bool(coins.random() < dcfg.resize_probs2[0]))
                 for _ in range(LOADER_WARMUP + LOADER_TIMED)]
        synthetic = SyntheticHRDataset(DEGRADE_GEO.hr_size, length=2 * TRAIN_BATCH, seed=0)
        on_card = [torch.from_numpy(np.stack([synthetic.load(b * TRAIN_BATCH + i, None)
                                              for i in range(TRAIN_BATCH)])).cuda()
                   for b in range(2)]
        rounds = [(["synthetic", *loaders], LOADER_WARMUP), (list(loaders)[::-1], LOADER_REWARM)]
        timings = {name: [] for name in rounds[0][0]}
        for order, warmup in rounds:
            for name in order:
                feed = (itertools.cycle(on_card) if name == "synthetic"
                        else loader_feed(loaders[name][1]))
                state, timing = time_loader(step, state, feed, flags, warmup)
                if name != "synthetic":
                    feed.close()
                timings[name].append({"warmup_steps": warmup, **timing})
        caches = {"threads": loaders["threads"][0].cache_stats(),
                  "native": loaders["native"][1].cache_stats() if native else None}
        loaders["grain"][1].close()
        emit(loaders_time={"card": gpu, "batch": TRAIN_BATCH,
                           "model": "23 RRDBs, 64 channels, growth 32, bf16, remat",
                           "geometry": "hr 400 -> crop 256, x4", "steps_timed": LOADER_TIMED,
                           "up_flags": flags[LOADER_WARMUP:],
                           "order": [order for order, _ in rounds], "loaders": timings,
                           "decode_cache": {n: None if c is None else
                                            {"entries": c[0], "bytes": c[1]}
                                            for n, c in caches.items()}})
        del loaders, pool, state, step, model, on_card
        torch.cuda.empty_cache()
        resume = drive_grain_resume(train_dir, tmp)
    emit(loaders={"card": gpu, "native_available": native,
                  "same_bytes": list(SAME_BYTES if native else SAME_BYTES[:2]),
                  "grain_resume": resume, "seconds": time.perf_counter() - t_phase})


GAN_METRICS = ("pixel", "content", "adversarial", "g_loss", "d_loss", "d_hr_prob", "d_sr_prob",
               "g_grad_norm", "d_grad_norm", "g_rejected", "d_rejected")


def drive_gan_cli(tree_sr: np.ndarray, gpu: str) -> dict:
    """The stage-2 CLI in-process at full width (23 RRDBs, 64 channels,
    growth 32, D at 64), batch 48, hr 400 -> crop 256, bf16, remat, on the
    trainer's 96 crops and 3 validation images, warm-started from the
    committed ESRNet weights with the trunk content backbone: --epochs 1,
    then --epochs 2 --resume-g auto --resume-d auto.  fused_rdb's launches
    are counted apart for validation (69 an image) and training (none); every
    step's metrics are read.  The async saver must write g_epoch_1 and
    d_epoch_1, which load back; then ``check_npz_snapshot`` on g_last.
    Returns fused_rdb's launches: validation and the snapshot's serving."""
    from real_esrgan_tpu_torch import train_realesrgan as trainer
    from real_esrgan_tpu_torch.train import checkpoint as ckpt_lib

    validations, steps, saved, resumed = [], [], [], []
    validate, make_step = trainer.validate, trainer.make_gan_train_step
    resume_generator, save_many = trainer.resume_generator, ckpt_lib.AsyncSaver.save_many

    def counted(*args, **kwargs):
        before, tail_before = fused_rdb.launches, bias_lrelu.launches
        score = validate(*args, **kwargs)
        validations.append((fused_rdb.launches - before, len(args[2]), score,
                            bias_lrelu.launches - tail_before))
        return score

    def recording(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def run(*a, **k):
            state, metrics = step(*a, **k)
            steps.append({k: float(metrics[k]) for k in GAN_METRICS})
            return state, metrics
        return run

    def resume(*args, **kwargs):
        out = resume_generator(*args, **kwargs)
        resumed.append(out[1])
        return out

    def spy_save(self, items):
        saved.append([os.path.basename(path) for path, _, _ in items])
        return save_many(self, items)

    cwd = os.getcwd()
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        train_dir, valid_dir = write_train_data(tmp, tree_sr)
        trainer.validate, trainer.make_gan_train_step = counted, recording
        trainer.resume_generator, ckpt_lib.AsyncSaver.save_many = resume, spy_save
        os.chdir(tmp)
        try:
            for epochs, resume_args in ((1, []), (2, ["--resume-g", "auto", "--resume-d", "auto"])):
                args = trainer.build_parser().parse_args(
                    ["--train-dir", train_dir, "--valid-dir", valid_dir,
                     "--test-lr-dir", os.path.join(tmp, "none"),
                     "--test-hr-dir", os.path.join(tmp, "none"), "--batch-size",
                     str(TRAIN_BATCH), "--epochs", str(epochs), "--exp-name", "chip_smoke_gan",
                     "--resume", WEIGHTS, "--content-backbone", "trunk", "--no-tensorboard",
                     *resume_args])
                fused_rdb.launches = bias_lrelu.launches = 0
                seen, first = len(validations), len(steps)
                t0 = time.perf_counter()
                trainer.main(args)
                seconds = time.perf_counter() - t0
                launched = validations[seen:]
                validation = sum(n for n, _, _, _ in launched)
                tail = sum(t for _, _, _, t in launched)
                count_tail("gan_cli.validation", torch.bfloat16, tail, validation)
                count_tail("gan_cli.steps", torch.bfloat16, bias_lrelu.launches - tail,
                           fused_rdb.launches - validation)
                runs.append({"epochs": epochs, "resume": bool(resume_args), "seconds": seconds,
                             "resumed_epoch": resumed[-1] if resume_args else None,
                             "fused_rdb_launches_training": fused_rdb.launches - validation,
                             "fused_rdb_launches_validation": validation,
                             "bias_lrelu_launches_validation": tail,
                             "validated_images": sum(k for _, k, _, _ in launched),
                             "valid_niqe": [score for _, _, score, _ in launched],
                             "steps": steps[first:]})
            results = os.path.join(tmp, "results", "chip_smoke_gan")
            epoch_1 = {kind: ckpt_lib.load_checkpoint(
                os.path.join(tmp, "samples", "chip_smoke_gan", f"{kind}_epoch_1"))
                for kind in ("g", "d")}
            g_last = ckpt_lib.load_checkpoint(os.path.join(results, "g_last"))
            d_last = ckpt_lib.load_checkpoint(os.path.join(results, "d_last"))
        finally:
            os.chdir(cwd)
            trainer.validate, trainer.make_gan_train_step = validate, make_step
            trainer.resume_generator, ckpt_lib.AsyncSaver.save_many = resume_generator, save_many
        fused_rdb.launches = bias_lrelu.launches = 0
        check_npz_snapshot(os.path.join(results, "g_last"), gpu)
        snapshot_launches = fused_rdb.launches
        count_tail("npz_snapshot", torch.bfloat16, bias_lrelu.launches, snapshot_launches)
    steps_per_epoch = TRAIN_CROPS // TRAIN_BATCH
    finite = all(bool(torch.isfinite(v).all()) for tree in (g_last, d_last)
                 for v in tree["params"].values())
    emit(gan_cli={"card": gpu, "model": "23 RRDBs, 64 channels, growth 32, bf16, remat; "
                  "D 64 channels; trunk content backbone (taps 0, 1, 2)",
                  "warm_start": os.path.relpath(WEIGHTS, ROOT), "batch": TRAIN_BATCH,
                  "geometry": "hr 400 -> crop 256, x4", "train_crops": TRAIN_CROPS,
                  "steps_per_epoch": steps_per_epoch, "async_saves": saved,
                  "epoch_1_loaded": {k: sorted(v) for k, v in epoch_1.items()},
                  "g_last": {"step": g_last["step"], "epoch": g_last["epoch"],
                             "update_count": int(g_last["opt_state"]["count"]),
                             "rejected_total": int(g_last["guard"]["rejected_total"])},
                  "d_last": {"epoch": d_last["epoch"],
                             "update_count": int(d_last["opt_state"]["count"]),
                             "rejected_total": int(d_last["guard"]["rejected_total"])},
                  "params_finite": finite, "runs": runs})
    check(saved == [["g_epoch_1", "d_epoch_1"], ["g_epoch_2", "d_epoch_2"]],
          f"the async saver wrote {saved}")
    check(epoch_1["g"]["epoch"] == epoch_1["d"]["epoch"] == 1
          and epoch_1["g"]["step"] == steps_per_epoch
          and set(epoch_1["d"]["batch_stats"]) and set(epoch_1["g"]["ema_params"]),
          "g_epoch_1 / d_epoch_1 did not load back as written")
    check(g_last["step"] == 2 * steps_per_epoch and g_last["epoch"] == d_last["epoch"] == 2,
          f"GAN checkpoint at step {g_last['step']}, epoch {g_last['epoch']}")
    check(runs[1]["resumed_epoch"] == 1, f"the GAN CLI resumed at {runs[1]['resumed_epoch']}")
    check(finite, "a GAN checkpoint holds non-finite parameters")
    for run in runs:
        check(len(run["steps"]) == steps_per_epoch, f"{len(run['steps'])} GAN steps in a run")
        check(all(math.isfinite(v) for step in run["steps"] for v in step.values()),
              "a GAN step gave a non-finite metric")
        check(run["fused_rdb_launches_training"] == 0,
              f"the GAN steps launched fused_rdb {run['fused_rdb_launches_training']} times")
        expected = RDBS_PER_FORWARD * run["validated_images"]
        check(run["validated_images"] == len(TRAIN_VALID_CORNERS)
              and run["fused_rdb_launches_validation"] == expected,
              f"GAN validation launched fused_rdb {run['fused_rdb_launches_validation']} times "
              f"for {run['validated_images']} images")
        check(all(math.isfinite(score) for score in run["valid_niqe"]), "GAN validation NIQE")
    return {"gan_validation": sum(run["fused_rdb_launches_validation"] for run in runs),
            "npz_snapshot": snapshot_launches}


def check_npz_snapshot(checkpoint: str, gpu: str) -> None:
    """``save_params_npz`` of the checkpoint's EMA, read back through
    ``load_generator_params`` and served on the tree image in bf16, against
    serving the checkpoint itself: PSNR >= NPZ_PSNR_DB (f16 storage)."""
    from real_esrgan_tpu_torch.train.checkpoint import save_params_npz

    tree = read_png(TREE).astype(np.float32) / 255.0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "g_last_ema.npz")
        save_params_npz(path, load_generator_params(checkpoint))
        size = os.path.getsize(path)
        outs = [SRPipeline(weights, bfloat16=True, device="cuda").upscale(tree)
                for weights in (checkpoint, path)]
    score = psnr(outs[1], outs[0])
    emit(npz_snapshot={"card": gpu, "bytes": size, "psnr_db": score, "floor_db": NPZ_PSNR_DB,
                       "finite": bool(np.isfinite(outs[1]).all()), "shape": list(outs[1].shape)})
    check(bool(np.isfinite(outs[1]).all()) and score >= NPZ_PSNR_DB,
          f"the .npz snapshot serves at {score:.2f} dB against its checkpoint")


def time_gan(gpu: str) -> None:
    """GAN images/s at batch 48, full width, bf16, remat, D at 64 and the
    random VGG19 backbone (the reference's default loss): GAN_TIMED steps of
    make_gan_train_step between two CUDA events after GAN_WARMUP, on
    SyntheticHRDataset batches with the trainer's coins; the peak memory; one
    step split by CUDA events into the degradation, G's forward and
    backward, G's update, D's forward and backward and D's update; one step
    under torch.profiler."""
    from real_esrgan_tpu_torch.configuration import GanTrainConfig, ModelConfig
    from real_esrgan_tpu_torch.train import esrgan
    from real_esrgan_tpu_torch.train_realesrnet import SyntheticHRDataset

    cfg = GanTrainConfig()
    generator, discriminator, vgg = esrgan.build_models(ModelConfig(), cfg, "cuda")
    g_tx, d_tx = esrgan.build_optimizers(cfg, 1000)
    step = esrgan.make_gan_train_step(generator, discriminator, vgg, g_tx, d_tx, DEGRADE_GEO,
                                      degrade_cfg.KernelSynthesisConfig(),
                                      degrade_cfg.DegradationConfig(), cfg)
    state = esrgan.init_gan_state(generator, discriminator, g_tx, d_tx)
    data = SyntheticHRDataset(DEGRADE_GEO.hr_size, length=2 * TRAIN_BATCH, seed=0)
    batches = [torch.from_numpy(np.stack([data.load(b * TRAIN_BATCH + i, None)
                                          for i in range(TRAIN_BATCH)])).cuda() for b in range(2)]
    coins = np.random.default_rng((0, 0, 17))
    dcfg = degrade_cfg.DegradationConfig()
    flags = [(bool(coins.random() < dcfg.resize_probs1[0]),
              bool(coins.random() < dcfg.resize_probs2[0]))
             for _ in range(GAN_WARMUP + GAN_TIMED)]
    before, tail_before = fused_rdb.launches, bias_lrelu.launches
    torch.cuda.reset_peak_memory_stats()
    for i in range(GAN_WARMUP):
        state, metrics = step(state, batches[i % 2], *flags[i])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(GAN_WARMUP, GAN_WARMUP + GAN_TIMED):
        state, metrics = step(state, batches[i % 2], *flags[i])
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / GAN_TIMED
    values = {k: float(metrics[k]) for k in GAN_METRICS}
    check(all(math.isfinite(v) for v in values.values()), f"a timed GAN step gave {values}")
    check(fused_rdb.launches == before, "a GAN step launched fused_rdb")
    count_tail("gan_time", torch.bfloat16, bias_lrelu.launches - tail_before, 0)
    emit(gan_time={"card": gpu, "batch": TRAIN_BATCH, "backbone": "VGG19 to conv5_4, random",
                   "steps_timed": GAN_TIMED, "warmup_steps": GAN_WARMUP,
                   "up_flags": flags[GAN_WARMUP:], "ms_per_step": ms,
                   "images_per_second": TRAIN_BATCH / ms * 1e3,
                   "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                   "last_step": values, "g_rejected_total": int(state.g_guard.rejected_total),
                   "d_rejected_total": int(state.d_guard.rejected_total)})

    events = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    events[0].record()
    lr, hr = step.degrade_batch(state, batches[0], True, True)
    events[1].record()
    g_grads, aux = step.g_loss_and_grads(state, lr, hr)
    events[2].record()
    step.g_apply(state, g_grads)
    events[3].record()
    d_grads, _ = step.d_loss_and_grads(state.d_params, aux["d_stats"], aux["sr"], hr)
    events[4].record()
    step.d_apply(state, d_grads)
    events[5].record()
    torch.cuda.synchronize()
    split = {name: events[i].elapsed_time(events[i + 1]) for i, name in enumerate(
        ("degradation", "g_forward_backward", "g_update", "d_forward_backward", "d_update"))}
    profile = profile_device(lambda: step(state, batches[0], True, True))
    by_name = profile.pop("by_name", {})
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    emit(gan_profile={"card": gpu, "batch": TRAIN_BATCH, "up1": True, "up2": True,
                      "event_split_ms": split, **profile,
                      "kernel_launches": sum(n for _, n in by_name.values()),
                      "top6": [[name[:80], ms, n] for name, (ms, n) in top]})


def check_gan_card_vs_cpu() -> None:
    """One f32 G+D update with the degradation bypassed, G at 2 RRDBs (64
    channels, growth 32), D at 64 channels, the random VGG19 backbone to
    conv5_4, TF32 off, on the same weights (drawn on the CPU) and batch (2
    LR crops of 32) on the card and on the CPU: every loss term, both grad
    norms and D's sigmas within GAN_CARD_CPU_REL relative."""
    from real_esrgan_tpu_torch.configuration import GanTrainConfig, ModelConfig
    from real_esrgan_tpu_torch.train import esrgan

    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on for the card-against-CPU GAN update")
    cfg = GanTrainConfig(use_bfloat16=False, remat_rrdb=False, seed=5)
    rng = np.random.default_rng(6)
    lr = torch.from_numpy(rng.random((2, 32, 32, 3)).astype(np.float32))
    hr = torch.from_numpy(rng.random((2, 128, 128, 3)).astype(np.float32))
    results = {}
    for device in ("cpu", "cuda"):
        generator, discriminator, vgg = esrgan.build_models(ModelConfig(num_rrdb=2), cfg, device)
        g_tx, d_tx = esrgan.build_optimizers(cfg, 10)
        step = esrgan.make_gan_train_step(generator, discriminator, vgg, g_tx, d_tx, None, None,
                                          degrade_cfg.DegradationConfig(), cfg)
        state, metrics = step.update(esrgan.init_gan_state(generator, discriminator, g_tx, d_tx),
                                     lr.to(device), hr.to(device))
        results[device] = ({k: float(metrics[k]) for k in GAN_METRICS[:9]},
                           {k: float(v) for k, v in state.d_stats.items() if k.endswith("sigma")})
    (m_cpu, s_cpu), (m, s) = results["cpu"], results["cuda"]
    rel = {k: abs(m[k] - m_cpu[k]) / abs(m_cpu[k]) for k in m}
    rel.update({k: abs(s[k] - s_cpu[k]) / abs(s_cpu[k]) for k in s})
    emit(gan_card_vs_cpu={"rrdbs": 2, "d_channels": 64, "backbone": "VGG19 to conv5_4",
                          "dtype": "f32", "tf32": False, "card": m, "cpu": m_cpu,
                          "sigma_card": s, "sigma_cpu": s_cpu, "rel": rel,
                          "worst_rel": max(rel.values()), "bound_rel": GAN_CARD_CPU_REL})
    check(max(rel.values()) <= GAN_CARD_CPU_REL,
          f"the GAN update on the card is off from the CPU by {max(rel.values())}")


def drive_gan(tree_sr: np.ndarray, gpu: str) -> dict:
    """The stage-2 phase; returns fused_rdb's launches on its paths."""
    launches = drive_gan_cli(tree_sr, gpu)
    time_gan(gpu)
    check_gan_card_vs_cpu()
    return launches


@contextlib.contextmanager
def launch_names(**names):
    """JAX's launch names set in this process's environment for the block."""
    saved = {k: os.environ.get(k) for k in names}
    os.environ.update(names)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def full_width_steps(hr: torch.Tensor):
    """Two stage-1 steps at full width (23 RRDBs, 64 channels, bf16, remat)
    from seeded weights on ``hr``: (state, ms a step, losses)."""
    from real_esrgan_tpu_torch.configuration import ModelConfig, TrainConfig
    from real_esrgan_tpu_torch.train import esrnet

    cfg = TrainConfig()
    model = esrnet.build_generator(ModelConfig(), cfg, "cuda",
                                   generator=torch.Generator().manual_seed(0))
    opt = esrnet.build_optimizer(cfg, 1000)
    step = esrnet.make_train_step(
        model, opt, DEGRADE_GEO, degrade_cfg.KernelSynthesisConfig(),
        degrade_cfg.DegradationConfig(), cfg.ema_decay, seed=cfg.seed,
        reject_limit=cfg.grad_reject_limit, rollback_after=cfg.rollback_after,
        reject_mult=cfg.grad_reject_mult, clamp_mode=cfg.train_clamp)
    state, ms, losses = esrnet.init_state(model, opt), [], []
    for flags in ((False, False), (True, True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, hr, *flags)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    return state, ms, losses


def ddp_nccl(gpu: str) -> None:
    """A one-rank NCCL group on cuda:0, joined from JAX's launch names: the
    full-width generator's gradients through ``all_reduce_mean`` (forced,
    so NCCL runs at world size 1), and two full-width stage-1 steps that
    must be the same bits as with no group.  cuDNN is held deterministic
    for both runs, so only the group could tell them apart."""
    from real_esrgan_tpu_torch.train_realesrnet import SyntheticHRDataset

    data = SyntheticHRDataset(DEGRADE_GEO.hr_size, length=TRAIN_BATCH, seed=0)
    hr = torch.from_numpy(np.stack([data.load(i, None) for i in range(TRAIN_BATCH)])).cuda()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain, plain_ms, plain_losses = full_width_steps(hr)
        plain = (plain.params, plain.ema_params)
        torch.cuda.empty_cache()
        with launch_names(COORDINATOR_ADDRESS=f"localhost:{dp_check.free_port()}",
                          NUM_PROCESSES="1", PROCESS_ID="0"):
            with mesh.process_group() as up:
                import torch.distributed as dist

                backend = dist.get_backend() if up else None
                check(up and backend == "nccl" and mesh.world_size() == 1,
                      f"the one-rank group: up {up}, backend {backend}")
                reduce = dp_check.run_cases(["all_reduce"], "card", mesh.local_device(),
                                            "")["all_reduce"]
                group, group_ms, group_losses = full_width_steps(hr)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    same = all(torch.equal(a[k], b[k]) for a, b in zip(plain, (group.params, group.ema_params))
               for k in a)
    emit(ddp_nccl={"card": gpu, "backend": backend, "world_size": 1,
                   "all_reduce_ms": reduce["ms"], "all_reduce_elements": reduce["elements"],
                   "all_reduce_tensors": reduce["tensors"],
                   "all_reduce_mean_unchanged": reduce["mean_is_one"],
                   "model": "23 RRDBs, 64 channels, bf16, remat", "batch": TRAIN_BATCH,
                   "step_ms_no_group": plain_ms, "step_ms_group": group_ms,
                   "loss_no_group": plain_losses, "loss_group": group_losses,
                   "params_and_ema_same_bits": same, "cudnn_deterministic": True})
    check(reduce["mean_is_one"], "all_reduce_mean over one NCCL rank changed its input")
    check(same, "two stage-1 steps under a one-rank group differ from the same steps without")


def ddp_draws(gpu: str) -> None:
    """The draws of the global batch of 48 against a rank's 24, as each rank
    draws them: ms of ``draw_degradation`` on the card at the trainer's
    geometry with both up flags (the 608 canvas), and the normals drawn."""
    from real_esrgan_tpu_torch.ops.degradation import draw_degradation

    record = {"card": gpu, "geometry": "hr 400 -> crop 256, up1 and up2"}
    for batch in DDP_BATCHES:
        gen = torch.Generator(device="cuda").manual_seed(0)
        host = torch.Generator().manual_seed(0)
        draw = lambda: draw_degradation(  # noqa: E731
            gen, batch, DEGRADE_GEO, degrade_cfg.KernelSynthesisConfig(),
            degrade_cfg.DegradationConfig(), True, True, host_generator=host, device="cuda")
        draws = draw()
        record[f"batch_{batch}_ms"] = time_ms(draw, 5)
        record[f"batch_{batch}_normals"] = sum(
            t.numel() for n in (draws.noise1, draws.noise2) for t in (n.normal, n.normal_gray))
    emit(ddp_draws=record)


def ddp_gloo_shared_card(gpu: str) -> None:
    """Two ranks on the one card over gloo (NCCL refuses two ranks on one
    device), launched with JAX's names: ``tools/dp_check.py``'s ``card``
    steps against the same steps in this process on the whole batch, then
    the stage-1 CLI as two ranks for one epoch and again with ``--resume
    auto``."""
    t0 = time.perf_counter()
    cases = ["esrnet_step", "gan_step"]
    with tempfile.TemporaryDirectory() as tmp:
        single = dp_check.run_cases(cases, "card", torch.device("cuda"), tmp)
        torch.cuda.empty_cache()
        runs = dp_check.launch_local(
            ["-m", "real_esrgan_tpu_torch.tools.dp_check", "--preset", "card", "--backend",
             "gloo", "--cases", ",".join(cases + ["all_reduce"]), "--out", tmp], 2, DDP_TIMEOUT)
        for r, (rc, out) in enumerate(runs):
            check(rc == 0 and f"DP_CHECK_OK rank={r}" in out,
                  f"dp_check rank {r} exited {rc}:\n{out[-3000:]}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True)
                 for r in range(2)]
    rel, same = {}, {}
    for case in cases:
        for m, ref in zip(ranks[0][case]["metrics"], single[case]["metrics"]):
            for key in ("loss", "grad_norm", *GAN_METRICS):
                if key in ref:
                    rel[f"{case}.{key}"] = abs(m[key] - ref[key]) / max(abs(ref[key]), 1e-12)
        for key in ("params", "ema", "d_params", "d_stats"):
            if key in ranks[0][case]:
                a, b = ranks[0][case][key], ranks[1][case][key]
                same[f"{case}.{key}"] = all(torch.equal(a[k], b[k]) for k in a)
    checks_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cwds = [os.path.join(tmp, f"rank{r}") for r in range(2)]
        for cwd in cwds:
            os.makedirs(cwd)
        cli = dp_check.launch_local(
            ["-c", DDP_CLI, "--synthetic", "--epochs", "1", "--batch-size", str(TRAIN_BATCH),
             "--steps-per-epoch", "1", "--no-tensorboard", "--exp-name", "ddp"],
            2, DDP_TIMEOUT, cwds=cwds)
        rank1_results = os.path.exists(os.path.join(cwds[1], "results"))
        tree = load_checkpoint(os.path.join(cwds[0], "results", "ddp", "g_last"))
    local = TRAIN_BATCH // 2
    cli_ok = [rc == 0 and f"rank {r} of 2" in out and "at epoch 1." in out
              and f"1 steps/epoch, 2 ranks of {local}" in out for r, (rc, out) in enumerate(cli)]
    emit(ddp_gloo_shared_card={
        "card": gpu, "backend": "gloo", "world_size": 2, "preset": "card",
        "model": "2 RRDBs x 64, D 64, VGG19 to conv5_4, f32, TF32 off",
        "global_batch": dp_check.PRESETS["card"].batch, "rel_vs_single": rel,
        "bound_rel": DDP_REL, "ranks_same_bits": same,
        "step_ms_ranks": {c: [r[c]["step_ms"] for r in ranks] for c in cases},
        "step_ms_single": {c: single[c]["step_ms"] for c in cases},
        "all_reduce_ms_gloo": [r["all_reduce"]["ms"] for r in ranks],
        "cli": {"model": "23 RRDBs, 64 channels, bf16, remat", "batch": TRAIN_BATCH,
                "ranks_ok": cli_ok, "rank1_wrote_results": rank1_results,
                "g_last": {"epoch": tree["epoch"], "step": tree["step"]},
                "seconds": time.perf_counter() - t1},
        "checks_seconds": checks_s})
    for key, value in rel.items():
        check(value <= DDP_REL, f"two ranks against one process: {key} off by {value:.3g}")
    check(all(same.values()), f"the two ranks' state differs: {same}")
    for r, ok in enumerate(cli_ok):
        check(ok, f"the two-rank stage-1 CLI, rank {r}:\n{cli[r][1][-3000:]}")
    check(not rank1_results, "rank 1 of the CLI wrote results")
    check((tree["epoch"], tree["step"]) == (2, 2),
          f"the two-rank CLI's g_last at epoch {tree['epoch']}, step {tree['step']}")


def tiled_devices(wide: np.ndarray, outputs: dict, gpu: str) -> dict:
    """Tiled serving over two replicas on the one card against one device
    on the wide image (4 tiles of 528/8/8, one batch of 8 split in two
    chunks of 2): f32 the same bits, bf16 within the seam bound of a
    whole-image forward and NPZ_PSNR_DB of the one-device output; the RDB
    kernel's launches counted from 0; one forward of a replica under CUDA's
    sync debug mode, which raises if it waits on the host, and the host's
    time to launch a tile's forward beside the device's time to run it.
    Returns the launches by dtype."""
    devices = [torch.device("cuda", 0)] * 2
    launches, record = {}, {"card": gpu, "devices": [str(d) for d in devices]}
    for dtype in (torch.bfloat16, torch.float32):
        pipe = SRPipeline(WEIGHTS, bfloat16=dtype == torch.bfloat16, devices=devices)
        core = pipe.tile - 2 * pipe.tile_overlap
        n_tiles = math.ceil(wide.shape[0] / core) * math.ceil(wide.shape[1] / core)
        chunks = sum(min(len(devices), n_tiles - start)
                     for start in range(0, n_tiles, pipe.tile_batch))
        fused_rdb.launches = bias_lrelu.launches = 0
        t0 = time.perf_counter()
        out = pipe.upscale(wide)
        seconds = time.perf_counter() - t0
        launches[dtype] = fused_rdb.launches
        count_tail("tiled_devices", dtype, bias_lrelu.launches, launches[dtype])
        one = outputs[dtype]["wide_tiled"]
        name = DTYPE_NAME[dtype]
        # a replica's forward must not wait on the host, or the devices could
        # not overlap: CUDA's sync debug mode raises on any synchronizing call
        tiles = torch.from_numpy(np.ascontiguousarray(wide[:pipe.tile, :pipe.tile]))[None].cuda()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.no_grad():
                pipe.models[1](tiles)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        # the host's time to launch one tile's forward against the device's
        # time to run it: the host is free for the next device that long
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            pipe.models[1](tiles)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        forward_ms = (time.perf_counter() - t0) * 1e3
        record[name] = {"seconds": seconds, "fused_rdb_launches": launches[dtype],
                        "forward_syncs_host": False, "tile_forward_enqueue_ms": enqueue_ms,
                        "tile_forward_ms": forward_ms,
                        "chunks": chunks, "same_bits_as_one_device": bool(np.array_equal(out, one)),
                        "max_abs_vs_one_device": float(np.abs(out - one).max()),
                        "psnr_vs_one_device_db": psnr(out, one)}
        check(launches[dtype] == RDBS_PER_FORWARD * chunks,
              f"{name} tiled over two replicas launched fused_rdb {launches[dtype]} times, "
              f"expected {RDBS_PER_FORWARD * chunks}")
        check(out.shape == one.shape and bool(np.isfinite(out).all()), f"{name} tiled output")
        if dtype == torch.float32:
            check(record[name]["same_bits_as_one_device"],
                  "f32 tiled output over two replicas differs from one device's")
        else:
            record[name]["seam"] = seam_error(pipe, wide, out)
            for stat, limit in SEAM_LIMIT.items():
                check(record[name]["seam"]["interior_8bit"][stat] <= limit,
                      f"bf16 two-replica interior seam {stat} exceeds {limit}")
            check(record[name]["psnr_vs_one_device_db"] >= NPZ_PSNR_DB,
                  "bf16 tiled output over two replicas against one device's")
        del pipe
        torch.cuda.empty_cache()
    emit(tiled_devices=record)
    return launches


def drive_ddp(wide: np.ndarray, outputs: dict, gpu: str) -> dict:
    """The data-parallel phase; returns fused_rdb's launches of its tiled
    requests by dtype."""
    t0 = time.perf_counter()
    ddp_nccl(gpu)
    ddp_draws(gpu)
    ddp_gloo_shared_card(gpu)
    launches = tiled_devices(wide, outputs, gpu)
    emit(ddp_seconds=time.perf_counter() - t0)
    return launches


FRONT_END_BENCH_TIMEOUT = 600.0
# y, x, h, w: LR 64x64, 75x100 and 82x62, four or more NIQE blocks of 96 each
PARITY_CROPS = ((0, 0, 256, 256), (300, 700, 303, 401), (600, 1400, 330, 250))
PIXEL_MATCH_DB = 40.0
SWEEP_COMBOS = "528,8,8;272,8,16"
MFU_CEILING = 1.05


def front_end_profiling(tree: np.ndarray, gpu: str) -> int:
    """``utils.profiling.trace`` around one bf16 forward of the tree image:
    the Chrome trace it writes names the bf16 RDB kernel (the count of its
    events is printed: a profiler run after the script's earlier ones has shown
    61 of the forward's 69); ``StepTimer``'s summary over five forwards.
    Returns the phase's K1 launches."""
    from real_esrgan_tpu_torch.utils.profiling import StepTimer, trace

    pipe = SRPipeline(WEIGHTS, bfloat16=True, device="cuda")
    x = torch.from_numpy(tree)[None].cuda()
    before, tail_before = fused_rdb.launches, bias_lrelu.launches
    pipe.apply(x)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp) as prof:
            pipe.apply(x)
        (path,) = [os.path.join(tmp, f) for f in os.listdir(tmp)]
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        trace_bytes = os.path.getsize(path)
    k1_events = sum(str(e.get("cat", "")).lower() == "kernel"
                    and RDB_KERNEL_NAMES[0] in e.get("name", "") for e in events)
    timer = StepTimer(skip_first=2)
    timer.tick()
    for _ in range(5):
        pipe.apply(x)
        torch.cuda.synchronize()
        timer.tick()
    out_mp = 4 * tree.shape[0] * 4 * tree.shape[1] / 1e6
    emit(front_end_profiling={"card": gpu, "trace_events": len(events), "trace_bytes": trace_bytes,
                              "k1_kernel_events": k1_events,
                              "key_averages_rows": len(prof.key_averages()),
                              "step_timer": timer.summary(items_per_step=out_mp),
                              "items": "output MP", "steady_mean_s": timer.steady_mean})
    check(k1_events > 0, f"the trace never names {RDB_KERNEL_NAMES[0]}")
    check(math.isfinite(timer.steady_mean), "StepTimer has no steady-state samples")
    count_tail("front_end_profiling", torch.bfloat16, bias_lrelu.launches - tail_before,
               fused_rdb.launches - before)
    return fused_rdb.launches - before


def front_end_http(tree: np.ndarray, wide: np.ndarray, gpu: str) -> int:
    """The HTTP front end on 127.0.0.1 (bf16, the committed weights, warmup
    256): the tree image and the wide image (tiled) POSTed as PNGs; each
    answer the bits of ``SRPipeline.upscale`` quantised as the server does;
    ``/healthz`` and ``/stats``; K1's launches a request.  Returns them."""
    from real_esrgan_tpu_torch.scripts import serve_http
    from real_esrgan_tpu_torch.utils.imgio import decode_png, encode_png

    t0 = time.perf_counter()
    handler = serve_http.build_app(WEIGHTS, bfloat16=True, warmup_size=256)
    startup_s = time.perf_counter() - t0
    server = ThreadingHTTPServer(("127.0.0.1", dp_check.free_port()), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    pipeline = handler.pipeline_ref
    launches, requests = 0, []
    try:
        for name, image in (("tree", tree), ("wide_tiled", wide)):
            body = encode_png((image * 255.0 + 0.5).astype(np.uint8))
            lr = decode_png(body).astype(np.float32) / 255.0
            before, tail_before = fused_rdb.launches, bias_lrelu.launches
            t1 = time.perf_counter()
            req = urllib.request.Request(url + "/upscale", data=body, method="POST")
            with urllib.request.urlopen(req, timeout=300) as resp:
                png, server_s = resp.read(), float(resp.headers["X-Latency-Seconds"])
            client_s = time.perf_counter() - t1
            launched = fused_rdb.launches - before
            count_tail(f"front_end_http.{name}", torch.bfloat16, bias_lrelu.launches - tail_before,
                       launched)
            got = decode_png(png)
            with torch.no_grad():
                expected = serve_http.quantize(pipeline.upscale(lr))
            check(np.array_equal(got, expected),
                  f"HTTP {name}: the PNG differs from SRPipeline.upscale's bits")
            core = pipeline.tile - 2 * pipeline.tile_overlap
            forwards = 1 if max(image.shape[:2]) <= pipeline.tile_threshold else math.ceil(
                math.ceil(image.shape[0] / core) * math.ceil(image.shape[1] / core)
                / pipeline.tile_batch)
            check(launched == RDBS_PER_FORWARD * forwards,
                  f"HTTP {name}: fused_rdb launched {launched} times, not "
                  f"{RDBS_PER_FORWARD * forwards}")
            launches += launched
            requests.append({"name": name, "in": list(image.shape[:2]), "out": list(got.shape),
                             "server_latency_s": server_s, "client_s": client_s,
                             "fused_rdb_launches": launched})
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        with urllib.request.urlopen(url + "/stats", timeout=30) as resp:
            stats = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    emit(front_end_http={"card": gpu, "startup_s": startup_s, "requests": requests,
                         "healthz": health, "stats": stats})
    check(health == {"status": "ok", "device": "cuda", "served": 2}, f"/healthz gave {health}")
    check(stats.get("count") == 2, f"/stats gave {stats}")
    return launches


def front_end_bench(gpu: str) -> dict:
    """``python -m real_esrgan_tpu_torch.bench --mode all --iters 3`` in a
    subprocess: four JSON lines, the flagship last; every value finite and
    above 0; every line with a FLOP count and an mfu at most MFU_CEILING; the
    tiled count over every tile batch; K1 launched in the inference and tiled
    modes.  Returns K1's launches by mode."""
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, GPU_BUSY_LOCK=os.path.join(tmp, "no.lock"))
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "real_esrgan_tpu_torch.bench", "--mode", "all",
                              "--iters", "3"], cwd=ROOT, env=env, capture_output=True, text=True,
                             timeout=FRONT_END_BENCH_TIMEOUT)
        seconds = time.perf_counter() - t0
    lines = [json.loads(line) for line in run.stdout.splitlines() if line.startswith("{")]
    emit(front_end_bench={"card": gpu, "rc": run.returncode, "seconds": seconds, "lines": lines})
    check(run.returncode == 0, f"the bench exited {run.returncode}: {run.stderr[-3000:]}")
    check([line["mode"] for line in lines] == ["tiled", "train", "gan", "inference"],
          f"the bench printed {[line.get('mode') for line in lines]}")
    for line in lines:
        check(math.isfinite(line["value"]) and line["value"] > 0, f"bench {line['mode']} value")
        check(line.get("flops_per_unit", 0) > 0, f"bench {line['mode']} has no FLOP count")
        check(0 < line["mfu"] <= MFU_CEILING, f"bench {line['mode']} mfu {line['mfu']}")
        check(line["device"] == gpu, f"bench {line['mode']} device {line['device']}")
    tiled, flagship = lines[0], lines[-1]
    check(tiled["flops_per_call"] == tiled["tile_batches"] * tiled["flops_per_tile_batch"],
          "the tiled FLOPs are not every tile batch's")
    check(all(k in flagship for k in ("tiled_mp_per_s", "train_imgs_per_s", "gan_imgs_per_s")),
          "the flagship line lacks the other three rates")
    launches = {line["mode"]: line["fused_rdb_launches"] for line in lines}
    check(launches["inference"] > 0 and launches["tiled"] > 0,
          f"the bench's inference or tiled mode never launched fused_rdb: {launches}")
    return launches


def front_end_graft_entry(gpu: str) -> int:
    """``graft_entry.entry()`` on the card (69 K1 launches, (1, 256, 256, 3),
    finite), then ``dryrun_multichip(2)`` (two gloo ranks on the CPU)."""
    from real_esrgan_tpu_torch import graft_entry

    fn, (params, x) = graft_entry.entry()
    before, tail_before = fused_rdb.launches, bias_lrelu.launches
    out = fn(params, x)
    torch.cuda.synchronize()
    launched = fused_rdb.launches - before
    count_tail("graft_entry", torch.bfloat16, bias_lrelu.launches - tail_before, launched)
    t0 = time.perf_counter()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        graft_entry.dryrun_multichip(2)
    lines = printed.getvalue().splitlines()
    emit(front_end_graft_entry={"card": gpu, "device": str(out.device), "shape": list(out.shape),
                                "dtype": str(out.dtype), "fused_rdb_launches": launched,
                                "dryrun_seconds": time.perf_counter() - t0, "dryrun": lines})
    check(out.is_cuda and tuple(out.shape) == (1, 256, 256, 3), f"entry() gave {out.shape}")
    check(bool(torch.isfinite(out).all()), "entry()'s output is not finite")
    check(launched == RDBS_PER_FORWARD, f"entry() launched fused_rdb {launched} times")
    check(len(lines) == 3 and all(line.startswith("dryrun_multichip(2): ") for line in lines),
          f"dryrun_multichip(2) printed {lines}")
    return launched


def front_end_parity_scripts(tree_sr: np.ndarray, gpu: str) -> int:
    """``scripts.make_lr`` on the card over three crops of tree_sr.png, then
    ``scripts.validate_parity`` on the card (bf16) against a ``--cpu`` run's
    SR outputs (f32) of those LR images: the pixel match held at
    PIXEL_MATCH_DB; the NIQE entry printed, not held (these are not Set5
    images: ``--niqe-tol`` 1000).  Returns the card run's K1 launches."""
    from real_esrgan_tpu_torch.scripts import make_lr, validate_parity

    with tempfile.TemporaryDirectory() as tmp:
        gt_dir = os.path.join(tmp, "gt")
        os.makedirs(gt_dir)
        for i, (y, x, h, w) in enumerate(PARITY_CROPS):
            write_png(os.path.join(gt_dir, f"crop{i}.png"), tree_sr[y:y + h, x:x + w])
        pairs = os.path.join(tmp, "pairs")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            make_lr.main(["--gt-dir", gt_dir, "--output-dir", pairs])
        lr_dir = os.path.join(pairs, "LRbicx4")
        shapes = {name: list(read_png(os.path.join(lr_dir, name)).shape)
                  for name in sorted(os.listdir(lr_dir))}
        check(len(shapes) == len(PARITY_CROPS) and "on cuda" in printed.getvalue(),
              f"make_lr wrote {shapes}: {printed.getvalue()[-500:]}")
        common = ["--weights", WEIGHTS, "--model", "realesrnet", "--set5-lr", lr_dir,
                  "--niqe-tol", "1000"]
        verdicts, before, launched = {}, 0, 0
        for name, extra in (("cpu", ["--cpu", "--sr-out-dir", os.path.join(tmp, "cpu_sr")]),
                            ("card", ["--reference-sr-dir", os.path.join(tmp, "cpu_sr", "Set5"),
                                      "--pixel-match-psnr", str(PIXEL_MATCH_DB)])):
            report = os.path.join(tmp, f"{name}.json")
            before, tail_before = fused_rdb.launches, bias_lrelu.launches
            with contextlib.redirect_stdout(io.StringIO()):
                rc = validate_parity.main(common + extra + ["--report", report])
            launched = fused_rdb.launches - before
            count_tail(f"parity_scripts.{name}", torch.bfloat16,
                       bias_lrelu.launches - tail_before, launched)
            with open(report) as f:
                verdicts[name] = {"rc": rc, **json.load(f)}
    emit(front_end_parity_scripts={"card": gpu, "lr_shapes": shapes, "verdicts": verdicts,
                                   "card_fused_rdb_launches": launched})
    for name, verdict in verdicts.items():
        check(verdict["rc"] == 0, f"validate_parity ({name}) exited {verdict['rc']}")
    match = [c for c in verdicts["card"]["checks"] if c["check"] == "pixel_match_psnr"]
    check(len(match) == 1 and match[0]["ok"] and match[0]["value"] >= PIXEL_MATCH_DB,
          f"validate_parity's pixel match: {match}")
    check(launched == 2 * RDBS_PER_FORWARD * len(PARITY_CROPS),
          f"validate_parity on the card launched fused_rdb {launched} times")
    return launched


def front_end_tile_sweep(gpu: str) -> int:
    """``tools.tile_sweep --combos SWEEP_COMBOS --seam`` at 2048 on the card:
    one row a combo, each with a rate above 0 and a finite seam error.
    Returns its K1 launches."""
    from real_esrgan_tpu_torch.tools import tile_sweep

    printed = io.StringIO()
    before, tail_before = fused_rdb.launches, bias_lrelu.launches
    with contextlib.redirect_stdout(printed):
        tile_sweep.main(["--combos", SWEEP_COMBOS, "--seam"])
    launched = fused_rdb.launches - before
    count_tail("tile_sweep", torch.bfloat16, bias_lrelu.launches - tail_before, launched)
    rows = [json.loads(line) for line in printed.getvalue().splitlines() if line.startswith("{")]
    emit(front_end_tile_sweep={"card": gpu, "in_size": 2048, "rows": rows,
                               "fused_rdb_launches": launched})
    check(len(rows) == len(SWEEP_COMBOS.split(";")), f"tile_sweep printed {len(rows)} rows")
    for row in rows:
        check(row["mp_per_s"] > 0 and math.isfinite(row["seam"]["interior_8bit"]["max"]),
              f"tile_sweep row {row}")
    check(launched > 0, "tile_sweep never launched fused_rdb")
    return launched


def drive_front_end(tree: np.ndarray, wide: np.ndarray, tree_sr: np.ndarray, gpu: str) -> dict:
    """The front-end phase: profiling, the HTTP server, the bench, the entry
    pair, the parity scripts and the tile sweep.  Returns K1's launches by
    path."""
    t0 = time.perf_counter()
    launches = {"profiling": front_end_profiling(tree, gpu),
                "http": front_end_http(tree, wide, gpu)}
    bench_launches = front_end_bench(gpu)
    launches.update(bench_inference=bench_launches["inference"],
                    bench_tiled=bench_launches["tiled"],
                    entry=front_end_graft_entry(gpu),
                    validate_parity=front_end_parity_scripts(tree_sr, gpu),
                    tile_sweep=front_end_tile_sweep(gpu))
    emit(front_end_seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()
    return launches


# research_tools: the crop set's shape (tools/make_inenv_dataset.py's regions,
# steps and --hopper-repeat 6 on the 1024 x 2048 tree and a 600 x 512 hopper)
HOPPER_SHAPE, HOPPER_SEED = (600, 512, 3), 16
INENV_CROPS = {"tree": 177, "hopper": 90}  # 3x24 + 3x35, 15 x 6
PERF_LAB_ITERS, TAIL_ITERS = 3, 3
PROGRAM = os.path.join(ROOT, "real_esrgan_tpu_torch", "tools", "run_inenv10_program.sh")
PROGRAM_ENV = {"S1_EPOCHS": "1", "S2_EPOCHS": "1", "S1_BUDGET": "300", "S2_BUDGET": "300"}
PROGRAM_TIMEOUT = 900.0
POISONED = "trunk.5.rdb1.conv1.weight"


def quiet(fn, *args):
    """``fn(*args)`` with its standard output kept: (result, printed lines)."""
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        result = fn(*args)
    return result, printed.getvalue().splitlines()


def research_dataset(data: str, tmp: str, gpu: str) -> None:
    """``tools.make_inenv_dataset --textures`` on tree_sr.png and a seeded
    600 x 512 stand-in for the hopper photograph (the installed JPEG and the
    textures are absent on the card's machine: each texture is skipped and
    printed), then ``scripts.make_degraded_eval`` on its eval_src, the flags
    of tests/test_torch_inenv10.py: 177 tree and 90 hopper crops, two
    held-out sources with GTmod4/LRbicx4 pairs, aligned degraded pairs."""
    from real_esrgan_tpu_torch.tools import make_inenv_dataset

    hopper = os.path.join(tmp, "hopper_stand_in.png")
    write_png(hopper, np.random.default_rng(HOPPER_SEED).integers(0, 256, HOPPER_SHAPE,
                                                                  dtype=np.uint8))
    t0 = time.perf_counter()
    _, printed = quiet(make_inenv_dataset.main, ["--out", data, "--tree", TREE_SR,
                                                 "--hopper", hopper, "--textures"])
    seconds = time.perf_counter() - t0
    train = sorted(os.listdir(os.path.join(data, "train")))
    counts = {src: sum(n.startswith(src + "_") for n in train) for src in INENV_CROPS}
    textures = len(train) - sum(counts.values())
    pairs = {kind: sorted(os.listdir(os.path.join(data, "eval", kind)))
             for kind in ("GTmod4", "LRbicx4")}
    t0 = time.perf_counter()
    _, degraded_printed = quiet(make_degraded_eval.main, [
        "--gt-dir", os.path.join(data, "eval_src"), "--output-dir",
        os.path.join(data, "eval_degraded"), "--seed", "0", "--hr-size", "160",
        "--crop-size", "128"])
    degraded_seconds = time.perf_counter() - t0
    degraded = {kind: sorted(os.listdir(os.path.join(data, "eval_degraded", kind)))
                for kind in ("GTmod4", "LRx4")}
    emit(research_tools={"tool": "make_inenv_dataset", "card": gpu, "seconds": seconds,
                         "crops": len(train), "by_source": counts, "texture_crops": textures,
                         "printed": printed[:12], "eval_pairs": pairs["GTmod4"],
                         "degraded_pairs": len(degraded["LRx4"]),
                         "degraded_seconds": degraded_seconds,
                         "degraded_printed": degraded_printed[-1:]})
    check(counts == INENV_CROPS and len(train) == sum(INENV_CROPS.values()) + textures,
          f"make_inenv_dataset wrote {counts} and {textures} texture crops")
    check(pairs["GTmod4"] == pairs["LRbicx4"] == ["hopper_heldout.png", "tree_heldout.png"],
          f"make_inenv_dataset's eval pairs: {pairs}")
    check(degraded["GTmod4"] == degraded["LRx4"] and degraded["LRx4"],
          f"make_degraded_eval wrote {len(degraded['GTmod4'])} HR, {len(degraded['LRx4'])} LR")


def research_perf_lab(gpu: str) -> int:
    """``tools.perf_lab all`` at the JAX defaults (batch 8, 256^2) with
    PERF_LAB_ITERS, then ``gen --no-subpixel``: every reading finite and
    above 0 (a FAILED degradation case fails the phase), the matmul peak at
    most MFU_CEILING x 989.4 TFLOP/s; on one input the four RDB formulations
    within the bf16 bound of ``rdb_plain``, and the bf16 generator with and
    without subpixel within it.  Returns the K1 launches of ``gen``."""
    from real_esrgan_tpu_torch.bench import H100_BF16_PEAK_TFLOPS
    from real_esrgan_tpu_torch.models import Generator
    from real_esrgan_tpu_torch.tools import perf_lab

    before, tail_before = fused_rdb.launches, bias_lrelu.launches
    t0 = time.perf_counter()
    result, _ = quiet(perf_lab.main, ["all", "--iters", str(PERF_LAB_ITERS)])
    result["gen_no_subpixel"], _ = quiet(perf_lab.main, ["gen", "--no-subpixel", "--iters",
                                                         str(PERF_LAB_ITERS)])
    result["gen_no_subpixel"] = result["gen_no_subpixel"]["gen"]
    seconds, launched = time.perf_counter() - t0, fused_rdb.launches - before
    # gen launches the tail kernel 3 times a forward, gen --no-subpixel once (conv3)
    tail = TAIL_LAUNCHES["bf16"]["perf_lab"] = bias_lrelu.launches - tail_before

    kernels, biases = perf_lab.rand_weights("cuda")
    x = (torch.rand((2, 64, 96, perf_lab.C), generator=torch.Generator().manual_seed(3))
         .to("cuda", torch.bfloat16))
    with torch.no_grad():
        ref = rdb_plain(x, pack_rdb_weights([k.permute(3, 2, 0, 1) for k in kernels], biases,
                                            perf_lab.C, perf_lab.G, torch.bfloat16))
        forms = {name: within(fn(kernels, biases, x), ref)
                 for name, fn in perf_lab.RDB_FORMS.items()}
        lr = torch.rand((1, 48, 64, 3), generator=torch.Generator().manual_seed(4)).cuda()
        outs = [Generator(dtype=torch.bfloat16, subpixel=subpixel, device="cuda",
                          generator=torch.Generator().manual_seed(0)).eval()(lr)
                for subpixel in (True, False)]
        subpixel_ok, subpixel_err = within(outs[1], outs[0])
    emit(research_tools={"tool": "perf_lab", "card": gpu, "seconds": seconds,
                         "iters": PERF_LAB_ITERS,
                         "readings": result, "fused_rdb_launches": launched,
                         "rdb_forms_vs_rdb_plain_max_abs": {k: v[1] for k, v in forms.items()},
                         "gen_subpixel_vs_upsample_max_abs": subpixel_err})
    records = [r for rs in result.values() for r in (rs if isinstance(rs, list) else [rs])]
    for record in records:
        rate = record.get("tflops", record.get("mp_per_s", record.get("ms")))
        check("failed" not in record and rate is not None and math.isfinite(rate) and rate > 0,
              f"perf_lab reading {record}")
    peak = max(r["tflops"] for r in result["peak"])
    check(peak <= MFU_CEILING * H100_BF16_PEAK_TFLOPS,
          f"perf_lab peak {peak} TF/s above {MFU_CEILING} x {H100_BF16_PEAK_TFLOPS}")
    check(all(ok for ok, _ in forms.values()), f"an RDB formulation disagrees: {forms}")
    check(subpixel_ok, f"gen without subpixel differs from gen by {subpixel_err}")
    check(result["gen"]["fused_rdb_launches"] > 0 and not result["gen_no_subpixel"]["subpixel"],
          "perf_lab gen never launched K1")
    check(tail > 0, "perf_lab gen never launched the tail kernel")
    return launched


def research_tail_exp(gpu: str) -> None:
    """``tools.tail_exp`` in its three modes with TAIL_ITERS: every time
    finite and above 0; ``conv_i8`` on the card bit-exact against the int64
    sums on the CPU at every per-conv shape, on a small input."""
    from real_esrgan_tpu_torch.tools import tail_exp

    t0 = time.perf_counter()
    readings = {mode: quiet(tail_exp.main, ["--mode", mode, "--iters", str(TAIL_ITERS)])[0]
                for mode in tail_exp.MODES}
    seconds = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(5)
    exact = {}
    for cin, cout in tail_exp.INT8_SHAPES:
        xq = torch.randint(-127, 128, (2, 16, 24, cin), generator=gen, dtype=torch.int8)
        kq = torch.randint(-127, 128, (3, 3, cin, cout), generator=gen, dtype=torch.int8)
        out = tail_exp.conv_i8(xq.cuda(), kq.cuda()).cpu()
        exact[f"{cin}->{cout}"] = bool(torch.equal(out, tail_exp.conv_i8_reference(xq, kq)))
    emit(research_tools={"tool": "tail_exp", "card": gpu, "seconds": seconds,
                         "iters": TAIL_ITERS, "readings": readings,
                         "conv_i8_bit_exact": exact})
    for mode, records in readings.items():
        for record in records:
            times = [v for k, v in record.items() if k.endswith("ms")]
            check(times and all(math.isfinite(t) and t > 0 for t in times),
                  f"tail_exp {mode}: {record}")
    check(all(exact.values()), f"conv_i8 is not bit-exact on the card: {exact}")


def research_nan_probe(train_dir: str, out: str, gpu: str) -> None:
    """``tools.nan_probe`` for one epoch of the crop set at batch 16 and full
    width; then ``dissect`` on the initial state with one weight of
    ``trunk.5`` set to inf: the first non-finite output is in trunk.5, the
    artifacts are written; ``tools.explode_analysis`` reads them back, in
    both dtypes.  Neither runs K1 (the training model runs rdb_plain)."""
    from real_esrgan_tpu_torch import config as run_config
    from real_esrgan_tpu_torch.tools import explode_analysis, nan_probe

    argv = ["--train-dir", train_dir, "--epochs", "1", "--batch-size", "16", "--out", out]
    before, tail_before = fused_rdb.launches, bias_lrelu.launches
    t0 = time.perf_counter()
    result, printed = quiet(nan_probe.main, argv)
    seconds = time.perf_counter() - t0
    args = nan_probe.build_parser().parse_args(argv)
    probe, state = nan_probe.build_probe(args, result["steps"], torch.device("cuda"))
    state.params[POISONED][0, 0, 1, 1] = float("inf")
    up1, up2 = explode_analysis.replay_coins(probe.cfg.seed, 1, 0, run_config.degradation)
    names = sorted(os.listdir(train_dir))[:16]
    hr = torch.from_numpy(np.stack([read_png(os.path.join(train_dir, n)) for n in names])).cuda()
    report, _ = quiet(nan_probe.dissect, probe, state, hr, up1, up2, "step0_e1")
    first = (report.get("forward_nonfinite_layers") or [["none"]])[0][0]
    artifacts = sorted(os.listdir(out))
    t0 = time.perf_counter()
    explode, _ = quiet(explode_analysis.main, ["--dir", out, "--step", "0", "--epoch", "1",
                                               "--batch", "0"])
    explode_seconds = time.perf_counter() - t0
    launched = fused_rdb.launches - before
    # capture_outputs runs the forward under autograd, so conv3's hooks fire
    count_tail("nan_probe", torch.bfloat16, bias_lrelu.launches - tail_before, launched)
    emit(research_tools={"tool": "nan_probe", "card": gpu, "seconds": seconds,
                         "steps": result["steps"], "bad_steps": result["bad_steps"],
                         "verdict": printed[-1], "poisoned": POISONED,
                         "first_nonfinite_output": first, "loss": report["loss"],
                         "guard_rejected": report["guard_rejected"], "artifacts": artifacts})
    emit(research_tools={"tool": "explode_analysis", "card": gpu, "seconds": explode_seconds,
                         **{dtype: {"loss": r["loss"], "grads_maxabs": r["grads_maxabs"],
                                    "top": r["top"][:4],
                                    "nonfinite_outputs": len(r["nonfinite_outputs"]),
                                    "first_nonfinite_output": r["nonfinite_outputs"][0][0]
                                    if r["nonfinite_outputs"] else None}
                            for dtype, r in explode.items()}})
    check(result["steps"] == 16, f"nan_probe ran {result['steps']} steps, not 16")
    check(first.startswith("trunk.5"), f"the poisoned trunk.5 was located at {first}")
    check(artifacts == ["step0_e1.json", "step0_e1_hr_uint8.npy", "step0_e1_params.npz"],
          f"nan_probe wrote {artifacts}")
    for dtype in ("bf16", "f32"):
        bad = explode[dtype]["nonfinite_outputs"]
        check({"conv3", "conv3.0"} <= {name for name, _, _ in bad},
              f"explode_analysis [{dtype}] recorded no non-finite output of conv3")
        check(bool(bad) and bad[0][0].startswith("trunk.5"),
              f"explode_analysis [{dtype}] located no non-finite output in trunk.5: {bad[:3]}")
    check(launched == 0, f"nan_probe and explode_analysis launched K1 {launched} times")


def research_grad_probe(train_dir: str, gpu: str) -> None:
    """``tools.grad_probe`` with the committed ESRNet weights, 2 draws of 8:
    one row a source of the crop set, all finite."""
    from real_esrgan_tpu_torch.tools import grad_probe

    t0 = time.perf_counter()
    rows, _ = quiet(grad_probe.main, ["--weights", WEIGHTS, "--train-dir", train_dir,
                                      "--draws", "2", "--batch", "8"])
    seconds = time.perf_counter() - t0
    sources = sorted(grad_probe.group_by_source(train_dir))
    emit(research_tools={"tool": "grad_probe", "card": gpu, "seconds": seconds, "rows": rows})
    check(sorted(rows) == sources, f"grad_probe's rows {sorted(rows)} are not {sources}")
    for src, row in rows.items():
        check(all(math.isfinite(v) for v in row.values()), f"grad_probe {src}: {row}")


def _sha256(path: str) -> str:
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def research_program(root: str, tmp: str, gpu: str) -> int:
    """``tools/run_inenv10_program.sh`` with INENV10_ROOT=``root`` and
    PROGRAM_ENV: rc 0; 8 score lines (4 tags x 2 sets), each PSNR finite;
    both snapshots load through ``load_generator_params``; the committed
    ``assets/*.npz`` unchanged (SHA-256).  Its CLIs log their K1 launches
    (FUSED_RDB_LAUNCH_LOG): each eval_pair run launches 69 a pair.  Returns
    the program's K1 launches."""
    assets = {n: _sha256(os.path.join(ROOT, "assets", n))
              for n in sorted(os.listdir(os.path.join(ROOT, "assets"))) if n.endswith(".npz")}
    log = os.path.join(tmp, "fused_rdb_launches.jsonl")
    env = dict(os.environ, INENV10_ROOT=root, PYTHON=sys.executable, FUSED_RDB_LAUNCH_LOG=log,
               GPU_BUSY_LOCK=os.path.join(tmp, "gpu_busy.lock"), **PROGRAM_ENV)
    t0 = time.perf_counter()
    run = subprocess.run(["bash", PROGRAM], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=PROGRAM_TIMEOUT)
    seconds = time.perf_counter() - t0
    scores_path = os.path.join(root, "results", "inenv10_scores.jsonl")
    scores = []
    for line in open(scores_path) if os.path.exists(scores_path) else []:
        try:
            scores.append(json.loads(line))
        except json.JSONDecodeError:  # an eval_pair run that printed no summary
            scores.append({"unparsed": line.strip()})
    launches = ([json.loads(line) for line in open(log)] if os.path.exists(log) else [])
    by_cli = {}
    for entry in launches:
        cli = os.path.splitext(os.path.basename(entry["argv"][0]))[0]
        by_cli[cli] = by_cli.get(cli, 0) + entry["launches"]
    data = os.path.join(root, "data", "InEnv10")
    pairs = sum(len(os.listdir(os.path.join(data, d))) for d in ("eval_degraded/LRx4",
                                                                  "eval/LRbicx4"))
    snapshots = {}
    for name in ("inenv10_esrnet_ema.npz", "inenv10_esrgan_ema.npz"):
        path = os.path.join(root, "assets", name)
        snapshots[name] = len(load_generator_params(path)) if os.path.exists(path) else 0
    after = {n: _sha256(os.path.join(ROOT, "assets", n)) for n in assets}
    emit(research_tools={"tool": "run_inenv10_program", "card": gpu, "rc": run.returncode,
                         "seconds": seconds, "env": PROGRAM_ENV, "scores": scores,
                         "fused_rdb_launches": by_cli, "snapshot_tensors": snapshots,
                         "committed_assets_unchanged": after == assets,
                         "printed": run.stdout.splitlines()[-12:]})
    if run.returncode != 0:
        for stage in ("s1", "s2"):
            path = os.path.join(root, "results", f"inenv10_{stage}.log")
            if os.path.exists(path):
                print(f"# {stage} log tail:\n" + open(path).read()[-3000:], flush=True)
    check(run.returncode == 0, f"the program exited {run.returncode}: {run.stderr[-2000:]}")
    check(len(scores) == 8 and {(s.get("tag"), s.get("set")) for s in scores} == {
        (t, s) for t in ("s1_ema", "s1_params", "gan_ema", "gan_params")
        for s in ("degraded", "clean")}, f"the program's scores: {scores}")
    check(all(math.isfinite(s["result"]["psnr_mean"]) for s in scores),
          f"a score's PSNR is not finite: {scores}")
    check(all(snapshots.values()), f"a snapshot does not load: {snapshots}")
    check(after == assets, "the program changed the committed assets/*.npz")
    check(by_cli.get("eval_pair") == 4 * RDBS_PER_FORWARD * pairs,
          f"eval_pair launched K1 {by_cli.get('eval_pair')} times for 4 x {pairs} pairs")
    return sum(by_cli.values())


def drive_research_tools(tree_sr: np.ndarray, gpu: str) -> dict:
    """The research tools on the card (docstring item 15), in a temporary
    INENV10_ROOT.  Returns K1's launches by path."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "inenv10")
        data = os.path.join(root, "data", "InEnv10")
        research_dataset(data, tmp, gpu)
        launches = {"perf_lab_gen": research_perf_lab(gpu)}
        torch.cuda.empty_cache()
        research_tail_exp(gpu)
        torch.cuda.empty_cache()
        train_dir = os.path.join(data, "train")
        research_nan_probe(train_dir, os.path.join(tmp, "nan_probe"), gpu)
        research_grad_probe(train_dir, gpu)
        torch.cuda.empty_cache()
        launches["inenv10_program"] = research_program(root, tmp, gpu)
    emit(research_tools_seconds=time.perf_counter() - t0)
    return launches


ORBAX_DATA = os.path.join(ROOT, "tests", "data", "jax_orbax")
ORBAX_FIXTURES = ("g_c64_b1", "esrnet_c16/g_epoch_1", "gan_c16/g_epoch_1", "gan_c16/d_epoch_1")
ORBAX_G = os.path.join(ORBAX_DATA, "g_c64_b1")
# the narrow runs of tests/_make_orbax_fixtures.py, which wrote the fixtures
ORBAX_NARROW = dict(num_rrdb=1, channels=16, growth_channels=4)
ORBAX_D_CHANNELS = 4
ORBAX_VGG_NODES = ("conv1_2", "conv2_2")
ORBAX_STEPS_PER_EPOCH = 10
ORBAX_DECODE_SECONDS = 1.0


def _orbax_leaves(tree, prefix=()):
    """(path, leaf) pairs of a tree read by ``read_pytree``, in the order and
    with the names of ``leaves.json``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _orbax_leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _orbax_leaves(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def orbax_build(gpu: str) -> None:
    """Builds the zstd decoder (g++, at first use) and prints its build line."""
    from real_esrgan_tpu_torch.utils import native_build
    lib = native_build.library_path(zstd.SOURCE, native_build.BUILD_DIR, "zstd_decode",
                                    zstd.CXXFLAGS)
    built_before = lib.exists()
    t0 = time.perf_counter()
    zstd.library()
    seconds = time.perf_counter() - t0
    compiler = subprocess.run([os.environ.get("CXX", "g++"), "--version"], capture_output=True,
                              text=True, timeout=60).stdout.splitlines()[0]
    emit(orbax_build={"card": gpu, "source": os.path.relpath(zstd.SOURCE, ROOT),
                      "library": lib.name, "compiler": compiler, "flags": list(zstd.CXXFLAGS),
                      "built_here": not built_before, "seconds": round(seconds, 3)})
    check(lib.exists(), f"the decoder was not built at {lib}")


def orbax_read_fixtures() -> None:
    """Every fixture's every leaf against leaves.json (dtype, shape, SHA-256)."""
    import hashlib
    with open(os.path.join(ORBAX_DATA, "leaves.json")) as f:
        expected = json.load(f)
    read = {}
    for name in ORBAX_FIXTURES:
        t0 = time.perf_counter()
        leaves = list(_orbax_leaves(read_pytree(os.path.join(ORBAX_DATA, name))))
        ms = (time.perf_counter() - t0) * 1e3
        check([p for p, _ in leaves] == [leaf["path"] for leaf in expected[name]],
              f"{name}: the leaves' paths differ from leaves.json")
        for (path, value), leaf in zip(leaves, expected[name]):
            if leaf["dtype"] is None:
                check(value is None, f"{name}/{path} is not None")
                continue
            if isinstance(value, torch.Tensor):
                got = ("bfloat16", list(value.shape), value.view(torch.int16).numpy().tobytes())
            else:
                arr = np.asarray(value)
                got = (str(arr.dtype), list(arr.shape), arr.tobytes())
            check((got[0], got[1], hashlib.sha256(got[2]).hexdigest())
                  == (leaf["dtype"], leaf["shape"], leaf["sha256"]),
                  f"{name}/{path} differs from leaves.json")
        read[name] = {"leaves": len(leaves), "read_ms": round(ms, 2)}
    emit(orbax_leaves={"fixtures": read, "all_equal_to_leaves_json": True})


def orbax_serve(tree: np.ndarray, tmp: str) -> dict:
    """SRPipeline from the Orbax directory g_c64_b1 (one RRDB, full width) in
    both dtypes, bit for bit against the .npz cut to trunk_0.  Returns the
    Orbax route's RDB kernel launches by dtype."""
    cut = os.path.join(tmp, "c64_b1.npz")
    with np.load(WEIGHTS) as data:
        np.savez(cut, **{k: data[k] for k in data.files
                         if not k.startswith("trunk_") or k.startswith("trunk_0/")})
    launches = {}
    for dtype in (torch.bfloat16, torch.float32):
        outs = {}
        for route, path in (("orbax", ORBAX_G), ("npz_cut", cut)):
            pipe = SRPipeline(path, num_rrdb=1, bfloat16=dtype == torch.bfloat16, device="cuda")
            fused_rdb.launches = bias_lrelu.launches = 0
            outs[route] = pipe.upscale(tree)
            outs[route + "_launches"] = fused_rdb.launches
            count_tail(f"orbax_serve.{route}", dtype, bias_lrelu.launches, fused_rdb.launches,
                       rdbs_per_forward=3)
            del pipe
        launches[dtype] = outs["orbax_launches"]
        same = bool(np.array_equal(outs["orbax"], outs["npz_cut"]))
        emit(orbax_serve={"dtype": DTYPE_NAME[dtype], "weights": os.path.relpath(ORBAX_G, ROOT),
                          "num_rrdb": 1, "in": list(tree.shape[:2]),
                          "out": list(outs["orbax"].shape[:2]),
                          "fused_rdb_launches": outs["orbax_launches"],
                          "npz_cut_launches": outs["npz_cut_launches"],
                          "bit_equal_to_npz_cut": same,
                          "finite": bool(np.isfinite(outs["orbax"]).all())})
        check(outs["orbax_launches"] == 3 and outs["npz_cut_launches"] == 3,
              f"orbax serve ({DTYPE_NAME[dtype]}): fused_rdb launched {outs['orbax_launches']} "
              "times for one RRDB")
        check(same, f"orbax serve ({DTYPE_NAME[dtype]}) differs from the .npz route")
    torch.cuda.empty_cache()
    return launches


def orbax_eval_pair(tree: np.ndarray, tmp: str, gpu: str) -> int:
    """``python -m ...scripts.eval_pair --weights g_c64_b1 --num-rrdb 1`` on
    the evaluation pairs, its RDB kernel launches through
    FUSED_RDB_LAUNCH_LOG.  Returns them."""
    lr_dir, hr_dir = write_eval_pairs(tree, os.path.join(tmp, "pairs"))
    log = os.path.join(tmp, "eval_pair_launches.jsonl")
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "real_esrgan_tpu_torch.scripts.eval_pair",
                          "--weights", os.path.relpath(ORBAX_G, ROOT), "--num-rrdb", "1",
                          "--lr-dir", lr_dir, "--hr-dir", hr_dir], cwd=ROOT,
                         env=dict(os.environ, FUSED_RDB_LAUNCH_LOG=log), capture_output=True,
                         text=True, timeout=300)
    seconds = time.perf_counter() - t0
    check(run.returncode == 0, f"eval_pair on the Orbax directory exited {run.returncode}: "
                               f"{run.stderr[-2000:]}")
    summary = json.loads(run.stdout.strip().splitlines()[-1])
    launched = sum(json.loads(line)["launches"] for line in open(log))
    emit(orbax_eval_pair={"card": gpu, "seconds": round(seconds, 3), "summary": summary,
                          "fused_rdb_launches": launched})
    check(summary["n"] == len(EVAL_CROPS) and math.isfinite(summary["psnr_mean"]),
          f"eval_pair summary {summary}")
    check(launched == 3 * len(EVAL_CROPS),
          f"eval_pair launched fused_rdb {launched} times for {len(EVAL_CROPS)} images")
    return launched


def _jax_counts(path: str) -> dict:
    """step, Adam's count and the guard's lr_scale as the JAX trainer saved
    them, read raw (no conversion)."""
    raw = read_pytree(path)
    adam = raw["opt_state"][1][0]
    return {"step": int(raw["step"]) if raw.get("step") is not None else None,
            "count": int(adam["count"]), "lr_scale": float(raw["guard"]["lr_scale"]),
            "rejected_total": int(raw["guard"]["rejected_total"])}


def orbax_resume(gpu: str) -> None:
    """Both trainers resume their narrow JAX states onto the card and take
    one float32 step: finite losses, no RDB kernel launch in training, and
    step, count and lr_scale carry on from the JAX values."""
    from real_esrgan_tpu_torch.configuration import GanTrainConfig, ModelConfig, TrainConfig
    from real_esrgan_tpu_torch.models.discriminator import UNetDiscriminator
    from real_esrgan_tpu_torch.models.vgg import VGG19Features
    from real_esrgan_tpu_torch.train import esrgan, esrnet
    from real_esrgan_tpu_torch.train_realesrgan import resume_discriminator, resume_generator
    from real_esrgan_tpu_torch.train_realesrnet import resume_state

    rng = np.random.default_rng(0)
    lr = torch.from_numpy(rng.random((2, 16, 16, 3), dtype=np.float32)).cuda()
    hr = torch.from_numpy(rng.random((2, 64, 64, 3), dtype=np.float32)).cuda()
    torch.manual_seed(0)

    g_path = os.path.join(ORBAX_DATA, "esrnet_c16", "g_epoch_1")
    jax = _jax_counts(g_path)
    cfg = TrainConfig(use_bfloat16=False, remat_rrdb=False, grad_clip_norm=0.5)
    model = esrnet.build_generator(ModelConfig(**ORBAX_NARROW), cfg, "cuda")
    opt = esrnet.build_optimizer(cfg, ORBAX_STEPS_PER_EPOCH)
    state, epoch, best = resume_state(esrnet.init_state(model, opt), g_path, "cuda")
    before = {"step": state.step, "count": int(state.opt_state.count),
              "lr_scale": float(state.guard.lr_scale)}
    step = esrnet.make_train_step(model, opt, None, None, None, cfg.ema_decay,
                                  reject_limit=cfg.grad_reject_limit,
                                  rollback_after=cfg.rollback_after,
                                  reject_mult=cfg.grad_reject_mult)
    fused_rdb.launches = bias_lrelu.launches = 0
    state, metrics = step.update(state, lr, hr)
    count_tail("orbax_resume", torch.float32, bias_lrelu.launches, fused_rdb.launches)
    after = {"step": state.step, "count": int(state.opt_state.count),
             "lr_scale": float(state.guard.lr_scale),
             "rejected_total": int(state.guard.rejected_total)}
    loss = float(metrics["loss"])
    emit(orbax_resume={"stage": 1, "card": gpu, "jax": jax, "resumed": before,
                       "after_one_step": after, "epoch": epoch, "best_niqe": best, "loss": loss,
                       "device": str(state.params["conv1.weight"].device),
                       "fused_rdb_launches": fused_rdb.launches})
    check(math.isfinite(loss), f"stage 1 resumed: loss {loss}")
    check(str(state.params["conv1.weight"].device).startswith("cuda"), "stage 1 not on the card")
    check(before == {k: jax[k] for k in before}, f"stage 1 resumed at {before}, JAX {jax}")
    check(after == {"step": jax["step"] + 1, "count": jax["count"] + 1,
                    "lr_scale": jax["lr_scale"], "rejected_total": jax["rejected_total"]},
          f"stage 1 after one step {after}, JAX {jax}")
    check(fused_rdb.launches == 0, "the stage-1 step launched fused_rdb")

    g_path = os.path.join(ORBAX_DATA, "gan_c16", "g_epoch_1")
    d_path = os.path.join(ORBAX_DATA, "gan_c16", "d_epoch_1")
    jax = {"g": _jax_counts(g_path), "d": _jax_counts(d_path)}
    cfg = GanTrainConfig(use_bfloat16=False, remat_rrdb=False, vgg_nodes=ORBAX_VGG_NODES,
                         content_weights=(0.1, 1.0))
    generator = esrnet.build_generator(ModelConfig(**ORBAX_NARROW), cfg, "cuda")
    discriminator = UNetDiscriminator(channels=ORBAX_D_CHANNELS, dtype=torch.float32,
                                      device="cuda")
    vgg = VGG19Features(ORBAX_VGG_NODES, dtype=torch.float32, device="cuda").requires_grad_(False)
    g_tx, d_tx = esrgan.build_optimizers(cfg, ORBAX_STEPS_PER_EPOCH)
    state = esrgan.init_gan_state(generator, discriminator, g_tx, d_tx)
    state, epoch, best = resume_generator(state, g_path)
    state = resume_discriminator(state, d_path)

    def counts(s):
        return {"step": s.step, "g_count": int(s.g_opt.count), "d_count": int(s.d_opt.count),
                "g_lr_scale": float(s.g_guard.lr_scale), "d_lr_scale": float(s.d_guard.lr_scale)}

    before = counts(state)
    step = esrgan.make_gan_train_step(generator, discriminator, vgg, g_tx, d_tx, None, None,
                                      degrade_cfg.DegradationConfig(), cfg)
    fused_rdb.launches = bias_lrelu.launches = 0
    state, metrics = step.update(state, lr, hr)
    count_tail("orbax_resume", torch.float32, bias_lrelu.launches, fused_rdb.launches)
    after = counts(state)
    losses = {k: float(metrics[k]) for k in ("g_loss", "d_loss")}
    emit(orbax_resume={"stage": 2, "card": gpu, "jax": jax, "resumed": before,
                       "after_one_step": after, "epoch": epoch, "best_niqe": best,
                       "losses": losses, "device": str(state.d_params["conv1.weight"].device),
                       "fused_rdb_launches": fused_rdb.launches})
    check(all(math.isfinite(v) for v in losses.values()), f"stage 2 resumed: losses {losses}")
    expect = {"step": jax["g"]["step"], "g_count": jax["g"]["count"],
              "d_count": jax["d"]["count"], "g_lr_scale": jax["g"]["lr_scale"],
              "d_lr_scale": jax["d"]["lr_scale"]}
    check(before == expect, f"stage 2 resumed at {before}, JAX {expect}")
    check(after == {**expect, "step": expect["step"] + 1, "g_count": expect["g_count"] + 1,
                    "d_count": expect["d_count"] + 1},
          f"stage 2 after one step {after}, JAX {expect}")
    check(fused_rdb.launches == 0, "the stage-2 step launched fused_rdb")
    torch.cuda.empty_cache()


def orbax_decode_rate(gpu: str) -> None:
    """The decoder on every zstd frame of the fixtures (their zarr chunks),
    repeated until ORBAX_DECODE_SECONDS have passed."""
    frames = []
    for name in ORBAX_FIXTURES:
        store = OcdbtStore(os.path.join(ORBAX_DATA, name))
        frames += [store.get(k) for k in store.keys() if not k.endswith(".zarray")]
    compressed = sum(len(f) for f in frames)
    decoded = passes = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ORBAX_DECODE_SECONDS:
        decoded += sum(len(zstd.decompress(f)) for f in frames)
        passes += 1
    seconds = time.perf_counter() - t0
    emit(orbax_decode={"card": gpu, "host_cpus": os.cpu_count(), "frames": len(frames),
                       "compressed_bytes": compressed, "decoded_bytes": decoded // passes,
                       "passes": passes, "seconds": seconds,
                       "decoded_MB_per_s": decoded / seconds / 1e6,
                       "compressed_MB_per_s": compressed * passes / seconds / 1e6})


def drive_orbax(tree: np.ndarray, gpu: str) -> dict:
    """The Orbax phase (docstring item 16).  Returns the RDB kernel's
    launches of its serving and evaluation paths by dtype."""
    t0 = time.perf_counter()
    orbax_build(gpu)
    orbax_read_fixtures()
    with tempfile.TemporaryDirectory() as tmp:
        launches = orbax_serve(tree, tmp)
        eval_launches = orbax_eval_pair(tree, tmp, gpu)
    orbax_resume(gpu)
    orbax_decode_rate(gpu)
    emit(orbax_seconds=round(time.perf_counter() - t0, 1))
    return {torch.bfloat16: {"orbax_serve": launches[torch.bfloat16],
                             "orbax_eval_pair": eval_launches},
            torch.float32: {"orbax_serve": launches[torch.float32]}}


def bound(flops: float, moved: float) -> dict:
    """The least time the card could take: operations over the bf16 peak
    against bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, moved / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def tail_record(dtype: torch.dtype, shape: tuple, launches: int) -> dict:
    """The tail kernel with the shuffle at ``shape``, y's (N, 4 C, H, W): its
    time and its plain version's in turns, both again inside a CUDA graph of
    10 launches, and its bound, the bytes it moves (y read, the output
    written) over HBM's rate; no one library call computes it."""
    y, bias = tail_inputs(shape, True, dtype, torch.Generator(device="cuda").manual_seed(7))
    y = y.contiguous(memory_format=torch.channels_last)
    kernel, plain = (lambda: bias_lrelu(y, bias, True)), (lambda: bias_lrelu_plain(y, bias, True))
    check(bool(torch.equal(kernel(), plain())),
          f"the tail kernel {DTYPE_NAME[dtype]} differs from bias_lrelu_plain at {shape}")
    ms, plain_ms = in_turns(kernel, plain, 10)
    device_ms, plain_device_ms = graph_ms(kernel, 10), graph_ms(plain, 10)
    moved = 2 * y.numel() * y.element_size() + bias.numel() * bias.element_size()
    return {"name": f"tail_epilogue[{DTYPE_NAME[dtype]}]", "route": "cuda",
            "source": "real_esrgan_tpu_torch/csrc/tail_epilogue.cu",
            "replaces": "real_esrgan_tpu/models/rrdbnet.py:150", "launches": launches,
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": moved / PEAK_BYTES * 1e3, "bound_by": "bytes", "library_ms": None,
            "device_ms": device_ms, "plain_device_ms": plain_device_ms, "shape": list(shape),
            "shuffle": True, "device_tb_per_s": moved / device_ms / 1e9}


def swinir_reference(params, cfg: dict, image: np.ndarray, pipe: SRPipeline,
                     dtype: torch.dtype) -> np.ndarray:
    """The plain SwinIR reference (``benchmark/reference/swinir.py``) on the
    pipeline's geometry: the image padded to the bucket and cropped back, or
    cut into the pipeline's tiles, each run alone, their cores stitched."""
    from benchmark.reference import swinir as reference

    h, w, _ = image.shape
    if max(h, w) <= pipe.tile_threshold:
        hb, wb = -(-h // pipe.bucket) * pipe.bucket, -(-w // pipe.bucket) * pipe.bucket
        padded = np.pad(image, ((0, hb - h), (0, wb - w), (0, 0)), mode="reflect")
        x = torch.from_numpy(np.ascontiguousarray(padded, np.float32))[None].cuda()
        return reference.forward_in_blocks(params, x, cfg, 1, dtype=dtype)[0, :4 * h, :4 * w]\
            .cpu().numpy()
    tile, overlap = pipe.tile, pipe.tile_overlap
    ny, nx, core = tile_grid(h, w, tile, overlap)
    canvas = torch.from_numpy(pad_for_tiles(image, tile, overlap)).cuda()
    out = np.zeros((ny * core * 4, nx * core * 4, 3), np.float32)
    for i in range(ny):
        for j in range(nx):
            x = canvas[i * core:i * core + tile, j * core:j * core + tile][None]
            sr = reference.forward_in_blocks(params, x, cfg, 1, dtype=dtype)[0].cpu().numpy()
            out[i * core * 4:(i + 1) * core * 4, j * core * 4:(j + 1) * core * 4] = \
                sr[overlap * 4:(overlap + core) * 4, overlap * 4:(overlap + core) * 4]
    return out[:4 * h, :4 * w]


def drive_swinir(tree: np.ndarray, wide: np.ndarray) -> None:
    """SwinIR-L through ``SRPipeline(arch="swinir_l")`` on the benchmark's
    seeded weights, in bf16 and float32: the test image whole and the wide
    image in 528/8/8 tiles, each against the plain reference, with the
    window-attention kernel's and the tail kernel's launches counted."""
    from benchmark.harness import GapRatio
    from benchmark.weights_swinir import swinir_params

    t0 = time.perf_counter()
    with open(SWINIR_CONFIG) as f:
        cfg = json.load(f)
    with open(SWINIR_LIMITS) as f:
        limit = json.load(f)["limits"]["out_err_ratio"]
    params = swinir_params(cfg, SWINIR_SEED, "cuda")
    images = {"tree": tree, "wide_tiled": wide}
    refs = {}
    for dtype in (torch.bfloat16, torch.float32):
        pipe = SRPipeline(arch="swinir_l", bfloat16=dtype == torch.bfloat16, device="cuda")
        pipe.model.load_state_dict(params)
        for name, image in images.items():
            if name not in refs:
                refs[name] = {d: swinir_reference(params, cfg, image, pipe, d)
                              for d in (torch.float32, torch.bfloat16)}
            h, w, _ = image.shape
            ny, nx, _ = tile_grid(h, w, pipe.tile, pipe.tile_overlap)
            forwards = 1 if max(h, w) <= pipe.tile_threshold else -(-ny * nx // pipe.tile_batch)
            window_attn.launches = bias_lrelu.launches = 0
            out = pipe.upscale(image)
            launched, tail = window_attn.launches, bias_lrelu.launches
            WINDOW_ATTN_LAUNCHES[DTYPE_NAME[dtype]] += launched
            ref, ref16 = refs[name][torch.float32], refs[name][torch.bfloat16]
            gap = GapRatio()
            gap.add(*(torch.from_numpy(a)[None] for a in (out, ref, ref16)))
            record = {"dtype": DTYPE_NAME[dtype], "name": name, "in": [h, w],
                      "out": list(out.shape), "window_attn_launches": launched,
                      "bias_lrelu_launches": tail,
                      "max_abs_vs_reference": float(np.abs(out - ref).max()),
                      "reference_bf16_max_abs": float(np.abs(ref16 - ref).max()),
                      "out_err_ratio": gap.value(), "limit": limit}
            emit(swinir_serve=record)
            check(out.shape == (4 * h, 4 * w, 3), f"swinir {name} output shape {out.shape}")
            check(launched == WINDOW_ATTN_PER_FORWARD * forwards and
                  tail == TAIL_PER_FORWARD * forwards,
                  f"swinir {name}: {launched} window_attn and {tail} tail launches for "
                  f"{forwards} forwards")
            if dtype == torch.float32:
                check(record["max_abs_vs_reference"] <= SWINIR_F32_BOUND,
                      f"swinir f32 {name} differs from the reference by "
                      f"{record['max_abs_vs_reference']}")
            else:
                check(record["out_err_ratio"] <= limit,
                      f"swinir bf16 {name}: out_err_ratio {record['out_err_ratio']} > {limit}")
        del pipe
        torch.cuda.empty_cache()
    emit(swinir_seconds=round(time.perf_counter() - t0, 1))


def window_attn_record(dtype: torch.dtype, launches: int) -> dict:
    """The window-attention kernel at the SwinIR cell's shape, in a shifted
    block: its time and ``window_attn_plain``'s in turns, both again inside
    a CUDA graph of 10 launches, and its bound, the larger of q, k and v read
    once and the output written once over HBM's rate and its two products
    over the bf16 tensor-core rate (float32: the CUDA cores'); no call of the
    port's computes the same (``scaled_dot_product_attention`` is no kernel
    of the port)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    b, h, w, c3 = WINDOW_ATTN_SHAPE
    qkv = (torch.randn(WINDOW_ATTN_SHAPE, generator=gen, device="cuda") * 0.6).to(dtype)
    table = torch.randn(225, 8, generator=gen, device="cuda")
    kernel = (lambda: window_attn(qkv, table, 8, 4))
    plain = (lambda: window_attn_plain(qkv, table, 8, 4))
    out, ref = kernel().float(), plain().float()
    err = float((out - ref).abs().max())
    limit = 2e-5 if dtype == torch.float32 else 2 ** -8 * (1 + float(ref.abs().max()))
    check(err <= limit, f"window_attn {DTYPE_NAME[dtype]} differs from window_attn_plain by {err}")
    del out, ref
    ms, plain_ms = in_turns(kernel, plain, 10)
    device_ms, plain_device_ms = graph_ms(kernel, 10), graph_ms(plain, 3)
    tokens = b * h * w
    flops = 2 * 2 * 64 * (c3 // 3) * tokens
    moved = tokens * 4 * (c3 // 3) * qkv.element_size()
    # float32 runs its products on the CUDA cores
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_CUDA_CORE_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, moved / PEAK_BYTES * 1e3
    return {"name": f"window_attn[{DTYPE_NAME[dtype]}]", "route": "cuda",
            "source": "real_esrgan_tpu_torch/csrc/window_attn.cu", "replaces": None,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes
            else "bytes", "library_ms": None, "device_ms": device_ms,
            "plain_device_ms": plain_device_ms, "shape": list(WINDOW_ATTN_SHAPE), "shift": 4,
            "device_tb_per_s": moved / device_ms / 1e9,
            "bound_share": max(t_ops, t_bytes) / device_ms}


def conv_record(launches: int) -> dict:
    """conv3x3 mode ``full`` at the tool's default shape: in a host loop of
    20 launches (in turns with the plain version), and inside a CUDA graph
    of 20 launches (``device_ms``) beside cuDNN's ``F.conv2d`` (bf16,
    channels_last) in the same (``library_device_ms``)."""
    b, h, w_, cin, cout, tile = CONV_SHAPE
    x, w = conv_operands((b, h, w_, cin), cout)
    w = w.to(torch.bfloat16)
    weight = conv_exp.library_conv_weight(w)
    ok, err = within(conv3x3(x, w, tile=tile), conv3x3_plain(x, w))
    check(ok, "conv3x3 disagrees with conv3x3_plain at the tool's shape")
    ms, plain_ms = in_turns(lambda: conv3x3(x, w, tile=tile), lambda: conv3x3_plain(x, w), 20)
    library_device_ms = graph_ms(lambda: conv_exp.library_conv(x, weight), 20)
    device_ms = graph_ms(lambda: conv3x3(x, w, tile=tile), 20)
    flops = 2 * 9 * cin * cout * b * h * w_
    moved = 2 * (x.numel() + b * h * w_ * cout + w.numel())
    return {"name": "conv3x3[bf16]", "route": "cuda",
            "source": "real_esrgan_tpu_torch/csrc/conv3x3.cu",
            "replaces": "tools/pallas_conv_exp.py:86", "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, **bound(flops, moved),
            "library_ms": time_ms(lambda: conv_exp.library_conv(x, weight), 20),
            "device_ms": device_ms, "library_device_ms": library_device_ms,
            "shape": [b, h, w_, cin, cout], "mode": "full", "tile": tile,
            "tflops": flops / ms / 1e9, "device_tflops": flops / device_ms / 1e9}


def mm_record(kind: str, m: int, k: int, n: int, launches: int) -> dict:
    """mm_grid or mm_resident at one of the gate's shapes.  One mm_grid
    launch is shorter than its launch through the host, so ``ms``, over 200
    launches between two events, reads the host's launch rate; ``device_ms``
    is its time inside a CUDA graph of 50 launches.  mm_resident's library
    time is that of ``library_calls`` = 32 ``torch.matmul`` calls, a
    comparison of throughput: no one call computes 32 resident products, and
    ``torch.mm`` scaled by reps gives the same output with 1/32 of the work."""
    a, b = conv_exp.mm_operands(m, k, n, 0.05, torch.device("cuda"), seed=3)
    if kind == "mm_grid":
        reps, timed = 1, 200
        kernel, plain = (lambda: mm_grid(a, b)), (lambda: mm_grid_plain(a, b))
        library, line = (lambda: torch.matmul(a, b)), 119
    else:
        reps, timed = MM_REPS, 100
        kernel, plain = (lambda: mm_resident(a, b, reps)), (lambda: mm_resident_plain(a, b, reps))
        line = 159

        def library():
            for _ in range(reps):
                torch.matmul(a, b)
    ok, err = within(kernel(), plain())
    check(ok, f"{kind} disagrees with its plain version at ({m}, {k}) @ ({k}, {n})")
    ms, plain_ms = in_turns(kernel, plain, timed)
    flops = 2 * m * k * n * reps
    on_device = {"device_ms": graph_ms(kernel, 50), "library_device_ms": graph_ms(library, 50)}
    return {"name": f"{kind}[bf16,{m}x{k}x{n}]", "route": "cuda",
            "source": "real_esrgan_tpu_torch/csrc/mm_probe.cu",
            "replaces": f"tools/pallas_conv_exp.py:{line}", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_calls": reps,
            **bound(flops, 2 * (m * k + k * n + m * n)), "library_ms": time_ms(library, timed),
            "shape": [m, k, n], "reps": reps, "launches_timed": timed, **on_device,
            "tflops": flops / ms / 1e9, "device_tflops": flops / on_device["device_ms"] / 1e9}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(gpu, flush=True)
    build_kernels()

    state_dict = load_generator_params(WEIGHTS)
    tree = read_png(TREE).astype(np.float32) / 255.0          # 256 x 512
    wide = np.ascontiguousarray(np.tile(tree, (2, 4, 1)))      # 512 x 2048: 4 tiles of 528/8/8
    golden = np.load(GOLDEN)
    launches, outputs = {}, {}
    main_shapes = {dtype: set() for dtype in TOLERANCE}
    tail_shapes = {dtype: set() for dtype in TOLERANCE}
    trunk_inputs = {}
    for dtype in (torch.bfloat16, torch.float32):
        pipe = SRPipeline(WEIGHTS, bfloat16=dtype == torch.bfloat16, device="cuda")
        hook = record_rdb_shapes(main_shapes)
        fused_rdb.launches = bias_lrelu.launches = 0
        with record_tail_shapes(tail_shapes):
            outputs[dtype] = serve(pipe, dtype, tree, wide)
        launches[dtype] = fused_rdb.launches
        hook.remove()
        check(launches[dtype] > 0, f"main path ({DTYPE_NAME[dtype]}) never launched fused_rdb")
        emit(rdb_shapes={"path": "serve", "dtype": DTYPE_NAME[dtype],
                         "shapes": [list(s) for s in sorted(main_shapes[dtype])]})
        emit(tail_shapes={"path": "serve", "dtype": DTYPE_NAME[dtype],
                          "shapes": [[list(s), shuffle] for s, shuffle in
                                     sorted(tail_shapes[dtype])]})
        profile = profile_forward(pipe, tree)
        emit(profile={"dtype": DTYPE_NAME[dtype], "request": "tree forward", **profile})
        trunk_inputs[dtype] = capture_trunk_inputs(pipe, tree)
        check("device_busy_ms" not in profile or profile["fused_rdb_ms"] > 0,
              f"the {DTYPE_NAME[dtype]} profile names no kernel of {RDB_KERNEL_NAMES}")
        if dtype == torch.bfloat16:
            seam = seam_error(pipe, wide, outputs[dtype]["wide_tiled"])
            emit(seam={"dtype": "bf16", "geometry": "528/8/8", "in": list(wide.shape[:2]),
                       "interior_limit_8bit": SEAM_LIMIT, **seam})
            for stat, limit in SEAM_LIMIT.items():
                check(seam["interior_8bit"][stat] <= limit,
                      f"tiled output's interior seam {stat} {seam['interior_8bit'][stat]} "
                      f"levels exceeds {limit}")
        del pipe
        torch.cuda.empty_cache()

    tool_launches = drive_conv_exp()
    check_tool_kernels()
    eval_launches = drive_eval(tree, main_shapes)
    check_niqe()
    check_kernels(state_dict, main_shapes)
    check_tail_kernel(tail_shapes)
    for dtype in (torch.bfloat16, torch.float32):
        check_trunk_activations(state_dict, trunk_inputs.pop(dtype), dtype)
    check_autograd_guard(state_dict)
    drive_swinir(tree, wide)
    orbax_launches = drive_orbax(tree, gpu)
    tree_sr = read_png(TREE_SR)
    drive_degrade(tree_sr)
    train_launches = drive_train(tree_sr, gpu)
    drive_loaders(tree_sr, gpu)
    gan_launches = drive_gan(tree_sr, gpu)
    ddp_launches = drive_ddp(wide, outputs, gpu)
    front_end_launches = drive_front_end(tree, wide, tree_sr, gpu)
    research_launches = drive_research_tools(tree_sr, gpu)

    f32_err = float(np.abs(outputs[torch.float32]["crop67x93"] - golden).max())
    bf16_psnr = psnr(outputs[torch.bfloat16]["crop67x93"], golden)
    tree_psnr = psnr(outputs[torch.bfloat16]["tree"], outputs[torch.float32]["tree"])
    emit(golden={"f32_max_abs_err": f32_err, "f32_bound": 1e-4, "bf16_psnr_db": bf16_psnr,
                 "bf16_psnr_floor_db": 40.0, "tree_bf16_vs_f32_psnr_db": tree_psnr})
    check(f32_err <= 1e-4, f"f32 crop differs from the JAX golden output by {f32_err}")
    check(bf16_psnr >= 40.0, f"bf16 crop PSNR {bf16_psnr:.2f} dB against the JAX golden output")

    trainers = {torch.bfloat16: {"train_validation": train_launches, **gan_launches,
                                 "tiled_devices": ddp_launches[torch.bfloat16],
                                 **front_end_launches, **research_launches,
                                 **orbax_launches[torch.bfloat16]},
                torch.float32: {"train_validation": 0, "gan_validation": 0, "npz_snapshot": 0,
                                "tiled_devices": ddp_launches[torch.float32],
                                **orbax_launches[torch.float32]}}
    emit(fused_rdb_launches={DTYPE_NAME[d]: {"serve": launches[d], "eval": eval_launches[d],
                                             **trainers[d]}
                             for d in launches})
    emit(bias_lrelu_launches=TAIL_LAUNCHES)
    kernels = [kernel_record(state_dict, d, launches[d] + eval_launches[d]
                             + sum(trainers[d].values()))
               for d in (torch.bfloat16, torch.float32)]
    # upconv2 of the batch cell (16 x 256^2 in) in bf16, of the tree image in f32
    kernels += [tail_record(d, shape, sum(TAIL_LAUNCHES[DTYPE_NAME[d]].values()))
                for d, shape in ((torch.bfloat16, (16, 256, 512, 512)),
                                 (torch.float32, (1, 256, 512, 1024)))]
    kernels += [window_attn_record(d, WINDOW_ATTN_LAUNCHES[DTYPE_NAME[d]])
                for d in (torch.bfloat16, torch.float32)]
    kernels.append(conv_record(tool_launches["conv3x3"]))
    kernels += [mm_record(kind, m, k, n, tool_launches[kind])
                for kind in ("mm_grid", "mm_resident") for m, k, n in conv_exp.GATE_SHAPES]
    emit(seconds=round(time.perf_counter() - t_start, 1))
    emit(kernels=kernels)
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
