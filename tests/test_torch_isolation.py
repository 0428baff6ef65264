"""The port imports neither JAX nor the JAX package, nor the libraries that
read Orbax checkpoints (Orbax, TensorStore, ``zstandard``): it reads them
with its own decoder.

A fresh interpreter imports every module of ``real_esrgan_tpu_torch`` and
``chip_smoke`` (and so everything they import), then lists the forbidden
modules it holds.  ``real_esrgan_tpu_torch`` itself starts with the string
``real_esrgan_tpu``, so names are matched exactly or with a ``.`` suffix.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, json, pkgutil, sys
import real_esrgan_tpu_torch
names = [m.name for m in pkgutil.walk_packages(real_esrgan_tpu_torch.__path__,
                                               "real_esrgan_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
forbidden = ("jax", "jaxlib", "flax", "optax", "orbax", "real_esrgan_tpu", "cv2",
             "tensorstore", "zstandard")
held = sorted(m for m in sys.modules
              if any(m == f or m.startswith(f + ".") for f in forbidden))
print(json.dumps({"imported": names, "forbidden": held}))
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    result = json.loads(run.stdout.strip().splitlines()[-1])
    assert result["forbidden"] == []
    for module in ("ops.fused_rdb", "ops._build", "models.rrdbnet", "models.convert",
                   "train.checkpoint", "utils.imgio", "parallel.tiling", "serve", "inference",
                   "ops.resize", "ops.conv3x3", "ops.mm_probe", "utils.meters", "metrics.niqe",
                   "test", "scripts.eval_pair", "tools.conv_exp", "tools.rdb_probe",
                   "configuration", "ops.color", "ops.filter2d", "ops.usm", "ops.diffjpeg",
                   "ops.augment", "ops.blur_kernels", "ops.noise", "ops.degradation",
                   "ops.host", "scripts.make_degraded_eval", "config", "models.ema",
                   "train.schedule", "train.optim", "train.guard", "train.esrnet",
                   "data.dataset", "data.prefetcher", "train_realesrnet", "utils.hostmem",
                   "models.discriminator", "models.vgg", "train.esrgan", "train_realesrgan",
                   "data.device_pool", "data.native_loader", "data.grain_loader",
                   "parallel", "parallel.mesh", "tools.dp_check", "utils.profiling", "bench",
                   "scripts.serve_http", "graft_entry", "scripts.validate_parity",
                   "scripts.make_lr", "tools.tile_sweep", "scripts.snapshot_weights",
                   "tools.make_inenv_dataset", "tools.perf_lab", "tools.tail_exp",
                   "tools.nan_probe", "tools.explode_analysis", "tools.grad_probe",
                   "utils.zstd", "utils.ocdbt", "utils.orbax_read", "utils.native_build",
                   "scripts.export_torch"):
        assert f"real_esrgan_tpu_torch.{module}" in result["imported"]
