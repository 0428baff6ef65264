"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names, and the plain reference loads nothing of
the program either."""

import json
import subprocess
import sys

from benchmark.run import forbidden_loaded
from benchmark.tests.conftest import ROOT


def test_whole_top_level_names():
    assert forbidden_loaded(["real_esrgan_tpu_torch", "real_esrgan_tpu_torch.serve",
                             "jaxtyping", "flaxen", "numpy"]) == []
    assert forbidden_loaded(["real_esrgan_tpu.ops.pallas_rdb", "jax._src", "jaxlib",
                             "flax.linen", "optax", "orbax.checkpoint"]) == [
        "flax", "jax", "jaxlib", "optax", "orbax", "real_esrgan_tpu"]


def _loaded_by(imports: str) -> list:
    code = (f"import sys, json; {imports}; "
            "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, env={"PATH": "/usr/bin:/bin"})
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_and_drivers_load_no_jax():
    loaded = _loaded_by("import benchmark.run, benchmark.calibrate, benchmark.drivers.batch, "
                        "benchmark.drivers.requests")
    assert forbidden_loaded(loaded) == []
    assert "real_esrgan_tpu_torch" in loaded


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded_by("import benchmark.reference.generator, benchmark.reference.serve, "
                        "benchmark.reference.quant, "
                        "benchmark.weights, benchmark.workcount")
    assert forbidden_loaded(loaded) == []
    assert "real_esrgan_tpu_torch" not in loaded
