"""The port's ``tools/tile_sweep.py`` against the JAX tool at in_size 256,
one RRDB, float32 on the CPU, the JAX weights carried across: the rows have
the JAX rows' keys and the same geometry figures, and the seam error of each
geometry is within the seam bound (PERF.md section 2: max 16, mean 0.5 of
8-bit levels) of the JAX tool's.  The port's last tile batch holds only the
tiles left, where the JAX tool repeats tiles to fill it, so with a short last
batch the port's ``useful_frac`` is the JAX one without that waste."""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from real_esrgan_tpu.models import Generator as JaxGenerator
from real_esrgan_tpu_torch.models import Generator
from real_esrgan_tpu_torch.models.convert import state_dict_from_jax_params
from real_esrgan_tpu_torch.serve import no_grad_forward
from real_esrgan_tpu_torch.tools import tile_sweep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEAM_BOUND = {"max": 16.0, "mean": 0.5}
CPU = [torch.device("cpu")]

torch.set_num_threads(2)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_tile_sweep", os.path.join(ROOT, "tools", "tile_sweep.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def tools():
    model = JaxGenerator(upscale_factor=4, num_rrdb=1)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"]
    port = Generator(num_rrdb=1).eval()
    port.load_state_dict(state_dict_from_jax_params(jax.device_get(params)))
    return {"jax": _jax_tool(), "jax_apply": jax.jit(lambda p, x: model.apply({"params": p}, x)),
            "params": params, "port": [no_grad_forward(port)]}


# (tile, overlap, tile_batch): 16 tiles in 2 full batches; 4 tiles in a
# batch of 8 (the JAX tool repeats 4); the JAX mesh has 8 devices
@pytest.mark.parametrize("combo", [(72, 4, 8), (136, 4, 8)], ids=["full", "short_last"])
def test_geometry_rows_match_jax(tools, combo):
    tile, overlap, tile_batch = combo
    ours = tile_sweep.measure_geometry(tools["port"], CPU, 256, tile, overlap, tile_batch, 1)
    ref = tools["jax"].measure_geometry(tools["jax_apply"], tools["params"], 256, tile,
                                        overlap, tile_batch, 1)
    print(json.dumps({"port": ours, "jax": ref}))
    assert set(ours) == set(ref)
    for key in ("tile", "overlap", "tile_batch", "tiles", "batches"):
        assert ours[key] == ref[key], key
    filled = ref["batches"] * ref["tile_batch"] / ref["tiles"]
    assert ours["useful_frac"] == pytest.approx(ref["useful_frac"] * filled, abs=1e-3)
    assert ours["mp_per_s"] > 0


@pytest.mark.parametrize("combo", [(72, 4, 8), (48, 8, 8)], ids=["72_4", "48_8"])
def test_seam_error_within_the_bound_of_jax(tools, combo):
    tile, overlap, tile_batch = combo
    ours = tile_sweep.seam_error(tools["port"], CPU, tile, overlap, tile_batch, in_size=128)
    ref = tools["jax"].seam_error(tools["jax_apply"], tools["params"], tile, overlap,
                                  tile_batch, in_size=128)
    print(json.dumps({"port": ours, "jax": ref}))
    assert set(ours) == set(ref)
    for part in ("all_8bit", "interior_8bit"):
        assert set(ours[part]) == set(ref[part])
    for stat, bound in SEAM_BOUND.items():
        assert abs(ours["interior_8bit"][stat] - ref["interior_8bit"][stat]) <= bound


def test_stage_breakdown_row_has_the_jax_keys(tools):
    ours = tile_sweep.stage_breakdown(tools["port"], CPU, 128, 72, 4, 8, 1)
    ref = tools["jax"].stage_breakdown(tools["jax_apply"], tools["params"], 128, 72, 4, 8, 1)
    assert set(ours) == set(ref)
    # 4 tiles of 72 at 128: one batch, which the JAX tool fills with 4 repeats
    assert ours["useful_frac"] == pytest.approx(2 * ref["useful_frac"], abs=1e-3)
    assert ours["raw_net_s"] > 0 and ours["tiled_s"] > 0


def test_cli_prints_a_row_a_combo(capsys):
    tile_sweep.main(["--cpu", "--in-size", "64", "--iters", "1", "--num-rrdb", "1",
                     "--combos", "40,4,2;48,8,4"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [(r["tile"], r["overlap"], r["tile_batch"]) for r in rows] == [(40, 4, 2), (48, 8, 4)]
