"""Port parity of the conv/matmul experiment tool on the CPU:
real_esrgan_tpu_torch/ops/conv3x3.py, ops/mm_probe.py and tools/conv_exp.py
against tools/pallas_conv_exp.py.

On the CPU the port's wrappers run their plain versions.  The JAX tool's
``pallas_conv`` runs in Pallas interpret mode (the fixture of
tests/test_pallas_rdb.py); the tool is imported by path, since ``tools/`` is
no package.  Its two matmul probes build their inputs inside, so their
three-line kernel bodies are stated again here under
``pl.pallas_call(interpret=True)``.

Bounds: bf16 results atol/rtol 2e-2 (one rounding to bf16 of an f32 sum taken
in another order; measured: at most one bf16 step); against an f32
convolution of the same bf16-rounded operands 1e-2 + 2^-8 relative (the final
rounding alone); the copy modes ``patch`` and ``dma`` are exact.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from test_pallas_rdb import interpret_pallas  # noqa: F401  (fixture)

from real_esrgan_tpu_torch.ops.conv3x3 import MODES, conv3x3, conv3x3_plain
from real_esrgan_tpu_torch.ops.mm_probe import (
    mm_grid, mm_grid_plain, mm_resident, mm_resident_plain,
)
from real_esrgan_tpu_torch.tools import conv_exp

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONV_CASES = [((1, 32, 16, 64), 64), ((2, 64, 32, 32), 96)]
CONV_IDS = ["1x32x16x64to64", "2x64x32x32to96"]
MM_CASES = [(256, 192, 192), (256, 576, 192)]


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "pallas_conv_exp", os.path.join(ROOT, "tools", "pallas_conv_exp.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def conv_operands(shape, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, shape[-1], cout)) * 0.05).astype(np.float32)
    return x, w


def to_bf16(array):
    return torch.from_numpy(array).to(torch.bfloat16)


def as_f32(jax_array):
    return np.asarray(jax_array.astype(jnp.float32))


@pytest.mark.parametrize("shape,cout", CONV_CASES, ids=CONV_IDS)
def test_conv3x3_full_matches_interpreted_pallas_conv(jax_tool, interpret_pallas, shape, cout):
    x, w = conv_operands(shape, cout)
    ours = conv3x3(to_bf16(x), torch.from_numpy(w), tile=32)
    ref = jax_tool.pallas_conv(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), tile=32)
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == ref.shape == (*shape[:3], cout)
    np.testing.assert_allclose(ours.float().numpy(), as_f32(ref), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("shape,cout", CONV_CASES, ids=CONV_IDS)
def test_conv3x3_full_matches_an_f32_lax_conv(shape, cout):
    x, w = conv_operands(shape, cout, seed=1)
    ours = conv3x3(to_bf16(x), torch.from_numpy(w), tile=32).float().numpy()
    xr, wr = (jnp.asarray(v, jnp.bfloat16).astype(jnp.float32) for v in (x, w))
    ref = np.asarray(jax.lax.conv_general_dilated(
        xr, wr, (1, 1), ((1, 1), (1, 1)), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST))
    np.testing.assert_allclose(ours, ref, atol=1e-2, rtol=2 ** -8)


@pytest.mark.parametrize("mode", ["patch", "dma"])
@pytest.mark.parametrize("shape,cout", CONV_CASES, ids=CONV_IDS)
def test_conv3x3_copy_modes_equal_interpreted_pallas_conv(jax_tool, interpret_pallas, shape, cout,
                                                           mode):
    x, w = conv_operands(shape, cout, seed=2)
    ours = conv3x3(to_bf16(x), torch.from_numpy(w), tile=32, mode=mode)
    ref = jax_tool.pallas_conv(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), tile=32, mode=mode)
    np.testing.assert_array_equal(ours.float().numpy(), as_f32(ref))


def test_conv3x3_dots_has_the_output_shape_only():
    x, w = conv_operands((1, 32, 16, 64), 64)
    out = conv3x3(to_bf16(x), torch.from_numpy(w), tile=32, mode="dots")
    assert tuple(out.shape) == (1, 32, 16, 64) and out.dtype == torch.bfloat16


def mm_operands(m, k, n, scale, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            (rng.standard_normal((k, n)) * scale).astype(np.float32))


@pytest.mark.parametrize("m,k,n", MM_CASES)
def test_mm_grid_plain_matches_the_interpreted_kernel_body(m, k, n):
    """The body of bench_mosaic_mm (acc32=True) over its grid of row blocks."""
    a, b = mm_operands(m, k, n, 0.05)

    def kern(a_ref, b_ref, o_ref):
        d = jnp.dot(a_ref[...], b_ref[...], preferred_element_type=jnp.float32)
        o_ref[...] = d.astype(jnp.bfloat16)

    grid_m = 128
    ref = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((m, n), jnp.bfloat16), grid=(m // grid_m,),
        in_specs=[pl.BlockSpec((grid_m, k), lambda i: (i, 0)),
                  pl.BlockSpec((k, n), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((grid_m, n), lambda i: (i, 0)), interpret=True,
    )(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
    ours = mm_grid(to_bf16(a), to_bf16(b))
    assert torch.equal(ours, mm_grid_plain(to_bf16(a), to_bf16(b)))
    np.testing.assert_allclose(ours.float().numpy(), as_f32(ref), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("m,k,n", MM_CASES)
def test_mm_resident_plain_matches_the_interpreted_kernel_body(m, k, n):
    """The body of bench_mosaic_mm_vmem: reps products summed in f32."""
    a, b = mm_operands(m, k, n, 0.01, seed=1)
    reps = 32

    def kern(a_ref, b_ref, o_ref):
        def body(i, acc):
            return acc + jnp.dot(a_ref[...], b_ref[...], preferred_element_type=jnp.float32)
        acc = jax.lax.fori_loop(0, reps, body, jnp.zeros((m, n), jnp.float32))
        o_ref[...] = acc.astype(jnp.bfloat16)

    ref = pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct((m, n), jnp.bfloat16),
                         interpret=True)(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
    ours = mm_resident(to_bf16(a), to_bf16(b), reps=reps)
    assert torch.equal(ours, mm_resident_plain(to_bf16(a), to_bf16(b), reps))
    np.testing.assert_allclose(ours.float().numpy(), as_f32(ref), atol=2e-2, rtol=2e-2)


def _conv_args(shape=(1, 16, 32, 32), cout=96):
    x, w = conv_operands(shape, cout)
    return to_bf16(x), torch.from_numpy(w)


@pytest.mark.parametrize("case", ["x_dtype", "w_dtype", "rank", "cin", "tile_not_8", "h_tile",
                                  "w_16", "cout_32", "not_contiguous", "unaligned", "mode",
                                  "patch_too_wide"])
def test_conv3x3_rejects_what_the_kernel_does_not_take(case):
    x, w = _conv_args()
    tile, mode, error = 8, "full", ValueError
    if case == "x_dtype":
        x, error = x.float(), TypeError
    elif case == "w_dtype":
        w, error = w.half(), TypeError
    elif case == "rank":
        x = x[0]
    elif case == "cin":
        w = w[:, :, :16].contiguous()
    elif case == "tile_not_8":
        tile = 4
    elif case == "h_tile":
        x = x[:, :12]
    elif case == "w_16":
        x = x[:, :, :24].contiguous()
    elif case == "cout_32":
        w = w[..., :48].contiguous()
    elif case == "not_contiguous":
        x = x.transpose(1, 2)
    elif case == "unaligned":
        x = torch.empty(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)
    elif case == "mode":
        mode = "half"
    elif case == "patch_too_wide":
        w, mode = torch.zeros(3, 3, 32, 128), "patch"
    with pytest.raises(error):
        conv3x3(x, w, tile=tile, mode=mode)


@pytest.mark.parametrize("fn", [mm_grid, mm_resident], ids=["mm_grid", "mm_resident"])
@pytest.mark.parametrize("case", ["dtype", "m_64", "k_16", "n_32", "inner", "not_contiguous",
                                  "unaligned"])
def test_mm_probes_reject_what_the_kernels_do_not_take(fn, case):
    a, b = (to_bf16(v) for v in mm_operands(128, 96, 160, 0.05))
    error = ValueError
    if case == "dtype":
        a, b, error = a.float(), b.float(), TypeError
    elif case == "m_64":
        a = a[:100]
    elif case == "k_16":
        a, b = a[:, :40].contiguous(), b[:40]
    elif case == "n_32":
        b = b[:, :150].contiguous()
    elif case == "inner":
        b = b[:80]
    elif case == "not_contiguous":
        a = a.t().contiguous().t()
    elif case == "unaligned":
        b = torch.empty(b.numel() + 1, dtype=b.dtype)[1:].view(b.shape)
    with pytest.raises(error):
        fn(a, b)


def test_mm_probe_limits_and_launch_counts_on_the_cpu():
    a, b = (to_bf16(v) for v in mm_operands(128, 96, 160, 0.05))
    with pytest.raises(ValueError, match="acc32"):
        mm_grid(a, b, acc32=False)
    with pytest.raises(ValueError, match="reps"):
        mm_resident(a, b, reps=0)
    with pytest.raises(ValueError, match="shared memory"):
        mm_resident(torch.zeros(64, 4096, dtype=torch.bfloat16),
                    torch.zeros(4096, 32, dtype=torch.bfloat16))
    x, w = _conv_args()
    before = (conv3x3.launches, mm_grid.launches, mm_resident.launches)
    conv3x3(x, w, tile=8), mm_grid(a, b), mm_resident(a, b)
    assert (conv3x3.launches, mm_grid.launches, mm_resident.launches) == before == (0, 0, 0)


def test_plain_patch_is_the_dy0_patch_row():
    x, w = _conv_args((1, 8, 16, 16), 32)
    out = conv3x3_plain(x, w, "patch")
    assert torch.equal(out[0, 1:, 1:, :16], x[0, :-1, :-1])      # band dx=0: x(y-1, x-1)
    assert torch.equal(out[0, 1:, :, 16:32], x[0, :-1])          # band dx=1: x(y-1, x)
    assert float(out[0, 0].abs().max()) == 0.0                   # row -1 is padding


def test_tool_prints_the_line_set_of_the_jax_tool(capsys):
    conv_exp.main(["--cpu", "--batch", "1", "--size", "32", "--iters", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "device: cpu"
    assert lines[1].startswith("max |conv3x3 - library| = ") and lines[1].endswith("(bf16 inputs)")
    assert float(lines[1].split("=")[1].split()[0]) < conv_exp.NUMERICS_BOUND
    assert lines[2].startswith("library conv 64->192:")
    assert [line.split("]")[0] for line in lines[3:]] == [f"conv3x3[{m:5s}" for m in MODES]
    assert all(line.rstrip().endswith("TF/s") for line in lines[2:])


def test_tool_mm_prints_one_line_a_shape(capsys):
    conv_exp.main(["--cpu", "--mm", "--iters", "1"])
    lines = capsys.readouterr().out.strip().splitlines()[1:]
    assert len(lines) == len(conv_exp.MM_SHAPES) == 5
    assert lines[1].startswith("mm_resident (8192x576)@(576x192) reps=32:")


@pytest.mark.parametrize("threshold", [None, 1e9], ids=["default_threshold", "threshold_flag"])
def test_tool_gate_prints_one_json_verdict(capsys, threshold):
    flags = ["--cpu", "--gate", "--iters", "1"]
    if threshold is not None:
        flags += ["--gate-threshold", str(threshold)]
    conv_exp.main(flags)
    lines = capsys.readouterr().out.strip().splitlines()
    verdict = json.loads(lines[-1])
    assert {"gate", "value", "threshold", "library_tflops", "unparked", "device", "note",
            "timing", "shapes"} <= set(verdict)
    assert verdict["device"] == "cpu" and verdict["gate"] == "mm_resident_tflops"
    assert verdict["timing"] == "host loop"  # a CUDA graph on the card only
    shapes = verdict["shapes"]
    assert [tuple(s["shape"]) for s in shapes] == list(conv_exp.GATE_SHAPES)
    for s in shapes:  # held shape by shape, each against its own library rate
        assert s["unparked"] == (s["value"] >= s["threshold"])
        if threshold is None:
            assert s["threshold"] == pytest.approx(s["library_tflops"] / 2)
    worst = min(shapes, key=lambda s: s["value"] / s["threshold"])
    assert [verdict[key] for key in ("value", "threshold", "library_tflops")] == \
        [worst[key] for key in ("value", "threshold", "library_tflops")]
    assert verdict["unparked"] == all(s["unparked"] for s in shapes)
    assert verdict["unparked"] == (verdict["value"] >= verdict["threshold"])
    if threshold is None:
        assert verdict["threshold"] == pytest.approx(verdict["library_tflops"] / 2, abs=0.06)
    else:
        assert verdict["threshold"] == threshold and verdict["unparked"] is False
    assert sum(line.startswith("{") for line in lines) == 1


def test_tool_reps_sweep_splits_fixed_from_per_rep_time(capsys):
    records = conv_exp.main(["--cpu", "--reps-sweep", "--iters", "1"])
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()[1:]]
    assert lines == records and [tuple(r["shape"]) for r in records] == list(conv_exp.GATE_SHAPES)
    for r in records:
        assert r["reps"] == list(conv_exp.SWEEP_REPS) and len(r["ms"]) == len(r["reps"])
        assert r["device"] == "cpu" and r["timing"] == "host loop"
        # the least-squares line passes through the mean of the points
        mean_r = sum(r["reps"]) / len(r["reps"])
        assert r["fixed_ms"] + r["per_rep_ms"] * mean_r == pytest.approx(sum(r["ms"]) / len(r["ms"]))
        m, k, n = r["shape"]
        assert r["per_rep_tflops"] == pytest.approx(2 * m * k * n / r["per_rep_ms"] / 1e9)


def test_tool_without_cpu_flag_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the tool runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        conv_exp.main(["--size", "32"])
