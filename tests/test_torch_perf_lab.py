"""The port's ``tools/perf_lab.py`` against the JAX tool's own formulations.

* The four RDB formulations (packed, naive, im2col, dxpack) against JAX's
  ``rdb_packed``/``rdb_naive``/``rdb_im2col``/``rdb_dxpack`` on the same
  weights and input, float32 on the CPU: max abs <= 1e-4 (the f32 parity
  bound; only summation orders differ).  The packed form is also held to
  the generator's ``rdb_plain`` on the same weights, and the port's
  ``pack_source_major`` and ``im2col`` to JAX's exactly.
* ``shift3`` + ``conv31`` (a 3x1 conv on dx-packed channels) against a 3x3
  conv with the same kernel: 1e-4, and ``shift3`` against JAX's exactly.
* Every experiment once on the CPU at ``--batch 1 --size 16 --iters 1
  --rrdb 1``, the matrix-product peak at 64 and 128 in place of 4096 and
  8192 (``PEAK_SIZES``), the degradation at its hr 400: each returns finite
  readings above 0, and no degradation case fails.
"""

import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_esrgan_tpu_torch.ops.fused_rdb import pack_rdb_weights, rdb_plain
from real_esrgan_tpu_torch.tools import perf_lab

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))

import perf_lab as jax_lab  # noqa: E402

TOL = 1e-4


@pytest.fixture(scope="module")
def operands():
    kernels, biases = perf_lab.rand_weights("cpu", seed=3)
    biases = [torch.from_numpy(np.random.default_rng(i).normal(0, 0.05, b.shape)
                               .astype(np.float32)) for i, b in enumerate(biases)]
    x = torch.from_numpy(np.random.default_rng(7).random((2, 12, 17, perf_lab.C))
                         .astype(np.float32))
    jk = [jnp.asarray(k.numpy()) for k in kernels]
    jb = [jnp.asarray(b.numpy()) for b in biases]
    return kernels, biases, x, jk, jb, jnp.asarray(x.numpy())


@pytest.mark.parametrize("name,jax_name", [("rdb", "rdb_packed"), ("rdb_naive", "rdb_naive"),
                                           ("rdb_im2col", "rdb_im2col"),
                                           ("rdb_dxpack", "rdb_dxpack")])
def test_rdb_forms_match_jax(operands, name, jax_name):
    kernels, biases, x, jk, jb, jx = operands
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(getattr(jax_lab, jax_name)(jk, jb, jx))
    ours = perf_lab.RDB_FORMS[name](kernels, biases, x).numpy()
    assert ours.shape == ref.shape == tuple(x.shape)
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)


def test_packed_form_is_the_generators_rdb_plain(operands):
    kernels, biases, x, *_ = operands
    oihw = [k.permute(3, 2, 0, 1) for k in kernels]
    plain = rdb_plain(x, pack_rdb_weights(oihw, biases, perf_lab.C, perf_lab.G, torch.float32))
    np.testing.assert_allclose(perf_lab.rdb_packed(kernels, biases, x).numpy(), plain.numpy(),
                               atol=TOL, rtol=0)


def test_packing_and_im2col_equal_jax(operands):
    kernels, _, x, jk, _, jx = operands
    for ours, ref in zip(perf_lab.pack_source_major(kernels), jax_lab._pack_source_major(jk)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(perf_lab.im2col(x).numpy(), np.asarray(jax_lab._im2col(jx)))
    np.testing.assert_array_equal(perf_lab.shift3(x).numpy(), np.asarray(jax_lab._shift3(jx)))


@pytest.mark.parametrize("cin,cout", [(64, 32), (32, 64), (96, 160)])
def test_conv31_on_shift3_is_a_3x3_conv(cin, cout):
    rng = np.random.default_rng(cin + cout)
    x = torch.from_numpy(rng.random((2, 9, 14, cin)).astype(np.float32))
    k = torch.from_numpy(rng.normal(0, 0.05, (3, 3, cin, cout)).astype(np.float32))
    ours = perf_lab.conv31(perf_lab.shift3(x), k).numpy()
    ref = perf_lab._conv(x, k).numpy()
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)
    with jax.default_matmul_precision("highest"):
        jref = np.asarray(jax_lab._conv31(jax_lab._shift3(jnp.asarray(x.numpy())),
                                          jnp.asarray(k.numpy())))
    np.testing.assert_allclose(ours, jref, atol=TOL, rtol=0)


def _readings(result):
    for records in result.values():
        for record in records if isinstance(records, list) else [records]:
            yield record


def test_every_experiment_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(perf_lab, "PEAK_SIZES", (64, 128))
    flags = ["--cpu", "--batch", "1", "--size", "16", "--iters", "1", "--rrdb", "1"]
    result = perf_lab.main(["all", *flags])
    result["gen_no_subpixel"] = perf_lab.main(["gen", "--no-subpixel", *flags])["gen"]
    assert set(result) == set(perf_lab.EXPERIMENTS) | {"gen_no_subpixel"}
    for record in _readings(result):
        assert "failed" not in record, record
        rate = record.get("tflops", record.get("mp_per_s", record.get("ms")))
        assert math.isfinite(rate) and rate > 0, record
    assert len(result["deg"]) == 13 and len(result["convscan"]) == 7
    assert result["gen"]["subpixel"] and not result["gen_no_subpixel"]["subpixel"]
    printed = capsys.readouterr().out
    assert "geometry: hr=400 canvas1=608 canvas2=128 batch=1" in printed
    assert "peak: 128^3 bf16 matmul" in printed


def test_a_failing_degradation_case_is_printed_and_passed(monkeypatch, capsys):
    cases = {"good": (lambda v: v * 2, torch.ones(2)),
             "bad": (lambda v: v.reshape(3), torch.ones(2))}
    monkeypatch.setattr(perf_lab, "deg_cases", lambda batch, device: cases)
    out = perf_lab.run_deg(perf_lab.build_parser().parse_args(["deg", "--iters", "1"]),
                           torch.device("cpu"))
    assert [r["case"] for r in out] == ["good", "bad"] and "failed" in out[1]
    assert "bad                           : FAILED RuntimeError" in capsys.readouterr().out
