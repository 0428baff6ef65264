"""The RDB probe tool (real_esrgan_tpu_torch/tools/rdb_probe.py) on the CPU.

Its variants are the kernels' source with a few lines replaced; each
replacement must find its text exactly once in ``csrc/fused_rdb.cu`` as it
is, so that an edit of the kernel cannot leave the probe measuring something
else.  The tool itself runs only on the card.
"""

import pytest
import torch

from real_esrgan_tpu_torch.ops import _build
from real_esrgan_tpu_torch.tools import rdb_probe


@pytest.mark.parametrize("name", list(rdb_probe.VARIANTS))
def test_variant_applies_to_the_kernel_source(name):
    source = (_build.CSRC / "fused_rdb.cu").read_text()
    variant = rdb_probe.variant_source(name)
    assert (variant == source) == (name in ("shipped", "bf16_shipped"))
    assert variant.count("rdb_f32_split_kernel(Params p)") == 1
    # dtype 1 launches the wgmma kernel, or for the mma.sync variants the
    # earlier schedule built back, never both
    assert variant.count("if (dtype == 1) return") == 1
    assert ("rdb_bf16_kernel(Params p)" in variant) == ("mma_sync" in name)
    assert variant.count("{") == variant.count("}")


def test_unknown_variant_raises_before_any_build():
    with pytest.raises(KeyError):
        rdb_probe.variant_source("no_such_variant")


def test_probe_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("runs the probe's CPU refusal only where there is no CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rdb_probe.main(["--variants", "shipped"])


def test_variants_of_each_dtype():
    names = {d: [n for n in rdb_probe.VARIANTS if rdb_probe.variant_dtype(n) == d]
             for d in rdb_probe.DTYPES}
    assert names["bf16"][:2] == ["bf16_shipped", "bf16_no_products"]
    assert names["bf16"][-3:] == ["bf16_mma_sync", "bf16_mma_sync_no_products",
                                  "bf16_mma_sync_no_slice_barrier"]
    assert "shipped" in names["f32"] and "no_products" in names["f32"]
    with pytest.raises(ValueError, match="one dtype"):
        rdb_probe.main(["--variants", "shipped,bf16_shipped"])
