"""The RDB probe tool (real_esrgan_tpu_torch/tools/rdb_probe.py) on the CPU.

Its variants are the float32 kernel's source with a few lines replaced; each
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
    assert (variant == source) == (name == "shipped")
    assert variant.count("rdb_f32_split_kernel(Params p)") == 1
    assert variant.count("{") == variant.count("}")


def test_unknown_variant_raises_before_any_build():
    with pytest.raises(KeyError):
        rdb_probe.variant_source("no_such_variant")


def test_probe_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("runs the probe's CPU refusal only where there is no CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rdb_probe.main(["--variants", "shipped"])
