"""The closed-form work counts against PyTorch's FLOP counter on the port's
plain generator, and at full width the figures the benchmark states."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import workcount
from real_esrgan_tpu_torch.models.rrdbnet import Generator


@pytest.mark.parametrize("blocks,feat,grow", [(1, 16, 8), (2, 8, 4), (3, 12, 6)])
def test_closed_form_matches_flop_counter(blocks, feat, grow):
    cfg = dict(num_in_ch=3, num_out_ch=3, num_feat=feat, num_block=blocks, num_grow_ch=grow,
               scale=4, dtype="float32")
    model = Generator(num_rrdb=blocks, channels=feat, growth=grow, packed=False,
                      subpixel=False).eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(torch.rand(2, 12, 20, 3))
    expected = workcount.forward_flop(cfg, 2, 12, 20)
    assert abs(counter.get_total_flops() - expected) <= 1e-4 * expected


def test_full_width_figures():
    x4 = dict(num_in_ch=3, num_out_ch=3, num_feat=64, num_block=23, num_grow_ch=32, scale=4,
              dtype="bfloat16")
    anime = dict(x4, num_block=6)
    assert workcount.dense_block_flop(x4) == 479_232
    assert workcount.forward_flop_per_lr_pixel(x4) == 35_853_696
    assert workcount.flop_per_output_mp(x4) == pytest.approx(2.2409e12, rel=1e-4)
    assert workcount.flop_per_output_mp(anime) == pytest.approx(7.133e11, rel=1e-4)


def test_dense_block_bound_by_operations_at_serving_sizes():
    x4 = dict(num_in_ch=3, num_out_ch=3, num_feat=64, num_block=23, num_grow_ch=32, scale=4,
              dtype="bfloat16")
    peaks = {"flops": {"bfloat16": 989.4e12}, "bytes_per_s": 3.35e12}
    # PERF.md's K1 bound: 0.0635 ms at 1 x 256 x 512
    assert workcount.dense_block_least_seconds(x4, 256 * 512, peaks) == pytest.approx(
        0.0635e-3, rel=2e-3)
