"""NIQE on the card against the CPU and the JAX golden.  (``chip_smoke.py``
drives the evaluation entry points, the ``test`` CLI and ``eval_pair``, and
holds the RDB kernel at every shape they give it.)

Marked ``cuda``: the test skips without a CUDA device.  This file imports no
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_eval.py
"""

import json
import os

import pytest
import torch

from _torch_card import ROOT, TREE_SR, cuda  # noqa: F401  (cuda is a fixture)

pytestmark = pytest.mark.cuda

NIQE_GOLDEN = os.path.join(ROOT, "tests", "data", "jax_niqe_tree_sr.json")


def test_niqe_on_the_card_with_tf32_allowed_equals_the_cpu_and_jax(cuda, monkeypatch):
    """NIQE of tests/data/tree_sr.png on the card with TF32 allowed for
    float32 products and convolutions (a filter that fell into TF32 would
    show): within 1e-2 of the committed JAX score and 1e-3 of the port's own
    CPU score."""
    from real_esrgan_tpu_torch.metrics.niqe import NIQE
    from real_esrgan_tpu_torch.utils.imgio import load_image_rgb

    with open(NIQE_GOLDEN) as f:
        golden = json.load(f)
    image = load_image_rgb(TREE_SR)[None]
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    card = float(NIQE(crop_border=golden["crop_border"], device="cuda")(image)[0])
    cpu = float(NIQE(crop_border=golden["crop_border"], device="cpu")(image)[0])
    assert abs(card - golden["score"]) <= 1e-2, (card, golden["score"])
    assert abs(card - cpu) <= 1e-3, (card, cpu)
