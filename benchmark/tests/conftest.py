"""CPU tests of the benchmark: run from the repository's root with
``python -m pytest benchmark/tests``.  Tests marked ``cuda`` run on the
chip and skip elsewhere, deciding inside the test."""

import json
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def tiny_config() -> dict:
    """The x4plus configuration cut to a CPU test: two RRDBs, float32."""
    with open(ROOT / "benchmark" / "configs" / "realesrgan_x4plus.json") as f:
        cfg = json.load(f)
    return dict(cfg, num_block=2, dtype="float32")


@pytest.fixture(autouse=True)
def few_threads():
    torch.set_num_threads(4)
