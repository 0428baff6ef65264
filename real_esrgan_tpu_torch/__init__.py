"""PyTorch/CUDA port of real_esrgan_tpu for NVIDIA Hopper GPUs.

The JAX package ``real_esrgan_tpu`` stays the reference; this package imports
none of it.  Entry points run on CUDA unless the caller asks for the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(cpu: bool = False) -> torch.device:
    """``cpu`` when asked for, else the first CUDA device; raises without CUDA."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' (or --cpu) "
                           "to run on the CPU")
    return torch.device("cuda")
