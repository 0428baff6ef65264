"""PyTorch/CUDA port of real_esrgan_tpu for NVIDIA Hopper GPUs.

The JAX package ``real_esrgan_tpu`` stays the reference; this package imports
none of it.  Entry points run on CUDA unless the caller asks for the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(cpu: bool = False) -> torch.device:
    """``cpu`` when asked for, else this rank's CUDA device
    (``parallel.mesh.local_device``: the current one without a process
    group); raises without CUDA."""
    from real_esrgan_tpu_torch.parallel.mesh import local_device

    return local_device(cpu)
