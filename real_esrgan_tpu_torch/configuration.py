"""The degradation's configuration: the port's copy of
``KernelSynthesisConfig``, ``DegradationConfig`` and ``PipelineGeometry``
from real_esrgan_tpu/configuration.py.

They are pure-Python frozen dataclasses (hashable, so usable as cache keys),
copied rather than imported because the port imports nothing of the JAX
package.  The training configurations join them with the trainer.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class KernelSynthesisConfig:
    """Blur-kernel synthesis parameters (the reference's
    ``degradation_model_parameters_dict``).

    Every kernel is evaluated on a fixed ``pad_to``-sized grid with its
    ``size`` x ``size`` support masked, which equals generating it at its
    size and zero-padding it to ``pad_to``.
    """

    pad_to: int = 21                       # "sinc_kernel_size": all kernels padded to this
    kernel_sizes: Tuple[int, ...] = (7, 9, 11, 13, 15, 17, 19, 21)
    # type order matches the reference list: isotropic, anisotropic,
    # generalized_{iso,aniso}, plateau_{iso,aniso}
    kernel_type_probs1: Tuple[float, ...] = (0.45, 0.25, 0.12, 0.03, 0.12, 0.03)
    sinc_prob1: float = 0.1
    sigma_range1: Tuple[float, float] = (0.2, 3.0)
    generalized_beta_range1: Tuple[float, float] = (0.5, 4.0)
    plateau_beta_range1: Tuple[float, float] = (1.0, 2.0)

    kernel_type_probs2: Tuple[float, ...] = (0.45, 0.25, 0.12, 0.03, 0.12, 0.03)
    sinc_prob2: float = 0.1
    sigma_range2: Tuple[float, float] = (0.2, 1.5)
    generalized_beta_range2: Tuple[float, float] = (0.5, 4.0)
    plateau_beta_range2: Tuple[float, float] = (1.0, 2.0)

    final_sinc_prob: float = 0.8           # "sinc_kernel_probability3"


@dataclasses.dataclass(frozen=True)
class DegradationConfig:
    """Second-order degradation process parameters (the reference's
    ``degradation_process_parameters_dict``)."""

    first_blur_prob: float = 1.0
    resize_probs1: Tuple[float, float, float] = (0.2, 0.7, 0.1)   # up / down / keep
    resize_range1: Tuple[float, float] = (0.15, 1.5)
    gray_noise_prob1: float = 0.4
    gaussian_noise_prob1: float = 0.5
    noise_range1: Tuple[float, float] = (1.0, 30.0)
    poisson_scale_range1: Tuple[float, float] = (0.05, 3.0)
    jpeg_range1: Tuple[float, float] = (30.0, 95.0)

    second_blur_prob: float = 0.8
    resize_probs2: Tuple[float, float, float] = (0.3, 0.4, 0.3)
    resize_range2: Tuple[float, float] = (0.3, 1.2)
    gray_noise_prob2: float = 0.4
    gaussian_noise_prob2: float = 0.5
    noise_range2: Tuple[float, float] = (1.0, 25.0)
    poisson_scale_range2: Tuple[float, float] = (0.05, 2.5)
    jpeg_range2: Tuple[float, float] = (30.0, 95.0)

    # Cornish-Fisher skew-corrected rounded-normal Poisson instead of the
    # exact sampler.  It matches the first three moments; its KS distance to
    # the exact pmf is <= 0.027 at lam = 0.25 (darkest pixels) and <= 0.005
    # for lam >= 2, and the residual then passes through JPEG, a resize and
    # 8-bit quantization.  False draws exact Poisson counts.
    poisson_approx: bool = True

    # USM sharpening of the HR target before degradation: radius 51 (50
    # rounded up to odd), sigma 0 -> cv2's size-derived sigma, weight 0.5,
    # threshold 10.
    usm_radius: int = 51
    usm_weight: float = 0.5
    usm_threshold: float = 10.0


@dataclasses.dataclass(frozen=True)
class PipelineGeometry:
    """Static canvas geometry of the degradation pipeline.

    The reference resizes to data-dependent intermediate shapes.  Here every
    intermediate lives on a fixed canvas with the valid content in the
    top-left corner and a valid extent beside it; random-scale resizes are
    gathers whose taps clamp to that extent.
    """

    hr_size: int = 400          # prepared crop size
    crop_size: int = 256        # HR training crop
    scale: int = 4              # upscale factor

    @property
    def lr_size(self) -> int:
        return self.hr_size // self.scale

    @property
    def lr_crop_size(self) -> int:
        return self.crop_size // self.scale

    # The resize KIND (up/down/keep) is drawn per batch on the host, so each
    # batch runs on the smallest canvas its branch needs: up-batches get the
    # 1.5x/1.2x canvas, down/keep-batches the 1.0x one.

    def canvas1_for(self, up: bool) -> int:
        """Stage-1 canvas (/16 for JPEG blocks)."""
        factor = 1.5 if up else 1.0
        return _round_up(int(self.hr_size * factor), 16)

    def canvas2_for(self, up: bool) -> int:
        """Stage-2 canvas (/16 for JPEG blocks)."""
        factor = 1.2 if up else 1.0
        return _round_up(int(self.lr_size * factor), 16)

    @property
    def canvas1(self) -> int:
        return self.canvas1_for(True)

    @property
    def canvas2(self) -> int:
        return self.canvas2_for(True)
