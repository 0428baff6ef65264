"""The port's copy of real_esrgan_tpu/configuration.py: the degradation's
``KernelSynthesisConfig``, ``DegradationConfig`` and ``PipelineGeometry``,
and the model and trainer configurations ``ModelConfig``, ``TrainConfig``
and ``GanTrainConfig``, with the same fields and defaults.

They are pure-Python frozen dataclasses (hashable, so usable as cache keys),
copied rather than imported because the port imports nothing of the JAX
package.  The loader fields (``loader``, ``decoded_cache_bytes``,
``device_pool_budget_bytes``) drive the trainers' ``make_train_loader``.
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


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    in_channels: int = 3
    out_channels: int = 3
    upscale_factor: int = 4
    num_rrdb: int = 23
    channels: int = 64
    growth_channels: int = 32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Shared trainer knobs (reference config.py:82-150)."""

    exp_name: str = "RealESRNet_baseline"
    train_image_dir: str = "./data/DIV2K/Real_ESRGAN/train"
    valid_image_dir: str = "./data/DIV2K/Real_ESRGAN/valid"
    test_lr_image_dir: str = "./data/Set5/LRbicx4"
    test_hr_image_dir: str = "./data/Set5/GTmod12"

    batch_size: int = 48
    num_workers: int = 4
    # "auto" = the device pool when the set fits device_pool_budget_bytes,
    # else the native C++ pool, else Python threads; "device" = force the
    # pool; "grain" = the deterministic resumable stream (data/grain_loader.py);
    # "threads" = force the Python ThreadedLoader
    loader: str = "auto"
    # decoded-image RAM cache budget for the epoch loop (both the C++ pool
    # and the Python loader): 0 disables; the default holds ~4.6k decoded
    # 400px crops — prepared-crop datasets stop re-decoding every epoch
    decoded_cache_bytes: int = 2 * 1024**3
    # "auto" loader upgrade: when the whole crop set fits this device-memory
    # budget as one uint8 stack (and the run is single-process), keep it
    # device-resident and gather batches by index on the device
    # (data/device_pool.py in the JAX package).  0 disables the device pool.
    device_pool_budget_bytes: int = 2 * 1024**3
    epochs: int = 1298
    lr: float = 2e-4
    betas: Tuple[float, float] = (0.9, 0.99)
    ema_decay: float = 0.999
    seed: int = 0
    print_frequency: int = 200
    resume: str = ""
    # save an epoch checkpoint every N epochs (1 = reference parity; raise it
    # when checkpoint IO dominates, e.g. short epochs through a remote fs —
    # best/last copies are still maintained on saving epochs)
    checkpoint_frequency: int = 1
    # overlap checkpoint IO with the next epoch's compute (AsyncSaver:
    # on-device state snapshot + background fetch/serialize; the reference
    # blocks on torch.save each epoch, train_realesrnet.py:117-129)
    async_checkpoint: bool = True

    # StepLR for ESRNet (step = epochs // 5, gamma 0.5; config.py:105-106);
    # 0 means "derive from epochs" so overriding epochs keeps the decay
    # schedule proportional, as the reference's config module does
    lr_step_size: int = 0
    lr_gamma: float = 0.5

    @property
    def effective_lr_step_size(self) -> int:
        return self.lr_step_size or max(1, self.epochs // 5)

    # bf16 compute (the counterpart of the reference's CUDA AMP autocast)
    use_bfloat16: bool = True
    # checkpoint (rematerialize) each RRDB block during training to bound
    # activation memory
    remat_rrdb: bool = True

    # Optimizer hygiene (deviation from the reference, which has none — and
    # whose long runs depend on divergence not happening).  Two measured
    # failure modes motivate these knobs (full post-mortem in train/guard.py):
    # (1) one gradient-overflow step makes raw Adam's second moment inf
    # FOREVER, silently freezing the run; (2) the RRDB trunk can go
    # super-critical (forward amplifies ~1e22 with params maxabs 0.19), after
    # which merely SKIPPING bad updates freezes the run at the diverged
    # weights.  grad_clip_norm bounds what finite gradients feed Adam (0
    # disables).  skip_nonfinite_updates enables the step-level guard
    # (train/guard.py): reject any update whose global grad norm is
    # non-finite or above grad_reject_limit, and after rollback_after
    # consecutive rejections restore params from the EMA (a ~1000-step-lagged
    # healthy copy) and zero Adam's moments.  Limits sit far above the
    # measured healthy band (global norms 5-50 on InEnv10) so only genuine
    # divergence is touched.
    grad_clip_norm: float = 100.0
    skip_nonfinite_updates: bool = True
    grad_reject_limit: float = 500.0
    rollback_after: int = 4
    # adaptive reject ceiling: reject any step whose global grad norm exceeds
    # grad_reject_mult x a running average of ACCEPTED norms (guard.gnorm_ref)
    # — the healthy band moves as loss falls, so the fixed limit alone admits
    # divergence-ramp steps at 2-10x healthy (the round-4 storm; see
    # train/guard.py).  0 disables, restoring the fixed-limit-only guard.
    grad_reject_mult: float = 8.0

    # Training-loss clamp mode (the round-4 root cause fix; full rationale in
    # models/rrdbnet.py::Generator.clamp):
    #   "none" — loss on the RAW pre-clamp output (basicsr-upstream RRDBNet
    #            behavior; default).  The reference's in-forward clamp makes
    #            the L1 loss blind to output magnitude once pixels saturate,
    #            removing the restoring force that keeps the RRDB trunk
    #            sub-critical — the measured InEnv10 collapse.
    #   "st"   — clamped values, straight-through gradient (rounds 1-4).
    #   "hard" — the reference's exact clamp (the reference model's forward).
    # Eval/inference always clamp; this only affects the training loss path.
    train_clamp: str = "none"

    # linear LR warmup over the first N steps (0 = reference parity: none);
    # the measured fresh-init divergence fired at step 106 of a cold start
    lr_warmup_steps: int = 0


@dataclasses.dataclass(frozen=True)
class GanTrainConfig(TrainConfig):
    """Stage-2 GAN knobs (reference config.py:111-150)."""

    exp_name: str = "RealESRGAN_baseline"
    epochs: int = 519
    lr: float = 1e-4
    resume_d: str = ""
    resume_g: str = ""

    pixel_weight: float = 1.0
    content_weights: Tuple[float, ...] = (0.1, 0.1, 1.0, 1.0, 1.0)
    adversarial_weight: float = 0.1

    # MultiStepLR milestones at 12.5/25/50/75% of epochs, gamma 0.5
    # (reference config.py:146); empty means "derive from epochs"
    lr_milestones: Tuple[int, ...] = ()
    lr_gamma: float = 0.5

    @property
    def effective_lr_milestones(self) -> Tuple[int, ...]:
        if self.lr_milestones:
            return self.lr_milestones
        return tuple(int(self.epochs * f) for f in (0.125, 0.250, 0.500, 0.750))

    # VGG19 feature taps used by the content loss (reference config.py:131):
    # torchvision nodes features.{2,7,16,25,34} are the PRE-activation
    # outputs of these convs
    vgg_nodes: Tuple[str, ...] = ("conv1_2", "conv2_2", "conv3_4", "conv4_4",
                                  "conv5_4")
    vgg_weights_path: str = ""   # torchvision vgg19 .pth; random init if empty
