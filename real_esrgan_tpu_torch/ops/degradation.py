"""The full second-order Real-ESRGAN degradation: the port of
real_esrgan_tpu/ops/degradation.py.

The reference's per-batch degradation prelude of its trainers (USM, two
blur -> random resize -> noise -> JPEG stages, a final resize + sinc + JPEG
in a random order, a paired crop) with the JAX package's semantics:

* Every intermediate lives on a static canvas (``canvas1_for(up1)``,
  ``canvas2_for(up2)``) with the valid content in its top-left corner and a
  valid extent beside it; resizes clamp their taps to that extent, the band
  beyond it holds edge-replicated values, and the second blur and DiffJPEG
  see that band as the JAX package's do (its boundary band).
* Randomness has the reference's granularity: per sample where it draws
  tensors (noise strengths, gray masks, JPEG qualities, blur kernels, crops,
  orientation), per batch where it uses Python RNG (resize kind, scale and
  mode, the noise family, the second blur, the final order).
* The crop corner is drawn on the LR grid and multiplied by the scale, so
  each pair is exactly aligned.

torch's RNG is not JAX's, so ``degrade`` is two steps.  ``draw_degradation``
draws every random value into a ``DegradationDraws``: the per-batch choices
on a CPU generator, as Python values, so the apply step never waits for the
device to pick a branch; the per-sample tensors and the standard normals
with the generator of the device they are used on.  ``apply_degradation`` is
deterministic given the draws (but for the exact Poisson sampler, which takes
a generator), so it can also run on the JAX package's own draws.

The blurs round where the JAX package's bf16 ``filter2d`` rounds; every
float32 product and convolution runs in true float32 (``true_f32``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from real_esrgan_tpu_torch.configuration import (
    DegradationConfig, KernelSynthesisConfig, PipelineGeometry,
)
from real_esrgan_tpu_torch.ops.augment import (
    apply_orientation, crop_pairs, draw_crop_corners, random_orientation,
)
from real_esrgan_tpu_torch.ops.blur_kernels import (
    KernelDraws, draw_final_sinc, draw_stage_kernels, identity_kernel, kernels_of,
)
from real_esrgan_tpu_torch.ops.diffjpeg import diff_jpeg
from real_esrgan_tpu_torch.ops.filter2d import filter2d
from real_esrgan_tpu_torch.ops.noise import gaussian_noise, poisson_noise
from real_esrgan_tpu_torch.ops.resize import INV_255, resize_dynamic_static_method
from real_esrgan_tpu_torch.ops.usm import gaussian_kernel_1d, usm_sharpen


@dataclasses.dataclass
class NoiseDraws:
    """One noise stage: ``gaussian`` (the batch's family, else Poisson),
    per-sample ``gray`` mask (1.0: luma noise), ``sigma`` (255-range) and
    Poisson ``scale``, and the standard normals of the stage's canvas, colour
    (B, C, C, 3) and gray (B, C, C, 1), which either family uses."""

    gaussian: bool
    gray: torch.Tensor
    sigma: torch.Tensor
    scale: torch.Tensor
    normal: torch.Tensor
    normal_gray: torch.Tensor


@dataclasses.dataclass
class DegradationDraws:
    """Every random value of one batch's degradation.

    Per sample, (B,) tensors: ``orientation`` (rot90 count, hflip, vflip;
    None without augmentation), the ``kernel1``/``kernel2``/``sinc`` kernel
    parameters, ``blur1`` (first blur on), JPEG ``quality1``/``quality2`` and
    the LR-grid crop corners ``crop_top``/``crop_left``.  Per batch, Python
    values: ``blur2`` (second blur on), the resize scales ``scale1``/
    ``scale2`` (float32 values), the resize modes ``method1``..``method3``
    (0 area, 1 bilinear, 2 bicubic) and ``order`` (True: resize, sinc, JPEG;
    False: JPEG, resize, sinc).  ``noise1``/``noise2`` hold both."""

    orientation: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    kernel1: KernelDraws
    kernel2: KernelDraws
    sinc: KernelDraws
    blur1: torch.Tensor
    blur2: bool
    scale1: float
    scale2: float
    method1: int
    method2: int
    method3: int
    noise1: NoiseDraws
    noise2: NoiseDraws
    quality1: torch.Tensor
    quality2: torch.Tensor
    order: bool
    crop_top: torch.Tensor
    crop_left: torch.Tensor

    def to(self, device) -> "DegradationDraws":
        """The same draws with every tensor on ``device``."""
        return _map_tensors(self, lambda t: t.to(device))


def _map_tensors(obj, fn):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, tuple):
        return tuple(_map_tensors(v, fn) for v in obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _map_tensors(getattr(obj, f.name), fn)
                                           for f in dataclasses.fields(obj)})
    return obj


def draws_to_arrays(draws: DegradationDraws) -> dict:
    """The draws as a flat dict of numpy arrays (``np.savez``'s input),
    keyed by dotted field names; the orientation's three tensors are
    ``orientation.0`` .. ``orientation.2``."""
    out = {}

    def walk(prefix, obj):
        if dataclasses.is_dataclass(obj):
            for f in dataclasses.fields(obj):
                walk(f"{prefix}{f.name}.", getattr(obj, f.name))
        elif isinstance(obj, tuple):
            for i, v in enumerate(obj):
                walk(f"{prefix}{i}.", v)
        elif obj is not None:
            out[prefix[:-1]] = (obj.cpu().numpy() if isinstance(obj, torch.Tensor)
                                else np.asarray(obj))
    walk("", draws)
    return out


def draws_from_arrays(arrays) -> DegradationDraws:
    """``draws_to_arrays``' inverse: tensors on the CPU, per-batch values as
    Python numbers."""
    def tensor(key):
        return torch.from_numpy(np.array(arrays[key]))

    def kernel(prefix):
        fields = {f.name: tensor(f"{prefix}.{f.name}") for f in dataclasses.fields(KernelDraws)
                  if f"{prefix}.{f.name}" in arrays}
        return KernelDraws(**fields)

    def noise(prefix):
        return NoiseDraws(gaussian=bool(arrays[f"{prefix}.gaussian"]),
                          **{k: tensor(f"{prefix}.{k}")
                             for k in ("gray", "sigma", "scale", "normal", "normal_gray")})

    orientation = (tuple(tensor(f"orientation.{i}") for i in range(3))
                   if "orientation.0" in arrays else None)
    return DegradationDraws(
        orientation=orientation, kernel1=kernel("kernel1"), kernel2=kernel("kernel2"),
        sinc=kernel("sinc"), blur1=tensor("blur1"), blur2=bool(arrays["blur2"]),
        scale1=float(arrays["scale1"]), scale2=float(arrays["scale2"]),
        method1=int(arrays["method1"]), method2=int(arrays["method2"]),
        method3=int(arrays["method3"]), noise1=noise("noise1"), noise2=noise("noise2"),
        quality1=tensor("quality1"), quality2=tensor("quality2"), order=bool(arrays["order"]),
        crop_top=tensor("crop_top"), crop_left=tensor("crop_left"))


def _host_uniform(host: torch.Generator) -> float:
    return float(torch.rand((), generator=host))


def _draw_uniform(host: torch.Generator, lo: float, hi: float) -> float:
    """One float32 value of U(lo, hi) from the host generator."""
    return float(np.float32(_host_uniform(host)) * np.float32(hi - lo) + np.float32(lo))


def _draw_batch_scale(host: torch.Generator, up: bool, probs: Tuple[float, float, float],
                      srange: Tuple[float, float]) -> float:
    """One resize scale for the whole batch, as the reference draws its
    updown type and scale once a batch.  The up-vs-not choice is ``up``
    (drawn by the caller: it picks the canvas); without it, keep has its
    conditional probability among down and keep."""
    if up:
        return _draw_uniform(host, 1.0, srange[1])
    denom = probs[1] + probs[2]
    p_keep = probs[2] / denom if denom > 0 else 0.0
    keep = _host_uniform(host) < p_keep
    down = _draw_uniform(host, srange[0], 1.0)
    return 1.0 if keep else down


def _draw_method(host: torch.Generator) -> int:
    """A resize mode for the batch: 0 area, 1 bilinear, 2 bicubic."""
    return int(torch.randint(0, 3, (), generator=host))


def draw_batch_choices(host: torch.Generator, dcfg: DegradationConfig, up1: bool,
                       up2: bool) -> dict:
    """The per-batch choices, as Python values, from the CPU generator
    ``host``: ``scale1``/``scale2``, ``method1``..``method3``, the noise
    families ``gaussian1``/``gaussian2`` (``<=`` the Gaussian probability),
    ``blur2`` and ``order`` (both ``<``)."""
    return dict(
        scale1=_draw_batch_scale(host, up1, dcfg.resize_probs1, dcfg.resize_range1),
        method1=_draw_method(host),
        gaussian1=_host_uniform(host) <= dcfg.gaussian_noise_prob1,
        blur2=_host_uniform(host) < dcfg.second_blur_prob,
        scale2=_draw_batch_scale(host, up2, dcfg.resize_probs2, dcfg.resize_range2),
        method2=_draw_method(host),
        gaussian2=_host_uniform(host) <= dcfg.gaussian_noise_prob2,
        method3=_draw_method(host),
        order=_host_uniform(host) < 0.5)


def _draw_noise(generator: Optional[torch.Generator], batch: int, canvas: int, gaussian: bool,
                sigma_range: Tuple[float, float], poisson_scale_range: Tuple[float, float],
                gray_prob: float, device) -> NoiseDraws:
    """One noise stage of the batch's family ``gaussian`` on a
    ``canvas``-sized batch: strengths, gray masks and normals a sample."""
    def uniform(lo, hi):
        return torch.rand(batch, generator=generator, device=device) * (hi - lo) + lo
    gray = (torch.rand(batch, generator=generator, device=device) < gray_prob).float()
    sigma = uniform(*sigma_range)
    scale = uniform(*poisson_scale_range)
    normal = torch.randn((batch, canvas, canvas, 3), generator=generator, device=device)
    normal_gray = torch.randn((batch, canvas, canvas, 1), generator=generator, device=device)
    return NoiseDraws(gaussian=gaussian, gray=gray, sigma=sigma, scale=scale, normal=normal,
                      normal_gray=normal_gray)


def draw_degradation(generator: Optional[torch.Generator], batch: int, geo: PipelineGeometry,
                     kcfg: KernelSynthesisConfig, dcfg: DegradationConfig,
                     up1: bool = False, up2: bool = False, augment: bool = True,
                     host_generator: Optional[torch.Generator] = None,
                     device=None) -> DegradationDraws:
    """Every random value of one batch.

    ``generator`` draws the per-sample tensors and the normals on ``device``
    (its own device when ``device`` is None); ``host_generator``, a CPU
    generator, draws the per-batch choices, and defaults to ``generator``
    when that is a CPU generator."""
    device = torch.device(device) if device is not None else (
        generator.device if generator is not None else torch.device("cpu"))
    if host_generator is None:
        if generator is not None and generator.device.type != "cpu":
            raise ValueError("a CUDA generator needs a CPU host_generator for the per-batch draws")
        host_generator = generator if generator is not None else torch.default_generator
    b = batch
    batch_choices = draw_batch_choices(host_generator, dcfg, up1, up2)
    gaussian1, gaussian2 = batch_choices.pop("gaussian1"), batch_choices.pop("gaussian2")

    def uniform(lo, hi):
        return torch.rand(b, generator=generator, device=device) * (hi - lo) + lo

    crop_top, crop_left = draw_crop_corners(generator, b, (geo.hr_size, geo.hr_size),
                                            geo.crop_size, geo.scale, device)
    return DegradationDraws(
        orientation=random_orientation(generator, b, device) if augment else None,
        kernel1=draw_stage_kernels(generator, b, kcfg, 1, device),
        kernel2=draw_stage_kernels(generator, b, kcfg, 2, device),
        sinc=draw_final_sinc(generator, b, kcfg, device),
        blur1=torch.rand(b, generator=generator, device=device) <= dcfg.first_blur_prob,
        noise1=_draw_noise(generator, b, geo.canvas1_for(up1), gaussian1, dcfg.noise_range1,
                           dcfg.poisson_scale_range1, dcfg.gray_noise_prob1, device),
        noise2=_draw_noise(generator, b, geo.canvas2_for(up2), gaussian2, dcfg.noise_range2,
                           dcfg.poisson_scale_range2, dcfg.gray_noise_prob2, device),
        quality1=uniform(*dcfg.jpeg_range1), quality2=uniform(*dcfg.jpeg_range2),
        crop_top=crop_top, crop_left=crop_left, **batch_choices)


def generator_seed(*words: int) -> int:
    """A 63-bit ``torch.Generator`` seed from integers, e.g. (seed, step):
    one stream per tuple, as the JAX package folds an index into its key."""
    state = np.random.SeedSequence(list(words)).generate_state(1, np.uint64)[0]
    return int(state >> np.uint64(1))


def _extent(size: int, scale: float) -> int:
    """floor(size * scale) in float32, as the JAX package computes it."""
    return int(np.floor(np.float32(size) * np.float32(scale)))


def _batched_resize(images: torch.Tensor, in_extent: int, out_extent: int,
                    out_canvas: int, method: int, final: bool = False) -> torch.Tensor:
    """One resize of the whole batch; ``final``: the resize to the LR size,
    whose output extent the JAX program holds as a constant."""
    return resize_dynamic_static_method(images, (in_extent, in_extent), (out_extent, out_extent),
                                        (out_canvas, out_canvas), method, reciprocal_out=final)


def _mixed_noise(image: torch.Tensor, draws: NoiseDraws, poisson_approx: bool,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """The batch's noise family on every sample, with its strengths and gray
    masks; clipped to [0, 1]."""
    if draws.gaussian:
        noise = gaussian_noise(image, draws.sigma, draws.gray, draws.normal, draws.normal_gray)
    else:
        noise = poisson_noise(image, draws.scale, draws.gray, poisson_approx, draws.normal,
                              draws.normal_gray, generator)
    return torch.clamp(image + noise, 0.0, 1.0)


def _blur(image: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    return filter2d(image, kernels, compute_dtype=torch.bfloat16)


def apply_degradation(hr_uint8: torch.Tensor, draws: DegradationDraws, geo: PipelineGeometry,
                      kcfg: KernelSynthesisConfig, dcfg: DegradationConfig,
                      up1: bool = False, up2: bool = False,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Synthesize (lr, hr) pairs from HR crops with the given draws.

    Args:
        hr_uint8: (B, hr_size, hr_size, 3) uint8 RGB (or float in [0, 1]).
        draws: ``draw_degradation``'s draws for this batch, on the input's
            device, at the canvases of ``up1``/``up2``.
        generator: the exact Poisson sampler's (``dcfg.poisson_approx``
            False); unused otherwise.

    Returns:
        lr: (B, lr_crop, lr_crop, 3) float32 in [0, 1], on 8-bit levels.
        hr: (B, crop, crop, 3) float32 in [0, 1]: the raw, unsharpened target.
    """
    hr_size, lr_size = geo.hr_size, geo.lr_size
    c1, c2 = geo.canvas1_for(up1), geo.canvas2_for(up2)

    hr = hr_uint8.float()
    if hr_uint8.dtype == torch.uint8:
        hr = hr * INV_255
    if draws.orientation is not None:
        hr = apply_orientation(hr, *draws.orientation)

    out = usm_sharpen(hr, gaussian_kernel_1d(dcfg.usm_radius, 0.0), dcfg.usm_weight,
                      dcfg.usm_threshold)
    k1, k2, sinc = kernels_of((draws.kernel1, draws.kernel2, draws.sinc), kcfg.pad_to)

    # ---------------- first-order degradation ----------------
    k1 = torch.where(draws.blur1[:, None, None], k1, identity_kernel(kcfg.pad_to, hr.device))
    out = _blur(out, k1)
    extent1 = _extent(hr_size, draws.scale1)
    out = _batched_resize(out, hr_size, extent1, c1, draws.method1)
    out = _mixed_noise(out, draws.noise1, dcfg.poisson_approx, generator)
    out = diff_jpeg(torch.clamp(out, 0.0, 1.0), draws.quality1)

    # ---------------- second-order degradation ----------------
    if draws.blur2:
        out = _blur(out, k2)
    extent2 = _extent(lr_size, draws.scale2)
    out = _batched_resize(out, extent1, extent2, c2, draws.method2)
    out = _mixed_noise(out, draws.noise2, dcfg.poisson_approx, generator)

    # ---------------- final stage, in the batch's order ----------------
    if draws.order:      # resize -> sinc -> JPEG
        out = _batched_resize(out, extent2, lr_size, lr_size, draws.method3, final=True)
        out = diff_jpeg(torch.clamp(_blur(out, sinc), 0.0, 1.0), draws.quality2)
    else:                # JPEG -> resize -> sinc
        out = diff_jpeg(torch.clamp(out, 0.0, 1.0), draws.quality2)
        out = _batched_resize(out, extent2, lr_size, lr_size, draws.method3, final=True)
        out = _blur(out, sinc)

    # quantize to 8-bit levels
    lr = torch.clamp(torch.round(out * 255.0), 0.0, 255.0) * INV_255
    return crop_pairs(lr, hr, draws.crop_top, draws.crop_left, geo.crop_size, geo.scale)


def degrade(generator: Optional[torch.Generator], hr_uint8: torch.Tensor, geo: PipelineGeometry,
            kcfg: KernelSynthesisConfig, dcfg: DegradationConfig, augment: bool = True,
            up1: bool = False, up2: bool = False,
            host_generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``draw_degradation`` on the input's device, then
    ``apply_degradation``: (lr, hr) pairs from uint8 HR crops.

    ``up1``/``up2`` are the per-batch flags of whether the stage-1 / stage-2
    resize upscales, drawn by the caller with probabilities
    ``dcfg.resize_probs{1,2}[0]``: they pick the canvas sizes."""
    draws = draw_degradation(generator, hr_uint8.shape[0], geo, kcfg, dcfg, up1, up2, augment,
                             host_generator, hr_uint8.device)
    return apply_degradation(hr_uint8, draws, geo, kcfg, dcfg, up1, up2, generator)
