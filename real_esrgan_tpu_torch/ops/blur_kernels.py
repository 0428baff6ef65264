"""Random blur-kernel synthesis for the degradation: the port of
real_esrgan_tpu/ops/blur_kernels.py.

The reference generates a KxK kernel (K random in {7..21}) and zero-pads it
to 21x21.  That equals evaluating the kernel's profile on the fixed 21x21
grid and masking the cells outside the KxK support, so every kernel of a
batch is one float32 evaluation on one grid.

The kernels are rounded to bf16 before the blur, so a last-bit difference
in a weight can move it across a rounding boundary.  The grids are evaluated
in float32 in the JAX package's order of operations, with cos, sin, exp and
pow correctly rounded (the same bits on every device), the Bessel
polynomials in fused steps and the normalizing sum left to right, as XLA's
CPU backend computes them.

Each sampler is split into a draw of its parameters (``draw_stage_kernels``,
``draw_final_sinc``: size, type, sigma_x, sigma_y, theta, beta, omega_c and
the sinc coin, as a ``KernelDraws`` of (B,) tensors) and the deterministic
grid functions (``stage_kernels``, ``final_sinc_kernels``), so the grids can
be evaluated from the JAX package's own draws.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Tuple

import torch

from real_esrgan_tpu_torch.configuration import KernelSynthesisConfig
from real_esrgan_tpu_torch.ops.resize import correct_sqrt, reciprocal


def _rounded(fn, x: torch.Tensor, *args) -> torch.Tensor:
    """``fn`` evaluated in float64 and rounded once to ``x``'s dtype: the
    correctly rounded value on every device (float32 cos, exp and pow differ
    between the CPU, the card and XLA in the last bit)."""
    return fn(x.double(), *[a.double() if torch.is_tensor(a) else a for a in args]).to(x.dtype)


def _fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """a * b + c rounded once, as XLA's CPU backend fuses a multiply into the
    add that consumes it (the product of two float32 values is exact in
    float64)."""
    return (a.double() * b.double() + (c.double() if torch.is_tensor(c) else c)).to(a.dtype)


def _horner(y: torch.Tensor, coeffs) -> torch.Tensor:
    """c0 + y * (c1 + y * (c2 + ...)), each step one fused multiply-add."""
    acc = torch.full_like(y, coeffs[-1])
    for c in reversed(coeffs[:-1]):
        acc = _fma(y, acc, float(torch.tensor(c, dtype=y.dtype)))
    return acc


def bessel_j1(x: torch.Tensor) -> torch.Tensor:
    """Bessel function of the first kind, order 1, in ``x``'s dtype: the JAX
    package's Abramowitz & Stegun rational approximations (eqs. 9.4.4/9.4.6),
    with the same constants and its fused polynomial steps."""
    ax = torch.abs(x)
    # |x| < 8 branch
    y = x * x
    p1 = x * _horner(y, (72362614232.0, -7895059235.0, 242396853.1, -2972611.439,
                         15704.48260, -30.16036606))
    q1 = _horner(y, (144725228442.0, 2300535178.0, 18583304.74, 99447.43394, 376.9991397, 1.0))
    small = p1 / q1
    # |x| >= 8 branch
    z = 8.0 / torch.clamp(ax, min=1e-30)
    y2 = z * z
    xx = ax - 2.356194491
    p2 = _horner(y2, (1.0, 0.183105e-2, -0.3516396496e-4, 0.2457520174e-5, -0.240337019e-6))
    q2 = _horner(y2, (0.04687499995, -0.2002690873e-3, 0.8449199096e-5, -0.88228987e-6,
                      0.105787412e-6))
    big = correct_sqrt(0.636619772 / torch.clamp(ax, min=1e-30)) * (
        _rounded(torch.cos, xx) * p2 - z * _rounded(torch.sin, xx) * q2) * torch.sign(x)
    return torch.where(ax < 8.0, small, big)


def _grid(pad_to: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centered coordinate grid of the padded kernel canvas (e.g. -10..10):
    ``xx`` varies along columns, ``yy`` along rows."""
    ax = torch.arange(pad_to, dtype=torch.float32, device=device) - (pad_to - 1) / 2.0
    yy, xx = torch.meshgrid(ax, ax, indexing="ij")
    return xx, yy


def _support_mask(pad_to: int, kernel_size: torch.Tensor) -> torch.Tensor:
    """(B, pad_to, pad_to): 1.0 inside each centered kernel_size x
    kernel_size support, else 0."""
    xx, yy = _grid(pad_to, kernel_size.device)
    half = ((kernel_size.float() - 1.0) / 2.0)[:, None, None]
    return ((torch.abs(xx) <= half + 0.5) & (torch.abs(yy) <= half + 0.5)).float()


def _col(v: torch.Tensor) -> torch.Tensor:
    return v.float()[:, None, None]


def _normalize(kernel: torch.Tensor) -> torch.Tensor:
    """kernel / its sum, the sum taken left to right over the flattened grid
    in float32, as XLA's CPU backend sums it: each kernel is rounded to bf16
    before the blur, and another order moves some weights across a rounding
    boundary."""
    flat = kernel.reshape(kernel.shape[0], -1)
    total = flat[:, 0]
    for i in range(1, flat.shape[1]):
        total = total + flat[:, i]
    return kernel / total[:, None, None]


def bivariate_kernel_grid(pad_to: int, kernel_size: torch.Tensor, sigma_x: torch.Tensor,
                          sigma_y: torch.Tensor, theta: torch.Tensor, beta: torch.Tensor,
                          form: torch.Tensor) -> torch.Tensor:
    """(B, pad_to, pad_to) bivariate blur kernels on the padded grid with
    masked support, one a sample of the (B,) parameters.

    form: 0 = Gaussian exp(-q/2), 1 = generalized exp(-0.5 q^beta),
    2 = plateau 1/(q^beta + 1), with q = v^T Sigma^-1 v, as the reference.
    """
    return _normalize(_bivariate(pad_to, kernel_size, sigma_x, sigma_y, theta, beta, form))


def _bivariate(pad_to, kernel_size, sigma_x, sigma_y, theta, beta, form) -> torch.Tensor:
    """``bivariate_kernel_grid`` before its normalization."""
    xx, yy = _grid(pad_to, kernel_size.device)
    theta = _col(theta)
    ct, st = _rounded(torch.cos, theta), _rounded(torch.sin, theta)
    sx, sy = _col(sigma_x), _col(sigma_y)
    inv_sx2 = 1.0 / (sx * sx)
    inv_sy2 = 1.0 / (sy * sy)
    a = ct * ct * inv_sx2 + st * st * inv_sy2
    b = ct * st * (inv_sx2 - inv_sy2)
    c = st * st * inv_sx2 + ct * ct * inv_sy2
    q = a * xx * xx + 2.0 * b * xx * yy + c * yy * yy

    form = form[:, None, None]
    beta = _col(beta)
    beta_eff = torch.where(form == 1, beta, torch.ones_like(beta))
    qb = _rounded(torch.pow, torch.clamp(q, min=1e-20), beta_eff)
    qb = torch.where(q <= 0.0, torch.zeros_like(qb), qb)
    exp_form = _rounded(torch.exp, -0.5 * qb)
    plateau_q = _rounded(torch.pow, torch.clamp(q, min=1e-20), beta)
    plateau_q = torch.where(q <= 0.0, torch.zeros_like(plateau_q), plateau_q)
    plateau_form = 1.0 / (plateau_q + 1.0)
    kernel = torch.where(form == 2, plateau_form, exp_form)
    return kernel * _support_mask(pad_to, kernel_size)


def sinc_kernel_grid(pad_to: int, kernel_size: torch.Tensor,
                     cutoff: torch.Tensor) -> torch.Tensor:
    """(B, pad_to, pad_to) 2-D sinc (ringing) filters on the padded grid, as
    the reference's ``generate_sinc_kernel``: cutoff * J1(cutoff * r) /
    (2 pi r), centre value cutoff^2 / (4 pi)."""
    return _normalize(_sinc(pad_to, kernel_size, cutoff))


def _sinc(pad_to: int, kernel_size: torch.Tensor, cutoff: torch.Tensor) -> torch.Tensor:
    """``sinc_kernel_grid`` before its normalization."""
    xx, yy = _grid(pad_to, kernel_size.device)
    cutoff = _col(cutoff)
    r = correct_sqrt(xx * xx + yy * yy)
    val = cutoff * bessel_j1(cutoff * r) / (2.0 * math.pi * torch.clamp(r, min=1e-20))
    centre = cutoff * cutoff * reciprocal(4.0 * math.pi)
    kernel = torch.where(r == 0.0, centre, val)
    return kernel * _support_mask(pad_to, kernel_size)


def identity_kernel(pad_to: int, device=None) -> torch.Tensor:
    """Dirac pulse: filtering with it is a no-op."""
    k = torch.zeros((pad_to, pad_to), dtype=torch.float32, device=device)
    k[pad_to // 2, pad_to // 2] = 1.0
    return k


@dataclasses.dataclass
class KernelDraws:
    """The random parameters of one kernel a sample, each a (B,) tensor.

    ``size`` (int) and ``omega_c`` (the sinc cutoff) and ``sinc`` (bool: the
    sinc kernel, else the mixed kernel or, for the final sinc, the identity)
    are always drawn.  The mixed kernel's ``kind`` (0..5: iso, aniso,
    generalized iso/aniso, plateau iso/aniso), ``sigma_x``, ``sigma_y``,
    ``theta`` and ``beta`` are None for the final sinc.  ``sigma_y`` and
    ``theta`` are the values in effect (sigma_x and 0 for the isotropic
    kinds), ``beta`` the one of the kind's family.
    """

    size: torch.Tensor
    omega_c: torch.Tensor
    sinc: torch.Tensor
    kind: Optional[torch.Tensor] = None
    sigma_x: Optional[torch.Tensor] = None
    sigma_y: Optional[torch.Tensor] = None
    theta: Optional[torch.Tensor] = None
    beta: Optional[torch.Tensor] = None


def _uniform(n: int, lo: float, hi: float, generator, device) -> torch.Tensor:
    return torch.rand(n, generator=generator, device=device) * (hi - lo) + lo


def _draw_beta(n: int, beta_range: Tuple[float, float], generator, device) -> torch.Tensor:
    """Coin-flip between U(lo, 1) and U(1, hi) (the reference's beta)."""
    coin = torch.rand(n, generator=generator, device=device) < 0.5
    lo = _uniform(n, beta_range[0], 1.0, generator, device)
    hi = _uniform(n, 1.0, beta_range[1], generator, device)
    return torch.where(coin, lo, hi)


def _pick(index: torch.Tensor, values) -> torch.Tensor:
    """``values[index]`` for a tensor of indices into a tuple of numbers,
    without copying the tuple to the device."""
    out = torch.zeros_like(index)
    for j, v in enumerate(values):
        out = torch.where(index == j, v, out)
    return out


def _draw_size(n: int, cfg: KernelSynthesisConfig, generator, device) -> torch.Tensor:
    pick = torch.randint(0, len(cfg.kernel_sizes), (n,), generator=generator, device=device)
    return _pick(pick, cfg.kernel_sizes)


def _draw_choice(n: int, probs, generator, device) -> torch.Tensor:
    """``n`` indices drawn by the probabilities ``probs`` (inverse CDF)."""
    u = torch.rand(n, generator=generator, device=device)
    edges = list(itertools.accumulate(p / sum(probs) for p in probs))[:-1]
    return sum((u >= edge).long() for edge in edges)


def _median_size(cfg: KernelSynthesisConfig) -> int:
    """int(np.median(kernel_sizes)), as the reference compares against."""
    s = sorted(cfg.kernel_sizes)
    n = len(s)
    return int(s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2.0)


def draw_stage_kernels(generator, n: int, cfg: KernelSynthesisConfig, stage: int,
                       device=None) -> KernelDraws:
    """The parameters of ``n`` first- (``stage`` 1) or second-order (2)
    degradation kernels: a sinc kernel with the stage's sinc probability,
    else a mixed kernel of a type drawn by the stage's type probabilities."""
    sinc_prob, type_probs, sigma_range, gen_beta, plat_beta = (
        (cfg.sinc_prob1, cfg.kernel_type_probs1, cfg.sigma_range1,
         cfg.generalized_beta_range1, cfg.plateau_beta_range1) if stage == 1 else
        (cfg.sinc_prob2, cfg.kernel_type_probs2, cfg.sigma_range2,
         cfg.generalized_beta_range2, cfg.plateau_beta_range2))
    size = _draw_size(n, cfg, generator, device)
    lo = torch.where(size < _median_size(cfg), math.pi / 3.0, math.pi / 5.0)
    omega_c = torch.rand(n, generator=generator, device=device) * (math.pi - lo) + lo
    sinc = torch.rand(n, generator=generator, device=device) < sinc_prob
    kind = _draw_choice(n, type_probs, generator, device)
    is_iso = kind % 2 == 0
    sigma_x = _uniform(n, *sigma_range, generator, device)
    sigma_y = torch.where(is_iso, sigma_x, _uniform(n, *sigma_range, generator, device))
    theta = torch.where(is_iso, torch.zeros_like(sigma_x),
                        _uniform(n, -math.pi, math.pi, generator, device))
    beta = torch.where(kind // 2 == 2, _draw_beta(n, plat_beta, generator, device),
                       _draw_beta(n, gen_beta, generator, device))
    return KernelDraws(size=size, omega_c=omega_c, sinc=sinc, kind=kind, sigma_x=sigma_x,
                       sigma_y=sigma_y, theta=theta, beta=beta)


def draw_final_sinc(generator, n: int, cfg: KernelSynthesisConfig, device=None) -> KernelDraws:
    """The parameters of ``n`` final kernels: a sinc kernel with cutoff
    U(pi/3, pi) with probability ``final_sinc_prob``, else the identity."""
    size = _draw_size(n, cfg, generator, device)
    omega_c = _uniform(n, math.pi / 3.0, math.pi, generator, device)
    sinc = torch.rand(n, generator=generator, device=device) < cfg.final_sinc_prob
    return KernelDraws(size=size, omega_c=omega_c, sinc=sinc)


def _unnormalized(draws: KernelDraws, pad_to: int) -> torch.Tensor:
    """The drawn kernels before normalization: the sinc kernel where drawn,
    else the mixed kernel, or the identity for the final sinc's draws."""
    sinc = _sinc(pad_to, draws.size, draws.omega_c)
    if draws.kind is None:
        other = identity_kernel(pad_to, sinc.device).expand_as(sinc)
    else:
        other = _bivariate(pad_to, draws.size, draws.sigma_x, draws.sigma_y, draws.theta,
                           draws.beta, draws.kind // 2)
    return torch.where(draws.sinc[:, None, None], sinc, other)


def stage_kernels(draws: KernelDraws, pad_to: int) -> torch.Tensor:
    """(B, pad_to, pad_to) kernels of ``draw_stage_kernels``' parameters."""
    return _normalize(_unnormalized(draws, pad_to))


def final_sinc_kernels(draws: KernelDraws, pad_to: int) -> torch.Tensor:
    """(B, pad_to, pad_to) kernels of ``draw_final_sinc``' parameters."""
    return _normalize(_unnormalized(draws, pad_to))


def kernels_of(draws: Tuple[KernelDraws, ...], pad_to: int) -> Tuple[torch.Tensor, ...]:
    """The kernels of several draws at once, normalized together: the
    normalizing sum is one elementwise add a grid cell, so one pass over
    all of them issues a third of the launches of three."""
    grids = [_unnormalized(d, pad_to) for d in draws]
    return torch.split(_normalize(torch.cat(grids)), [len(g) for g in grids])


def random_first_order_kernel(generator, cfg: KernelSynthesisConfig, n: int = 1,
                              device=None) -> torch.Tensor:
    return stage_kernels(draw_stage_kernels(generator, n, cfg, 1, device), cfg.pad_to)


def random_second_order_kernel(generator, cfg: KernelSynthesisConfig, n: int = 1,
                               device=None) -> torch.Tensor:
    return stage_kernels(draw_stage_kernels(generator, n, cfg, 2, device), cfg.pad_to)


def random_final_sinc_kernel(generator, cfg: KernelSynthesisConfig, n: int = 1,
                             device=None) -> torch.Tensor:
    return final_sinc_kernels(draw_final_sinc(generator, n, cfg, device), cfg.pad_to)
