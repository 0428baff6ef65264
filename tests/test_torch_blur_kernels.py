"""Port parity of real_esrgan_tpu_torch/ops/blur_kernels.py against
real_esrgan_tpu/ops/blur_kernels.py on the CPU.

The port splits each sampler into a draw of its parameters and the grid
functions.  ``jax_kernel_draws`` replays the JAX samplers' key splits with
the JAX package's own random functions, so the port's grids can be held to
``random_*_kernel`` on the same key (<= 1e-6), and the port's own draws to
the JAX draws' distributions on 4096 samples (KS for continuous parameters,
frequencies within 4 sigma for discrete ones).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import scipy.stats
import torch

from real_esrgan_tpu.configuration import KernelSynthesisConfig as JaxKernelConfig
from real_esrgan_tpu.ops import blur_kernels as jbk
from real_esrgan_tpu_torch.configuration import KernelSynthesisConfig
from real_esrgan_tpu_torch.ops import blur_kernels as tbk

KCFG, JKCFG = KernelSynthesisConfig(), JaxKernelConfig()
N_DRAWS = 4096
GRID_TOL = 1e-6


def _stage_draw(key, cfg, stage):
    """One first/second-order kernel's parameters, as ``_random_stage_kernel``
    and ``random_mixed_kernel`` draw them (blur_kernels.py:135-192)."""
    sinc_prob, type_probs, sigma_range, gen_beta, plat_beta = (
        (cfg.sinc_prob1, cfg.kernel_type_probs1, cfg.sigma_range1,
         cfg.generalized_beta_range1, cfg.plateau_beta_range1) if stage == 1 else
        (cfg.sinc_prob2, cfg.kernel_type_probs2, cfg.sigma_range2,
         cfg.generalized_beta_range2, cfg.plateau_beta_range2))
    k_size, k_coin, k_omega, k_mixed = jax.random.split(key, 4)
    sizes = jnp.asarray(cfg.kernel_sizes, jnp.int32)
    size = sizes[jax.random.randint(k_size, (), 0, len(cfg.kernel_sizes))]
    s = sorted(cfg.kernel_sizes)
    n = len(s)
    median = int(s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2.0)
    lo = jnp.where(size < median, math.pi / 3.0, math.pi / 5.0)
    omega = jax.random.uniform(k_omega, minval=0.0, maxval=1.0) * (math.pi - lo) + lo
    k_type, k_sx, k_sy, k_rot, k_bg, k_bp = jax.random.split(k_mixed, 6)
    kind = jax.random.choice(k_type, 6, p=jnp.asarray(type_probs, jnp.float32))
    is_iso = (kind % 2) == 0
    sigma_x = jax.random.uniform(k_sx, minval=sigma_range[0], maxval=sigma_range[1])
    sigma_y = jnp.where(is_iso, sigma_x,
                        jax.random.uniform(k_sy, minval=sigma_range[0], maxval=sigma_range[1]))
    theta = jnp.where(is_iso, 0.0, jax.random.uniform(k_rot, minval=-math.pi, maxval=math.pi))
    beta = jnp.where(kind // 2 == 2, jbk._sample_beta(k_bp, plat_beta),
                     jbk._sample_beta(k_bg, gen_beta))
    return dict(size=size, omega_c=omega, sinc=jax.random.uniform(k_coin) < sinc_prob,
                kind=kind, sigma_x=sigma_x, sigma_y=sigma_y, theta=theta, beta=beta)


def _final_draw(key, cfg):
    """The final kernel's parameters, as ``random_final_sinc_kernel``."""
    k_coin, k_size, k_omega = jax.random.split(key, 3)
    sizes = jnp.asarray(cfg.kernel_sizes, jnp.int32)
    size = sizes[jax.random.randint(k_size, (), 0, len(cfg.kernel_sizes))]
    omega = jax.random.uniform(k_omega, minval=math.pi / 3.0, maxval=math.pi)
    return dict(size=size, omega_c=omega, sinc=jax.random.uniform(k_coin) < cfg.final_sinc_prob)


def jax_kernel_draws(keys, cfg, stage):
    """{field: array} of the JAX draws of one kernel per key; ``stage`` 1,
    2 or "final"."""
    fn = (lambda k: _final_draw(k, cfg)) if stage == "final" else (
        lambda k: _stage_draw(k, cfg, stage))
    return jax.vmap(fn)(keys)


def kernel_draws(arrays) -> tbk.KernelDraws:
    return tbk.KernelDraws(**{k: torch.from_numpy(np.array(v)) for k, v in arrays.items()})


@jax.jit
def _jax_kernels(keys):
    return (jax.vmap(lambda k: jbk.random_first_order_kernel(k, JKCFG))(keys),
            jax.vmap(lambda k: jbk.random_second_order_kernel(k, JKCFG))(keys),
            jax.vmap(lambda k: jbk.random_final_sinc_kernel(k, JKCFG))(keys))


@jax.jit
def _jax_draws(keys):
    return (jax_kernel_draws(keys, JKCFG, 1), jax_kernel_draws(keys, JKCFG, 2),
            jax_kernel_draws(keys, JKCFG, "final"))


def test_bessel_j1_matches_jax_and_scipy():
    """float32 against JAX's float32 (the grids' bound), and against scipy
    within the JAX package's own bound for its approximation (4e-6)."""
    x = np.concatenate([np.linspace(-40, 40, 4001), [0.0, 7.999, 8.0, 8.001]]).astype(np.float32)
    ours = tbk.bessel_j1(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.jit(jbk.bessel_j1)(x))
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=GRID_TOL, rtol=0)
    np.testing.assert_allclose(ours, scipy.special.j1(x.astype(np.float64)), atol=4e-6, rtol=0)


def test_grid_and_support_mask_match_jax():
    xx, yy = tbk._grid(21)
    jxx, jyy = jbk._grid(21)
    np.testing.assert_array_equal(xx.numpy(), np.asarray(jxx))
    np.testing.assert_array_equal(yy.numpy(), np.asarray(jyy))
    sizes = np.array(KCFG.kernel_sizes, np.int32)
    ours = tbk._support_mask(21, torch.from_numpy(sizes)).numpy()
    ref = np.stack([np.asarray(jbk._support_mask(21, jnp.int32(s))) for s in sizes])
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("form", [0, 1, 2], ids=["gaussian", "generalized", "plateau"])
def test_bivariate_grid_matches_jax(form):
    rng = np.random.default_rng(form)
    n = 64
    size = rng.choice(KCFG.kernel_sizes, n).astype(np.int32)
    sx, sy = (rng.uniform(0.2, 3.0, n).astype(np.float32) for _ in range(2))
    theta = rng.uniform(-math.pi, math.pi, n).astype(np.float32)
    beta = rng.uniform(0.5, 4.0, n).astype(np.float32)
    forms = np.full(n, form, np.int32)
    ref = np.asarray(jax.jit(jax.vmap(lambda *a: jbk.bivariate_kernel_grid(21, *a)))(
        size, sx, sy, theta, beta, forms))
    ours = tbk.bivariate_kernel_grid(21, *(torch.from_numpy(a) for a in (
        size, sx, sy, theta, beta, forms))).numpy()
    np.testing.assert_allclose(ours, ref, atol=GRID_TOL, rtol=0)
    np.testing.assert_allclose(ours.sum(axis=(1, 2)), 1.0, atol=1e-5)


def test_sinc_and_identity_grids_match_jax():
    rng = np.random.default_rng(7)
    size = rng.choice(KCFG.kernel_sizes, 64).astype(np.int32)
    cutoff = rng.uniform(math.pi / 5, math.pi, 64).astype(np.float32)
    ref = np.asarray(jax.jit(jax.vmap(lambda s, c: jbk.sinc_kernel_grid(21, s, c)))(size, cutoff))
    ours = tbk.sinc_kernel_grid(21, torch.from_numpy(size), torch.from_numpy(cutoff)).numpy()
    np.testing.assert_allclose(ours, ref, atol=GRID_TOL, rtol=0)
    np.testing.assert_array_equal(tbk.identity_kernel(21).numpy(),
                                  np.asarray(jbk.identity_kernel(21)))


def test_kernels_from_jax_draws_match_the_jax_samplers():
    """The grids of the JAX package's own draws equal its samplers' kernels
    on the same keys, for every kind of kernel the 256 keys draw."""
    keys = jax.random.split(jax.random.PRNGKey(11), 256)
    k1, k2, final = (np.asarray(k) for k in _jax_kernels(keys))
    d1, d2, df = (kernel_draws(d) for d in _jax_draws(keys))
    assert set(d1.kind.tolist()) == set(range(6)) and d1.sinc.any() and not d1.sinc.all()
    assert df.sinc.any() and not df.sinc.all()
    np.testing.assert_allclose(tbk.stage_kernels(d1, 21).numpy(), k1, atol=GRID_TOL, rtol=0)
    np.testing.assert_allclose(tbk.stage_kernels(d2, 21).numpy(), k2, atol=GRID_TOL, rtol=0)
    np.testing.assert_allclose(tbk.final_sinc_kernels(df, 21).numpy(), final, atol=GRID_TOL, rtol=0)


def _frequencies_within_4_sigma(ours: np.ndarray, ref: np.ndarray, values) -> None:
    n = len(ours)
    for v in values:
        p = (ref == v).mean()
        sigma = math.sqrt(max(p * (1 - p), 1.0 / n) * 2.0 / n)
        assert abs((ours == v).mean() - p) <= 4 * sigma, (v, (ours == v).mean(), p)


def _ks(ours: np.ndarray, ref: np.ndarray) -> None:
    assert scipy.stats.ks_2samp(ours, ref).pvalue > 1e-3


@pytest.mark.parametrize("stage", [1, 2, "final"])
def test_draws_follow_the_jax_distributions(stage):
    keys = jax.random.split(jax.random.PRNGKey(3), N_DRAWS)
    ref = {k: np.asarray(v) for k, v in jax.jit(
        lambda ks: jax_kernel_draws(ks, JKCFG, stage))(keys).items()}
    gen = torch.Generator().manual_seed(3)
    ours = (tbk.draw_final_sinc(gen, N_DRAWS, KCFG) if stage == "final"
            else tbk.draw_stage_kernels(gen, N_DRAWS, KCFG, stage))
    _frequencies_within_4_sigma(ours.size.numpy(), ref["size"], KCFG.kernel_sizes)
    _frequencies_within_4_sigma(ours.sinc.numpy(), ref["sinc"], (False, True))
    _ks(ours.omega_c.numpy(), ref["omega_c"])
    if stage == "final":
        assert ours.kind is None
        return
    _frequencies_within_4_sigma(ours.kind.numpy(), ref["kind"], range(6))
    for name in ("sigma_x", "sigma_y", "theta", "beta"):
        _ks(getattr(ours, name).numpy(), ref[name])
    # per kind: isotropic kinds have sigma_y == sigma_x and theta == 0; beta
    # comes from the plateau range for kinds 4-5, the generalized one else
    kind = ours.kind.numpy()
    iso = kind % 2 == 0
    assert (ours.sigma_y.numpy()[iso] == ours.sigma_x.numpy()[iso]).all()
    assert (ours.theta.numpy()[iso] == 0).all()
    for kinds in ((0, 1, 2, 3), (4, 5)):
        sel, jsel = np.isin(kind, kinds), np.isin(ref["kind"], kinds)
        _ks(ours.beta.numpy()[sel], ref["beta"][jsel])


def test_random_kernels_are_normalized_and_centered():
    gen = torch.Generator().manual_seed(0)
    for fn in (tbk.random_first_order_kernel, tbk.random_second_order_kernel,
               tbk.random_final_sinc_kernel):
        k = fn(gen, KCFG, n=32).numpy()
        assert k.shape == (32, 21, 21) and np.isfinite(k).all()
        np.testing.assert_allclose(k.sum(axis=(1, 2)), 1.0, atol=1e-5)
        assert (np.abs(k - k[:, ::-1, ::-1]) < 1e-6).all()      # point-symmetric
