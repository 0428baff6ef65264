"""The port's stage-2 models against the JAX package's on the CPU, float32:
the spectral-norm U-Net discriminator (its logits and its ``u``/``sigma``
after each of several calls, and the bilinear x2 at the borders), VGG19's
shallow taps, ``TrunkFeatures``, and the weight carriers (JAX trees, the
reference's ``spectral_norm`` grammar, torchvision's ``features.N``).

Bounds: logits and features within 1e-5 of their largest magnitude (float32
convolutions summed in other orders: 7.6e-7 measured on the logits); ``u``
within 1e-5 and ``sigma`` within 1e-5 relative (the power iteration's sums
in another order); the carriers are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from torch import nn as tnn
from torch.nn.utils import spectral_norm

from real_esrgan_tpu.models import Generator as JaxGenerator
from real_esrgan_tpu.models import TrunkFeatures as JaxTrunkFeatures
from real_esrgan_tpu.models import UNetDiscriminator as JaxDiscriminator
from real_esrgan_tpu.models import trunk_feature_params as jax_trunk_feature_params
from real_esrgan_tpu.models.convert import convert_discriminator as jax_convert_discriminator
from real_esrgan_tpu.models.convert import convert_vgg19 as jax_convert_vgg19
from real_esrgan_tpu.models.discriminator import _upsample_bilinear_2x as jax_upsample
from real_esrgan_tpu.models.vgg import VGG19Features as JaxVGG
from real_esrgan_tpu_torch.models.convert import (
    convert_discriminator, discriminator_state_from_jax, state_dict_from_jax_params,
    vgg_state_from_jax, vgg_state_from_torchvision,
)
from real_esrgan_tpu_torch.models.discriminator import (
    SN_LAYERS, UNetDiscriminator, upsample_bilinear_2x,
)
from real_esrgan_tpu_torch.models.rrdbnet import TrunkFeatures, trunk_feature_params
from real_esrgan_tpu_torch.models.vgg import TORCHVISION_INDEX, VGG19Features

REL = 1e-5


def _close(ours: torch.Tensor, ref, rel=REL):
    ref = torch.from_numpy(np.array(ref))
    scale = float(ref.abs().max())
    err = float((ours.detach() - ref).abs().max())
    assert err <= rel * scale, (err, scale)
    return err / scale


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def jax_d():
    d = JaxDiscriminator(channels=16)
    variables = d.init(jax.random.PRNGKey(4), jnp.zeros((1, 32, 32, 3)))
    return d, jax.device_get(variables["params"]), jax.device_get(variables["batch_stats"])


def _port_d(params, stats):
    sd, port_stats = discriminator_state_from_jax(params, stats)
    d = UNetDiscriminator(channels=16)
    d.load_state_dict(sd)
    return d, port_stats


def test_discriminator_logits_and_spectral_state_follow_jax_over_calls(jax_d):
    """Six calls with update_stats, each on new images: the logits of each and
    u and sigma of every layer after each hold to JAX's; a call without
    update_stats leaves the state as it was."""
    d, params, stats = jax_d
    port, port_stats = _port_d(params, stats)
    rng = np.random.default_rng(3)

    @jax.jit
    def fwd(stats, x):
        out, vs = d.apply({"params": params, "batch_stats": stats}, x, update_stats=True,
                          mutable=["batch_stats"])
        return out, vs["batch_stats"]

    worst = 0.0
    for _ in range(6):
        x = rng.random((2, 32, 48, 3)).astype(np.float32)
        ref, stats = fwd(stats, x)
        out, port_stats = port(torch.from_numpy(x), port_stats, update_stats=True)
        assert out.shape == (2, 32, 48, 1) and out.dtype == torch.float32
        worst = max(worst, _close(out, ref))
        _, ref_stats = discriminator_state_from_jax(params, jax.device_get(stats))
        for name, *_ in SN_LAYERS:
            assert float((port_stats[f"{name}.u"] - ref_stats[f"{name}.u"]).abs().max()) <= REL
            sigma, ref_sigma = float(port_stats[f"{name}.sigma"]), float(ref_stats[f"{name}.sigma"])
            assert abs(sigma - ref_sigma) <= REL * ref_sigma, name
    print(f"worst logit error {worst:.3g} of the largest")
    frozen, kept = port(torch.from_numpy(x), port_stats, update_stats=False)
    assert kept is port_stats
    assert _close(frozen, d.apply({"params": params, "batch_stats": stats}, x)) >= 0.0


def test_the_spectral_norm_is_flax_not_torch_power_iteration_on_its_own(jax_d):
    """u advances once a call: two calls from the same state equal one call
    twice chained, and differ from a single call."""
    _, params, stats = jax_d
    port, s0 = _port_d(params, stats)
    x = torch.from_numpy(np.random.default_rng(5).random((1, 32, 32, 3)).astype(np.float32))
    _, s1 = port(x, s0, update_stats=True)
    _, s2 = port(x, s1, update_stats=True)
    assert not torch.equal(s1["down3.u"], s2["down3.u"])
    assert torch.equal(port(x, s0, update_stats=True)[1]["down3.u"], s1["down3.u"])
    for name, *_ in SN_LAYERS:  # u stays a unit row vector
        assert s2[f"{name}.u"].shape[0] == 1
        assert abs(float(s2[f"{name}.u"].norm()) - 1.0) <= 1e-5


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 1, 4, 2), (1, 8, 8, 16)])
def test_bilinear_2x_matches_jax_resize_at_the_borders(shape):
    """F.interpolate's clamped edge tap against jax.image.resize's dropped and
    renormalised one: equal within float32 rounding everywhere, and the four
    output corners equal the input corners exactly in both."""
    x = np.random.default_rng(shape[1]).random(shape).astype(np.float32)
    ref = np.asarray(jax_upsample(jnp.asarray(x)))
    ours = upsample_bilinear_2x(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert ours.shape == ref.shape
    assert float((ours - torch.from_numpy(ref)).abs().max()) <= 1e-6
    for oy, iy in ((0, 0), (-1, -1)):
        for ox, ix in ((0, 0), (-1, -1)):
            assert torch.equal(ours[:, oy, ox], torch.from_numpy(x[:, iy, ix]))
            np.testing.assert_array_equal(ref[:, oy, ox], x[:, iy, ix])
    # the border rows: the vertical weight of the edge row is 1 in both
    row = F.interpolate(torch.from_numpy(x[:, :1]).permute(0, 3, 1, 2), size=(1, 2 * shape[2]),
                        mode="bilinear", align_corners=False).permute(0, 2, 3, 1)[:, 0]
    assert float((ours[:, 0] - row).abs().max()) <= 1e-7


@pytest.mark.parametrize("post_activation", [True, False])
def test_vgg_shallow_taps_match_jax(post_activation):
    nodes = ("conv1_2", "conv2_2", "conv3_1")
    jv = JaxVGG(nodes=nodes, post_activation=post_activation)
    params = jax.device_get(jv.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))["params"])
    assert set(params) == {"conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1"}
    port = VGG19Features(nodes, post_activation=post_activation)
    port.load_state_dict(vgg_state_from_jax(params))
    x = (np.random.default_rng(2).random((2, 48, 40, 3)).astype(np.float32) - 0.45) / 0.226
    ref = jv.apply({"params": params}, x)
    ours = port(torch.from_numpy(x))
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        _close(a, _nchw(b))


@pytest.mark.parametrize("scale,taps", [(4, (0, 1, 2)), (2, (1,))])
def test_trunk_features_match_jax(scale, taps):
    jg = JaxGenerator(num_rrdb=2, channels=16, growth=8, upscale_factor=scale)
    gparams = jax.device_get(jg.init(jax.random.PRNGKey(6), jnp.zeros((1, 16, 16, 3)))["params"])
    jt = JaxTrunkFeatures(taps=taps, upscale_factor=scale, channels=16, growth=8)
    x = np.random.default_rng(7).random((2, 32, 32, 3)).astype(np.float32)
    ref = jt.apply({"params": jax_trunk_feature_params(gparams, taps)}, x)

    sd = trunk_feature_params(state_dict_from_jax_params(gparams), taps)
    assert {k.split(".")[0] + "." + k.split(".")[1] for k in sd if k.startswith("trunk")} == \
        {f"trunk.{i}" for i in range(max(taps))}
    port = TrunkFeatures(taps, upscale_factor=scale, channels=16, growth=8)
    port.load_state_dict(sd)
    assert not TrunkFeatures.imagenet_input
    ours = port(torch.from_numpy(x))
    assert len(ours) == len(ref) == len(taps)
    for a, b in zip(ours, ref):
        _close(a, _nchw(b))
    with pytest.raises(KeyError, match="trunk"):
        trunk_feature_params({k: v for k, v in sd.items() if not k.startswith("trunk.0.")},
                             taps)


class TorchTwin(tnn.Module):
    """The reference's U-Net discriminator with torch's ``spectral_norm``,
    written for the test (as tests/test_spectral_norm_parity.py)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, c, 3, 1, 1)
        for name, cin, cout, k, s in SN_LAYERS:
            setattr(self, name, spectral_norm(tnn.Conv2d(cin * c, cout * c, k, s, 1, bias=False)))
        self.conv4 = tnn.Conv2d(c, 1, 3, 1, 1)

    def forward(self, x):
        def up(t):
            return F.interpolate(t, scale_factor=2, mode="bilinear", align_corners=False)

        act = lambda t: F.leaky_relu(t, 0.2)  # noqa: E731
        out1 = self.conv1(x)
        d1 = act(self.down1(out1))
        d2 = act(self.down2(d1))
        d3 = act(self.down3(d2))
        u1 = act(self.up1(up(d3))) + d2
        u2 = act(self.up2(up(u1))) + d1
        u3 = act(self.up3(up(u2))) + out1
        return self.conv4(act(self.conv3(act(self.conv2(u3)))))


GRAMMAR = {"down1": "down_block1.0", "down2": "down_block2.0", "down3": "down_block3.0",
           "up1": "up_block1.0", "up2": "up_block2.0", "up3": "up_block3.0",
           "conv2": "conv2.0", "conv3": "conv3.0", "conv1": "conv1", "conv4": "conv4"}


def _reference_state_dict(twin):
    sd = {}
    for attr, ref_name in GRAMMAR.items():
        for k, v in getattr(twin, attr).state_dict().items():
            sd[f"model.{ref_name}.{k}"] = v.detach().clone()
    return sd


def test_convert_discriminator_mirrors_jax_and_tracks_torch_spectral_norm():
    """The reference grammar -> the port equals the JAX converter's result
    carried across, with and without ``weight_u`` (then the seeded draw); and
    the port's D, run on the converted weights with three forwards a step,
    stays in lockstep with torch's ``spectral_norm`` over four steps (the
    JAX test's 5e-4 on the logits)."""
    torch.manual_seed(29)
    twin = TorchTwin(16).train()
    ref_sd = _reference_state_dict(twin)
    for drop_u in (False, True):
        sd = {k: v for k, v in ref_sd.items() if not (drop_u and k.endswith("weight_u"))}
        ours, stats = convert_discriminator(sd)
        jparams, jstats = jax_convert_discriminator(sd)
        ref, ref_stats = discriminator_state_from_jax(jparams, jstats)
        assert set(ours) == set(ref) and set(stats) == set(ref_stats)
        for k in ref:
            assert torch.equal(ours[k], ref[k]), k
        for k in ref_stats:
            assert torch.equal(stats[k], ref_stats[k]), k
    ours, stats = convert_discriminator(ref_sd)
    port = UNetDiscriminator(channels=16)
    port.load_state_dict(ours)
    rng = np.random.default_rng(29)
    worst = 0.0
    for _ in range(4):
        sr = rng.random((2, 32, 32, 3)).astype(np.float32)
        hr = rng.random((2, 32, 32, 3)).astype(np.float32)
        for x in (sr, hr, sr):
            with torch.no_grad():
                ref = twin(torch.from_numpy(x).permute(0, 3, 1, 2))
                out, stats = port(torch.from_numpy(x), stats, update_stats=True)
            worst = max(worst, float((out.permute(0, 3, 1, 2) - ref).abs().max()))
    assert worst < 5e-4, worst


def test_vgg_from_torchvision_mirrors_jax_and_loads_every_conv():
    g = torch.Generator().manual_seed(0)
    layout = [s for s in VGG19Features().layout if s != "M"]
    shapes, cin = {}, 3
    for name, cout in layout:
        shapes[name], cin = (cout, cin, 3, 3), cout
    tv = {}
    for idx, name in TORCHVISION_INDEX.items():
        tv[f"features.{idx}.weight"] = torch.randn(shapes[name], generator=g) * 0.05
        tv[f"features.{idx}.bias"] = torch.randn(shapes[name][0], generator=g) * 0.05
    tv["classifier.0.weight"] = torch.zeros(4, 4)  # ignored
    ours = vgg_state_from_torchvision(tv)
    ref = vgg_state_from_jax(jax_convert_vgg19(tv))
    assert set(ours) == set(ref) and len(ours) == 32
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k
    port = VGG19Features()
    port.load_state_dict(ours)
    assert torch.equal(port.conv5_4.weight, tv["features.34.weight"])


def test_jax_sums_d_bias_gradients_in_bf16(jax_d):
    """D's loss, BCE(D(hr), 1) + BCE(D(sr), 0), differentiated in bf16
    compute from the same f32 params in both frameworks.  The weight
    gradients agree within 5e-2 of the largest (3.3e-2 measured, conv2 and
    conv1): bf16 rounds at the same points and sums in other orders, and
    bf16 itself moves them by up to 5.5e-2 (the port's bf16 against its
    f32).  The bias gradients of conv1 and conv4 do not: JAX sums a bias's
    bf16 cotangent over the batch and pixels in bf16, PyTorch in float32,
    rounding once.  So the port's bf16 bias gradients are held to its own
    f32 ones, within 0.2 of their norm (4.4e-2 and 0.11 measured: bf16's
    own rounding of cotangents that nearly cancel), and JAX's are pinned as
    off from its f32 ones by more than 0.3 (0.65 and 1.0 measured; a
    JAX-side quirk, ROADMAP Queue C)."""
    d, params, stats = jax_d
    rng = np.random.default_rng(8)
    hr, sr = (rng.random((2, 32, 32, 3)).astype(np.float32) for _ in range(2))

    def jax_grads(dtype):
        module = JaxDiscriminator(channels=16, dtype=dtype)

        def loss(p):
            apply = lambda x: module.apply({"params": p, "batch_stats": stats}, x)  # noqa: E731
            return (jnp.mean(optax.sigmoid_binary_cross_entropy(apply(hr), 1.0))
                    + jnp.mean(optax.sigmoid_binary_cross_entropy(apply(sr), 0.0)))
        sd, _ = discriminator_state_from_jax(jax.device_get(jax.jit(jax.grad(loss))(params)),
                                             stats)
        return sd

    def port_grads(dtype):
        sd, port_stats = discriminator_state_from_jax(params, stats)
        port = UNetDiscriminator(channels=16, dtype=dtype)
        port.load_state_dict(sd)
        leaves = dict(port.named_parameters())
        out = [port(torch.from_numpy(x), port_stats)[0] for x in (hr, sr)]
        loss = torch.mean(-F.logsigmoid(out[0])) + torch.mean(-F.logsigmoid(-out[1]))
        return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    jb, jf = jax_grads(jnp.bfloat16), jax_grads(jnp.float32)
    pb, pf = port_grads(torch.bfloat16), port_grads(torch.float32)
    weights = [k for k in pb if k.endswith(".weight")]
    scale = max(float(jb[k].abs().max()) for k in weights)
    off = max(float((pb[k] - jb[k]).abs().max()) for k in weights) / scale
    own = max(float((pb[k] - pf[k]).abs().max()) for k in weights) / scale
    print(f"weight gradients: port bf16 off from JAX bf16 by {off:.3g} of the largest, from "
          f"port f32 by {own:.3g}")
    assert off <= 5e-2
    rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    for k in ("conv1.bias", "conv4.bias"):
        print(f"{k} gradient off from f32: port bf16 {rel(pb[k], pf[k]):.3g}, "
              f"JAX bf16 {rel(jb[k], jf[k]):.3g}")
        assert rel(pb[k], pf[k]) <= 0.2 and rel(jb[k], jf[k]) > 0.3, k
