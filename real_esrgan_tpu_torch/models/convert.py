"""Weight conversion: the port's copy of real_esrgan_tpu/models/convert.py,
plus the functions that carry JAX weights across.

The JAX package keeps params as a flax tree of HWIO kernels
(``trunk_{i}/rdb{j}/conv{k}/kernel``); the port, like the reference, keeps an
OIHW state_dict (``trunk.{i}.rdb{j}.conv{k}.weight``).  Conversion is numpy.

* the generator: reference state_dict <-> JAX tree, JAX tree -> the port;
* the discriminator: the reference's ``spectral_norm`` grammar and the JAX
  params and ``batch_stats`` -> the port's state_dict and spectral state;
* VGG19: a torchvision ``features.N`` state_dict and the JAX tree -> the port.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


from real_esrgan_tpu_torch.models.discriminator import SN_LAYERS
from real_esrgan_tpu_torch.models.vgg import TORCHVISION_INDEX


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()


def _oihw_to_hwio(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def strip_prefix(state_dict: Mapping[str, Any], prefix: str = "model.") -> Dict[str, Any]:
    out = {}
    for k, v in state_dict.items():
        out[k[len(prefix):] if k.startswith(prefix) else k] = v
    return out


_GEN_SEQUENTIAL = {"upsampling1", "upsampling2", "conv3"}


def convert_generator(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Reference Generator state_dict -> JAX params tree (numpy, HWIO).

    Key grammar:
        conv1.{weight,bias}
        trunk.{i}.rdb{j}.conv{k}.{weight,bias}
        conv2.{weight,bias}
        upsampling{1,2}.0.{weight,bias}   (Sequential)
        conv3.0.{weight,bias}             (Sequential)
        conv4.{weight,bias}
    """
    sd = strip_prefix(dict(state_dict))
    params: Dict[str, Any] = {}

    trunk_re = re.compile(r"^trunk\.(\d+)\.(rdb\d)\.(conv\d)\.(weight|bias)$")
    for key, value in sd.items():
        v = _np(value)
        m = trunk_re.match(key)
        if m:
            i, rdb, conv, leaf = m.groups()
            block = (params.setdefault(f"trunk_{i}", {})
                     .setdefault(rdb, {}).setdefault(conv, {}))
            block["kernel" if leaf == "weight" else "bias"] = (
                _oihw_to_hwio(v) if leaf == "weight" else v)
            continue
        parts = key.split(".")
        if parts[0] in _GEN_SEQUENTIAL and parts[1] == "0":
            name, leaf = parts[0], parts[2]
        elif len(parts) == 2:
            name, leaf = parts
        else:
            raise KeyError(f"Unrecognized generator key: {key}")
        params.setdefault(name, {})["kernel" if leaf == "weight" else "bias"] = (
            _oihw_to_hwio(v) if leaf == "weight" else v)

    return params


def export_generator(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """JAX params tree -> reference-format state_dict (numpy, OIHW)."""
    sd: Dict[str, np.ndarray] = {}

    def kernel_out(w):
        return np.transpose(np.asarray(w), (3, 2, 0, 1))

    for name, node in params.items():
        if name.startswith("trunk_"):
            i = name.split("_")[1]
            for rdb, convs in node.items():
                for conv, leaves in convs.items():
                    sd[f"trunk.{i}.{rdb}.{conv}.weight"] = kernel_out(leaves["kernel"])
                    sd[f"trunk.{i}.{rdb}.{conv}.bias"] = np.asarray(leaves["bias"])
        else:
            torch_name = f"{name}.0" if name in _GEN_SEQUENTIAL else name
            sd[f"{torch_name}.weight"] = kernel_out(node["kernel"])
            sd[f"{torch_name}.bias"] = np.asarray(node["bias"])
    return sd


def state_dict_from_jax_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX generator param tree (numpy HWIO arrays) -> the port's float32 OIHW
    state_dict, ready for ``Generator.load_state_dict``."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in export_generator(tree).items()}


def _tensor(v) -> torch.Tensor:
    return torch.from_numpy(np.array(_np(v), dtype=np.float32, order="C"))


def _hwio_to_oihw(w) -> torch.Tensor:
    return _tensor(np.transpose(_np(w), (3, 2, 0, 1)))


_DISC_MAP = {
    "down_block1.0": "down1", "down_block2.0": "down2", "down_block3.0": "down3",
    "up_block1.0": "up1", "up_block2.0": "up2", "up_block3.0": "up3",
    "conv2.0": "conv2", "conv3.0": "conv3",
}
# flax numbers the SpectralNorm wrappers in call order
_DISC_SN_INDEX = {name: i for i, (name, *_) in enumerate(SN_LAYERS)}


def convert_discriminator(state_dict: Mapping[str, Any]):
    """Reference discriminator state_dict (``torch.nn.utils.spectral_norm``
    grammar: ``weight_orig``, ``weight_u``) -> (the port's state_dict, its
    spectral state), as the JAX ``convert_discriminator`` maps it: ``u``
    from ``weight_u``, or where that is absent a normal draw of
    ``np.random.RandomState(0)``, and ``sigma`` 1."""
    sd = strip_prefix(dict(state_dict))
    params, stats = {}, {}
    for plain in ("conv1", "conv4"):
        params[f"{plain}.weight"] = _tensor(sd[f"{plain}.weight"])
        params[f"{plain}.bias"] = _tensor(sd[f"{plain}.bias"])
    for torch_name, name in _DISC_MAP.items():
        w = _np(sd[f"{torch_name}.weight_orig"])
        params[f"{name}.weight"] = _tensor(w)
        u_key = f"{torch_name}.weight_u"
        u = _np(sd[u_key]).reshape(1, -1) if u_key in sd else \
            np.random.RandomState(0).normal(size=(1, w.shape[0])).astype(np.float32)
        stats[f"{name}.u"] = _tensor(u)
        stats[f"{name}.sigma"] = torch.ones(())
    return params, stats


def discriminator_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``UNetDiscriminator`` params, or a tree of their shape such as
    Adam's moments (numpy) -> the port's state_dict."""
    sd = {}
    for name, node in params.items():
        sd[f"{name}.weight"] = _hwio_to_oihw(node["kernel"])
        if "bias" in node:
            sd[f"{name}.bias"] = _tensor(node["bias"])
    return sd


def discriminator_state_from_jax(params: Mapping[str, Any], batch_stats: Mapping[str, Any]):
    """JAX ``UNetDiscriminator`` params and ``batch_stats`` (numpy) -> (the
    port's state_dict, its spectral state)."""
    sd = discriminator_params_from_jax(params)
    stats = {}
    for name, i in _DISC_SN_INDEX.items():
        entry = batch_stats[f"SpectralNorm_{i}"]
        stats[f"{name}.u"] = _tensor(entry[f"{name}/kernel/u"])
        stats[f"{name}.sigma"] = _tensor(entry[f"{name}/kernel/sigma"])
    return sd, stats


def vgg_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``VGG19Features`` params (numpy) -> the port's state_dict."""
    sd = {}
    for name, node in params.items():
        sd[f"{name}.weight"] = _hwio_to_oihw(node["kernel"])
        sd[f"{name}.bias"] = _tensor(node["bias"])
    return sd


def vgg_state_from_torchvision(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A torchvision ``vgg19`` state_dict (``features.N.weight``, OIHW
    already) -> the port's ``VGG19Features`` state_dict, every conv it
    holds."""
    sd = {}
    for idx, name in TORCHVISION_INDEX.items():
        key = f"features.{idx}.weight"
        if key in state_dict:
            sd[f"{name}.weight"] = _tensor(state_dict[key])
            sd[f"{name}.bias"] = _tensor(state_dict[f"features.{idx}.bias"])
    return sd
