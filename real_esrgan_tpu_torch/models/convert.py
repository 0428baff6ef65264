"""Generator weight conversion: the port's copy of
real_esrgan_tpu/models/convert.py (generator part), plus the function that
carries JAX weights across.

The JAX package keeps params as a flax tree of HWIO kernels
(``trunk_{i}/rdb{j}/conv{k}/kernel``); the port, like the reference, keeps an
OIHW state_dict (``trunk.{i}.rdb{j}.conv{k}.weight``).  Conversion is numpy.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


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
