"""Generator weight loading: the port of the loaders in
real_esrgan_tpu/train/checkpoint.py.

Two of the JAX package's three formats load here: compact ``.npz`` snapshots
(``/``-joined flax paths, f16 stored, loaded as f32) and reference
``.pth.tar`` checkpoints.  Orbax checkpoint directories need JAX to read;
``scripts/snapshot_weights.py`` turns one into an ``.npz`` snapshot.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from real_esrgan_tpu_torch.models.convert import state_dict_from_jax_params, strip_prefix


def _load_params_npz(path: str) -> Dict[str, Any]:
    """``.npz`` snapshot -> JAX-layout params tree of numpy arrays."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            arr = data[key]
            node[parts[-1]] = arr.astype(np.float32) \
                if arr.dtype == np.float16 else arr
    return tree


def _numpy_globals() -> list:
    """The numpy globals a numpy scalar and a numpy array unpickle through:
    the multiarray ``scalar`` and ``_reconstruct``, ``ndarray``, ``dtype`` and
    the numeric dtype classes, named from the installed numpy (whose
    multiarray moved from ``numpy.core`` to ``numpy._core``)."""
    core = getattr(np, "_core", None) or np.core
    codes = np.typecodes["AllInteger"] + np.typecodes["AllFloat"] + "?"
    dtype_classes = {type(np.dtype(code)) for code in codes}
    return [core.multiarray.scalar, core.multiarray._reconstruct, np.ndarray, np.dtype,
            *sorted(dtype_classes, key=lambda c: c.__name__)]


def load_generator_params(path: str, prefer_ema: bool = True) -> Dict[str, torch.Tensor]:
    """Generator weights as the port's OIHW state_dict, from either

    * a compact ``.npz`` snapshot (``scripts/snapshot_weights.py``), or
    * a reference ``.pth.tar``: ``ema_state_dict`` when present and
      preferred, else ``state_dict``, with the ``model.`` prefix stripped.

    A ``.pth.tar`` is unpickled with ``weights_only=True``: tensors, plain
    containers and numbers, and numpy scalars and arrays (the reference
    saves ``best_niqe`` as a numpy scalar beside the weights; an export may
    hold numpy arrays).  Any other class raises ``UnpicklingError``.
    """
    if path.endswith(".npz"):
        return state_dict_from_jax_params(_load_params_npz(path))
    if path.endswith((".pth.tar", ".pth", ".tar")):
        with torch.serialization.safe_globals(_numpy_globals()):
            ckpt = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(ckpt, dict) and ("state_dict" in ckpt or "ema_state_dict" in ckpt):
            key = "ema_state_dict" if (prefer_ema and "ema_state_dict" in ckpt) \
                else "state_dict"
            ckpt = ckpt[key]
        return {k: torch.as_tensor(v, dtype=torch.float32)
                for k, v in strip_prefix(ckpt).items()}
    if os.path.isdir(path):
        raise ValueError(
            f"{path} looks like an Orbax checkpoint directory, which needs JAX to "
            "read; convert it first with `python scripts/snapshot_weights.py "
            f"--checkpoint {path} --output weights.npz` and load the .npz")
    raise ValueError(f"unrecognized generator weights file: {path} "
                     "(expected .npz or .pth.tar)")
