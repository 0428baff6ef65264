"""Checkpoints and generator weight loading: the port of
real_esrgan_tpu/train/checkpoint.py.

The trainer's epoch checkpoint is a directory (``g_epoch_N``, and its
``g_best``/``g_last`` copies) holding one ``torch.save`` file,
``CHECKPOINT_FILE``, with the JAX trainer's payload: ``epoch``,
``best_niqe``, ``step``, ``params``, ``ema_params``, ``opt_state`` (the
update ``count`` and the moments ``mu``/``nu``) and ``guard``, as tensors on
the CPU, plain dicts and numbers, so it loads with ``weights_only=True``.
Saves are synchronous.

``load_checkpoint`` also reads the JAX trainers' Orbax directories
(``utils/orbax_read.py``, no JAX needed) and returns their payload in the
port's layout: OIHW state_dicts for the generator, the discriminator and
Adam's moments, the spectral state as ``batch_stats``, and optax's
``opt_state`` as ``{"count", "mu", "nu"}``.  So both trainers resume a
TPU-trained run, and every weights flag takes its directories.  The port
writes no Orbax.

Generator weights load from compact ``.npz`` snapshots (``/``-joined flax
paths, f16 stored, loaded as f32), reference ``.pth.tar`` checkpoints, and
checkpoint directories of either kind.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from real_esrgan_tpu_torch.models.convert import (
    convert_generator, discriminator_params_from_jax, discriminator_state_from_jax,
    state_dict_from_jax_params, strip_prefix,
)
from real_esrgan_tpu_torch.utils.orbax_read import is_orbax_dir, read_pytree


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


CHECKPOINT_FILE = "train_state.pt"


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    """Write ``payload`` (tensors are moved to the CPU) as the checkpoint
    directory ``path``, replacing one that is there.  The file is written
    beside its final name and renamed into place."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    target = os.path.join(path, CHECKPOINT_FILE)
    torch.save(_to_cpu(payload), target + ".tmp")
    os.replace(target + ".tmp", target)


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    return obj


def write_checkpoints(items: Sequence[tuple]) -> None:
    """Synchronous saves: each ``(path, payload, copies)`` is written to
    ``path``, then copied to every directory of ``copies``."""
    for path, payload, copies in items:
        save_checkpoint(path, payload)
        for dst in copies:
            copy_checkpoint(path, dst)


def _snapshot(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: _snapshot(v) for k, v in obj.items()}
    return obj


class AsyncSaver:
    """Checkpoint writes off the training loop.

    ``save_many`` clones every tensor of the payloads on the caller's stream
    (device copies, cheap beside the files) before it returns, so a later
    update of the live state, in place or not, cannot reach a save in
    flight.  A thread then moves the clones to the CPU and runs
    ``write_checkpoints``.  At most one save is in flight: a new save first
    joins the last one, so checkpoints land in order.  A failure of the
    thread is raised by the next ``save``, ``save_many`` or ``wait``; call
    ``wait`` before the process exits, so the last checkpoint is durable."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, payload: Dict[str, Any], copies: Sequence[str] = ()) -> None:
        self.save_many([(path, payload, copies)])

    def save_many(self, items: Sequence[tuple]) -> None:
        """``items``: ``(path, payload, copies)`` triples written as one unit
        (the stage-2 trainer's ``g_`` and ``d_`` checkpoints)."""
        self.wait()
        snapped = [(path, _snapshot(payload), tuple(copies)) for path, payload, copies in items]
        ready = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            ready = torch.cuda.Event()
            ready.record()

        def work() -> None:
            try:
                if ready is not None:
                    ready.synchronize()
                write_checkpoints(snapped)
            except BaseException as exc:  # raised again by the next save or wait
                self._error = exc

        self._thread = threading.Thread(target=work, name="checkpoint-save", daemon=False)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from error


def save_params_npz(path: str, state_dict: Dict[str, torch.Tensor], dtype=np.float16) -> None:
    """Generator weights (the port's OIHW state_dict) as one compressed
    ``.npz``: the JAX params tree of ``convert_generator`` under
    ``/``-joined keys, in ``dtype`` (f16 by default, about 2 bytes a
    parameter), the format the JAX ``load_generator_params`` reads."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = np.asarray(v, dtype)

    walk(convert_generator({k: v.detach().cpu().float() for k, v in state_dict.items()}), ())
    np.savez_compressed(path, **flat)


def _mismatch(template, restored, where: str) -> Optional[str]:
    if isinstance(template, dict):
        if not isinstance(restored, dict):
            return f"{where} is {type(restored).__name__} in the checkpoint"
        if set(template) != set(restored):
            extra, missing = sorted(set(restored) - set(template)), \
                sorted(set(template) - set(restored))
            return f"{where}: {len(missing)} names missing ({missing[:3]}), " \
                f"{len(extra)} extra ({extra[:3]})"
        for k in template:
            found = _mismatch(template[k], restored[k], f"{where}/{k}")
            if found:
                return found
        return None
    if not isinstance(restored, torch.Tensor):
        return f"{where} is {type(restored).__name__} in the checkpoint"
    if tuple(restored.shape) != tuple(template.shape):
        return f"{where}: shape {tuple(restored.shape)} in the checkpoint, " \
            f"{tuple(template.shape)} live"
    return None


def _restore(template, restored):
    if isinstance(template, dict):
        return {k: _restore(v, restored[k]) for k, v in template.items()}
    return restored.to(device=template.device, dtype=template.dtype)


def restore_like(template: Any, restored: Any, what: str = "state",
                 on_mismatch: str = "raise") -> Any:
    """``restored`` (nested dicts of tensors, as a checkpoint holds them) in
    ``template``'s structure, names' order, devices and dtypes.

    Where the names or shapes differ (the model or optimizer changed between
    runs) it raises, since training from a fresh state while claiming to
    have resumed would be worse; with ``on_mismatch="template"`` it warns
    and returns ``template``."""
    mismatch = _mismatch(template, restored, what)
    if mismatch is None:
        return _restore(template, restored)
    msg = f"Checkpoint {what} does not match the live structure ({mismatch})."
    if on_mismatch == "raise":
        raise ValueError(msg)
    print(f"WARNING: {msg} Keeping freshly-initialized {what}.")
    return template


def is_checkpoint_dir(path: str) -> bool:
    return os.path.isfile(os.path.join(path, CHECKPOINT_FILE))


def _adam_state(opt_state, to_port) -> Dict[str, Any]:
    """optax's state of ``chain(clip_by_global_norm, chain(scale_by_adam,
    scale_by_schedule))`` (or the chain without the clip), as Orbax lays it
    out: ``[None, [{count, mu, nu}, {count}]]`` -> the port's ``{"count",
    "mu", "nu"}``, the moments through ``to_port``."""
    adam, counts = [], []

    def walk(node):
        if isinstance(node, list):
            for item in node:
                walk(item)
        elif isinstance(node, dict):
            if set(node) == {"count", "mu", "nu"}:
                adam.append(node)
            elif set(node) == {"count"}:
                counts.append(int(node["count"]))
            else:
                raise ValueError(f"opt_state holds an optax state with fields {sorted(node)}, "
                                 "not Adam's or a schedule's")
        elif node is not None:
            raise ValueError(f"opt_state holds a {type(node).__name__}")

    walk(opt_state)
    if len(adam) != 1:
        raise ValueError(f"opt_state holds {len(adam)} Adam states, expected one")
    count = int(adam[0]["count"])
    if any(c != count for c in counts):
        raise ValueError(f"opt_state: schedule count {counts} differs from Adam's count {count}")
    return {"count": torch.tensor(count, dtype=torch.int32),
            "mu": to_port(adam[0]["mu"]), "nu": to_port(adam[0]["nu"])}


def load_orbax_checkpoint(path: str) -> Dict[str, Any]:
    """The JAX trainer's Orbax checkpoint directory ``path`` as the port's
    payload (see the module's docstring); a ``d_`` checkpoint is told by its
    ``batch_stats``.  A tree without ``params`` is taken as a bare generator
    params tree."""
    tree = read_pytree(path)
    if "params" not in tree:
        return {"params": state_dict_from_jax_params(tree)}
    out: Dict[str, Any] = {}
    if "batch_stats" in tree:
        out["params"], out["batch_stats"] = discriminator_state_from_jax(
            tree["params"], tree["batch_stats"])
        to_port = discriminator_params_from_jax
    else:
        out["params"] = state_dict_from_jax_params(tree["params"])
        if "ema_params" in tree:
            ema = tree["ema_params"]
            out["ema_params"] = None if ema is None else state_dict_from_jax_params(ema)
        to_port = state_dict_from_jax_params
    if tree.get("opt_state") is not None:
        out["opt_state"] = _adam_state(tree["opt_state"], to_port)
    if tree.get("guard") is not None:
        out["guard"] = {k: torch.as_tensor(np.asarray(v)) for k, v in tree["guard"].items()}
    for key, cast in (("step", int), ("epoch", int), ("best_niqe", float)):
        if tree.get(key) is not None:
            out[key] = cast(tree[key])
    return out


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The payload of the checkpoint directory ``path``, on the CPU: the
    port's own, or the JAX trainer's Orbax directory in the port's layout."""
    if is_checkpoint_dir(path):
        return torch.load(os.path.join(path, CHECKPOINT_FILE), map_location="cpu",
                          weights_only=True)
    if is_orbax_dir(path):
        return load_orbax_checkpoint(path)
    raise ValueError(
        f"{path} is neither a checkpoint directory of the port (no {CHECKPOINT_FILE}) nor an "
        "Orbax checkpoint directory (no _METADATA, and no _CHECKPOINT_METADATA beside "
        "manifest.ocdbt)")


def copy_checkpoint(src: str, dst: str) -> None:
    """Crash-safe copy: build next to ``dst``, then swap by renames, so a
    complete tree is at ``dst`` at every moment (at worst a stale ``.old``
    or ``.tmp`` sibling, which the next copy clears)."""
    src, dst = os.path.abspath(src), os.path.abspath(dst)
    tmp, old = dst + ".tmp", dst + ".old"
    for stale in (tmp, old):
        if os.path.exists(stale):
            shutil.rmtree(stale)
    shutil.copytree(src, tmp)
    if os.path.exists(dst):
        os.rename(dst, old)
    os.rename(tmp, dst)
    if os.path.exists(old):
        shutil.rmtree(old)


def find_latest_checkpoint(samples_dir: str, prefix: str = "g_epoch_") -> str:
    """The newest ``<prefix>N`` checkpoint directory under ``samples_dir``
    ('' if none), the port's or the JAX trainer's: the trainers' ``--resume
    auto``, which so continues a TPU run's samples folder."""
    if not os.path.isdir(samples_dir):
        return ""
    best, best_n = "", -1
    for name in os.listdir(samples_dir):
        if name.startswith(prefix):
            try:
                n = int(name[len(prefix):])
            except ValueError:
                continue
            if n > best_n and os.path.isdir(os.path.join(samples_dir, name)):
                best, best_n = os.path.join(samples_dir, name), n
    return best


def merge_matching(params: Dict[str, Any], loaded: Dict[str, Any]) -> Dict[str, Any]:
    """Filtered merge: a value of ``loaded`` replaces the one of ``params``
    under the same name only where the shapes match (the reference's
    partial loading); everything else keeps ``params``' value."""
    out = {}
    for k, v in params.items():
        src = loaded.get(k) if isinstance(loaded, dict) else None
        out[k] = src if src is not None and tuple(src.shape) == tuple(v.shape) else v
    return out


# buffers of SwinIR's state dict that the port computes rather than loads
SWINIR_BUFFERS = (".relative_position_index", ".attn_mask")


def load_generator_params(path: str, prefer_ema: bool = True) -> Dict[str, torch.Tensor]:
    """Generator weights as the port's OIHW state_dict, from

    * a compact ``.npz`` snapshot (``scripts/snapshot_weights.py``),
    * a reference ``.pth.tar``: ``ema_state_dict`` when present and
      preferred, else ``state_dict``, with the ``model.`` prefix stripped,
    * a SwinIR release ``.pth`` (BasicSR's layout): ``params_ema`` when
      present and preferred, else ``params``, without the
      ``relative_position_index`` and ``attn_mask`` buffers, which the port
      computes, or
    * a checkpoint directory of the port's trainer or the JAX trainer's
      Orbax directory: ``ema_params`` when preferred and saved, else
      ``params``.

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
        for ema, plain in (("ema_state_dict", "state_dict"), ("params_ema", "params")):
            if isinstance(ckpt, dict) and (ema in ckpt or plain in ckpt):
                ckpt = ckpt[ema if (prefer_ema and ema in ckpt) else plain]
                break
        return {k: torch.as_tensor(v, dtype=torch.float32)
                for k, v in strip_prefix(ckpt).items() if not k.endswith(SWINIR_BUFFERS)}
    if os.path.isdir(path):
        tree = load_checkpoint(path)
        ema = tree.get("ema_params")
        params = ema if prefer_ema and ema else tree["params"]
        return {k: v.float() for k, v in params.items()}
    raise ValueError(f"unrecognized generator weights file: {path} "
                     "(expected .npz, .pth.tar or a checkpoint directory)")
