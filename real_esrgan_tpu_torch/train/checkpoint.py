"""Checkpoints and generator weight loading: the port of
real_esrgan_tpu/train/checkpoint.py.

The trainer's epoch checkpoint is a directory (``g_epoch_N``, and its
``g_best``/``g_last`` copies) holding one ``torch.save`` file,
``CHECKPOINT_FILE``, with the JAX trainer's payload: ``epoch``,
``best_niqe``, ``step``, ``params``, ``ema_params``, ``opt_state`` (the
update ``count`` and the moments ``mu``/``nu``) and ``guard``, as tensors on
the CPU, plain dicts and numbers, so it loads with ``weights_only=True``.
Saves are synchronous.

Generator weights load from three formats: compact ``.npz`` snapshots
(``/``-joined flax paths, f16 stored, loaded as f32), reference
``.pth.tar`` checkpoints, and the port's checkpoint directories.  Orbax
checkpoint directories need JAX to read; ``scripts/snapshot_weights.py``
turns one into an ``.npz`` snapshot.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from real_esrgan_tpu_torch.models.convert import (
    convert_generator, state_dict_from_jax_params, strip_prefix,
)


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


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The payload of the checkpoint directory ``path``, on the CPU."""
    return torch.load(os.path.join(path, CHECKPOINT_FILE), map_location="cpu",
                      weights_only=True)


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
    ('' if none): the trainers' ``--resume auto``."""
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


def load_generator_params(path: str, prefer_ema: bool = True) -> Dict[str, torch.Tensor]:
    """Generator weights as the port's OIHW state_dict, from

    * a compact ``.npz`` snapshot (``scripts/snapshot_weights.py``),
    * a reference ``.pth.tar``: ``ema_state_dict`` when present and
      preferred, else ``state_dict``, with the ``model.`` prefix stripped, or
    * a checkpoint directory of the port's trainer: ``ema_params`` when
      preferred, else ``params``.

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
    if os.path.isdir(path) and is_checkpoint_dir(path):
        tree = load_checkpoint(path)
        params = tree["ema_params"] if prefer_ema and tree.get("ema_params") else tree["params"]
        return {k: v.float() for k, v in params.items()}
    if os.path.isdir(path):
        raise ValueError(
            f"{path} looks like an Orbax checkpoint directory, which needs JAX to "
            "read; convert it first with `python scripts/snapshot_weights.py "
            f"--checkpoint {path} --output weights.npz` and load the .npz")
    raise ValueError(f"unrecognized generator weights file: {path} "
                     "(expected .npz or .pth.tar)")
