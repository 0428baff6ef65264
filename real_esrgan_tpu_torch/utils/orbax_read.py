"""Reads an Orbax PyTree checkpoint directory without JAX, Orbax or
TensorStore: the counterpart of the JAX package's ``load_checkpoint`` for
the directories its trainers write.

Such a directory holds:

* ``_METADATA``, JSON: for every leaf its tree path (``key_type`` 2 for a
  dict key, 1 for a sequence index) and its ``value_type`` (``np.ndarray``,
  ``scalar``, ``None``), and whether the arrays sit in an OCDBT store
  (``use_ocdbt``) and in zarr v2 or v3 (``use_zarr3``);
* each array as a zarr v2 array named by the leaf's path joined with
  ``.``: a ``<name>/.zarray`` JSON entry (shape, chunks, dtype, compressor,
  fill value, order) and its chunks ``<name>/<i>.<j>...``, in the OCDBT
  store (``utils/ocdbt.py``) or, with ``use_ocdbt`` false, as plain files.
  A chunk that is not stored is the fill value, unless ``_METADATA`` says
  ``store_array_data_equal_to_fill_value``: then it is an error, as in
  Orbax.

``read_pytree`` rebuilds nested dicts and lists (optax's tuples come back
as lists, and its ``EmptyState`` as ``None``, as Orbax restores them);
arrays come back as numpy arrays, except bfloat16 ones, which numpy lacks,
as ``torch.bfloat16`` tensors; scalars as numpy scalars, ``None`` as
``None``.
"""

from __future__ import annotations

import itertools
import json
import math
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from real_esrgan_tpu_torch.utils import zstd
from real_esrgan_tpu_torch.utils.ocdbt import MANIFEST, OcdbtStore

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
ARRAY_TYPES = ("np.ndarray", "jax.Array")
DTYPES = ("<f4", "<f8", "<f2", "<i4", "<i8", "|b1", "bfloat16")


def is_orbax_dir(path: str) -> bool:
    """An Orbax PyTree directory: ``_METADATA``, or ``_CHECKPOINT_METADATA``
    beside an OCDBT manifest."""
    return os.path.isdir(path) and (
        os.path.isfile(os.path.join(path, METADATA))
        or (os.path.isfile(os.path.join(path, CHECKPOINT_METADATA))
            and os.path.isfile(os.path.join(path, MANIFEST))))


def _read_array(name: str, get: Callable[[str], Optional[bytes]], fill_missing: bool):
    """The zarr v2 array ``name``; ``get(key)`` returns an entry's bytes or
    None where it is absent.  A chunk that is absent is the fill value where
    ``fill_missing``, else an error."""
    meta_bytes = get(f"{name}/.zarray")
    if meta_bytes is None:
        raise ValueError(f"Orbax array {name!r} has no .zarray entry")
    meta = json.loads(meta_bytes)
    if meta.get("zarr_format") != 2:
        raise ValueError(f"Orbax array {name!r}: zarr_format {meta.get('zarr_format')}, "
                         "only zarr v2 is read")
    code = meta["dtype"]
    if code not in DTYPES:
        raise ValueError(f"Orbax array {name!r}: dtype {code!r} is not read (only {DTYPES})")
    bf16 = code == "bfloat16"
    dtype = np.dtype("<u2") if bf16 else np.dtype(code)
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"Orbax array {name!r}: compressor {compressor.get('id')!r}, "
                         "only zstd or none is read")
    if meta.get("filters"):
        raise ValueError(f"Orbax array {name!r}: filters {meta['filters']} are not read")
    if meta.get("order", "C") != "C":
        raise ValueError(f"Orbax array {name!r}: order {meta['order']!r}, only C is read")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    # zarr v2 writes a float fill value of NaN or infinity as a string
    fill = meta.get("fill_value") or 0
    fill = np.asarray(float(fill) if isinstance(fill, str) else fill,
                      np.float32 if bf16 else dtype)
    if bf16:  # the fill value's bfloat16 bits
        fill = fill.view(np.uint32) >> 16
    out = np.full(shape, fill, dtype=dtype)
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    grid = [range(math.ceil(s / c)) for s, c in zip(shape, chunks)]
    for index in itertools.product(*grid):  # one empty index for a 0-d array
        data = get(f"{name}/{sep.join(map(str, index)) if index else '0'}")
        if data is None:
            if fill_missing:
                continue
            raise ValueError(f"Orbax array {name!r}: chunk {index} is missing")
        if compressor is not None:
            data = zstd.decompress(data, chunk_bytes)
        if len(data) != chunk_bytes:
            raise ValueError(f"Orbax array {name!r}: chunk {index} holds {len(data)} bytes, "
                             f"expected {chunk_bytes}")
        chunk = np.frombuffer(data, dtype=dtype).reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    if bf16:
        import torch
        return torch.from_numpy(out.view(np.int16).copy()).view(torch.bfloat16)
    return out


def _assemble(node):
    """Dicts whose keys were all sequence indices become lists."""
    if not isinstance(node, dict):
        return node
    items = {k: _assemble(v) for k, v in node.items()}
    if items and all(isinstance(k, int) for k in items):
        if sorted(items) != list(range(len(items))):
            raise ValueError(f"Orbax sequence with indices {sorted(items)}")
        return [items[i] for i in range(len(items))]
    return items


def read_pytree(path: str) -> Dict[str, Any]:
    """The tree saved in the Orbax directory ``path``."""
    path = os.path.abspath(path)
    meta_path = os.path.join(path, METADATA)
    if not os.path.isfile(meta_path):
        raise ValueError(f"{path} holds no {METADATA}: not an Orbax PyTree checkpoint "
                         "this reader knows")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: use_zarr3 is true; only zarr v2 checkpoints are read")
    if meta.get("use_ocdbt", False):
        store = OcdbtStore(path)
        get = store.find
    else:
        def get(key: str) -> Optional[bytes]:
            file = os.path.join(path, *key.split("/"))
            if not os.path.isfile(file):
                return None
            with open(file, "rb") as f:
                return f.read()
    # chunks equal to the fill value are dropped unless this is set, as
    # Orbax restores them
    fill_missing = not meta.get("store_array_data_equal_to_fill_value", False)
    root: Dict[Any, Any] = {}
    for entry in meta["tree_metadata"].values():
        keys: List[Any] = []
        for k in entry["key_metadata"]:
            if k["key_type"] == 1:
                keys.append(int(k["key"]))
            elif k["key_type"] == 2:
                keys.append(str(k["key"]))
            else:
                raise ValueError(f"{path}: key type {k['key_type']} of {k['key']!r}")
        kind = entry["value_metadata"]["value_type"]
        name = ".".join(str(k) for k in keys)
        if kind == "None":
            value = None
        elif kind in ARRAY_TYPES:
            value = _read_array(name, get, fill_missing)
        elif kind == "scalar":
            value = _read_array(name, get, fill_missing)[()]
        else:
            raise ValueError(f"{path}: leaf {name!r} has value type {kind!r}, which is not read "
                             f"(only {ARRAY_TYPES}, scalar and None)")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return _assemble(root)
