"""The port's Orbax reader (``utils/orbax_read.py`` over ``utils/ocdbt.py``
and its own zstd decoder) against the JAX package's ``load_checkpoint`` and
TensorStore as oracles, bit for bit on every leaf:

* a tree of every dtype the reader takes (``<f4 <f8 <f2 <i4 <i8 |b1
  bfloat16``), scalars, ``None`` and nested lists, with arrays Orbax is made
  to split into several chunks (``chunk_byte_size``), OCDBT and plain;
* a chunk that is not stored reads as the fill value, as in JAX;
* the full-width ESRNet state (16,697,987 parameters x 4: params, EMA and
  Adam's two moments, 267 MB): every leaf equal, with the read times of both
  printed (no timing assert);
* the committed fixtures: ``leaves.json`` regenerated through JAX equals
  the committed file, and the port's read of every fixture equals it;
* the OCDBT store against TensorStore's on a store with interior B-tree
  nodes and values outside the nodes;
* zarr v3, another compressor or dtype, and a corrupted node raise, naming
  what they found.
"""

import hashlib
import json
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

import _make_orbax_fixtures as fixtures
from real_esrgan_tpu.train.checkpoint import load_checkpoint as jax_load
from real_esrgan_tpu.train.checkpoint import save_checkpoint as jax_save
from real_esrgan_tpu_torch.utils import orbax_read
from real_esrgan_tpu_torch.utils.ocdbt import OcdbtStore
from real_esrgan_tpu_torch.utils.orbax_read import is_orbax_dir, read_pytree

ROOT = fixtures.ROOT


def _flat(tree, prefix=()):
    """(path, leaf) pairs in sorted-key order, None leaves kept."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _bits(leaf):
    """dtype name, shape and bytes of a leaf; bfloat16 tensors by their bits."""
    if isinstance(leaf, torch.Tensor):
        assert leaf.dtype == torch.bfloat16
        return "bfloat16", tuple(leaf.shape), leaf.view(torch.int16).numpy().tobytes()
    arr = np.asarray(leaf)
    return str(arr.dtype), arr.shape, arr.tobytes()


def assert_same_as_jax(ours, theirs):
    a, b = list(_flat(ours)), list(_flat(theirs))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        if y is None:
            assert x is None, path
            continue
        if isinstance(y, (int, float)):  # JAX gives Python scalars; the port numpy ones
            assert isinstance(x, np.generic) and x == y, path
        else:
            assert _bits(x) == _bits(y), path


def _mixed_tree():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.standard_normal((5, 7, 3)).astype(np.float32),
        "f64": rng.standard_normal(9),
        "f16": rng.standard_normal((4, 4)).astype(np.float16),
        "i32": rng.integers(-1000, 1000, (6,), dtype=np.int32),
        "i64": rng.integers(-2 ** 40, 2 ** 40, (3, 2), dtype=np.int64),
        "bool": rng.random(11) > 0.5,
        "bf16": jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16),
        "zero_d": np.float32(2.5) * np.ones((), np.float32),
        "scalar_f": 3.25,
        "scalar_i": 7,
        "none": None,
        "nested": [None, [{"count": np.int32(4) * np.ones((), np.int32),
                            "mu": {"w": rng.standard_normal((2, 3)).astype(np.float32)}},
                           {"count": np.int32(4) * np.ones((), np.int32)}]],
        "chunked": rng.standard_normal((10, 7, 3)).astype(np.float32),
        "ragged": np.arange(50, dtype=np.int64),
    }


def _save(path, tree, use_ocdbt):
    """Orbax with the JAX package's handler settings, two arrays split into
    several chunks (the last one ragged)."""
    save_args = jax.tree_util.tree_map(lambda _: ocp.SaveArgs(), tree)
    for name, size in (("chunked", 100), ("ragged", 104)):
        if name in tree:
            save_args[name] = ocp.SaveArgs(chunk_byte_size=size)
    with ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=use_ocdbt)) as ckptr:
        ckptr.save(path, args=ocp.args.PyTreeSave(tree, save_args=save_args))


@pytest.mark.parametrize("use_ocdbt", [True, False])
def test_every_dtype_scalars_none_lists_and_chunks_equal_jax(tmp_path, use_ocdbt):
    path = str(tmp_path / "tree")
    _save(path, _mixed_tree(), use_ocdbt)
    with open(os.path.join(path, "_METADATA")) as f:
        assert json.load(f)["use_ocdbt"] is use_ocdbt
    if not use_ocdbt:
        assert len([n for n in os.listdir(os.path.join(path, "chunked")) if n[0] != "."]) > 1
    assert is_orbax_dir(path)
    ours = read_pytree(path)
    assert_same_as_jax(ours, jax_load(path))
    assert ours["none"] is None and ours["nested"][0] is None
    assert isinstance(ours["nested"], list) and isinstance(ours["nested"][1], list)
    assert isinstance(ours["scalar_f"], np.floating) and isinstance(ours["scalar_i"], np.integer)


def test_the_jax_package_writer_equals_jax(tmp_path):
    """The JAX package's own ``save_checkpoint`` (OCDBT), unchunked."""
    tree = _mixed_tree()
    path = str(tmp_path / "saved")
    jax_save(path, tree)
    assert_same_as_jax(read_pytree(path), jax_load(path))


def test_a_chunk_that_is_not_stored_reads_as_the_fill_value(tmp_path):
    """As in Orbax: the fill value where ``_METADATA`` lets chunks equal to
    it be dropped, else an error."""
    path = str(tmp_path / "plain")
    _save(path, _mixed_tree(), use_ocdbt=False)
    os.remove(os.path.join(path, "chunked", "1.3.0"))
    with pytest.raises(ValueError, match="missing"):
        jax_load(path)
    with pytest.raises(ValueError, match="chunk .1, 3, 0. is missing"):
        read_pytree(path)
    _edit_json(os.path.join(path, "_METADATA"), store_array_data_equal_to_fill_value=False)
    ours = read_pytree(path)
    assert_same_as_jax(ours, jax_load(path))
    assert not ours["chunked"][5:, 3].any() and ours["chunked"][:5].all()


def test_the_full_width_esrnet_state_equals_jax(tmp_path):
    """16,697,987 parameters in 702 leaves, x4 (params, EMA, mu, nu):
    267 MB of float32, written by the JAX package's ``save_checkpoint``."""
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        dict(np.load(os.path.join(ROOT, "assets", "inenv10_esrnet_ema.npz"))))
    tree = {}
    for key, value in params.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    n = sum(v.size for v in params.values())
    assert (n, len(params)) == (16_697_987, 702)
    rng = np.random.default_rng(0)
    moments = jax.tree_util.tree_map(lambda x: rng.standard_normal(x.shape, np.float32), tree)
    opt = [None, [{"count": np.int32(30) * np.ones((), np.int32), "mu": moments,
                   "nu": jax.tree_util.tree_map(np.square, moments)},
                  {"count": np.int32(30) * np.ones((), np.int32)}]]
    path = str(tmp_path / "g_epoch_3")
    jax_save(path, {"epoch": 3, "best_niqe": 5.5, "step": np.int32(30), "params": tree,
                    "ema_params": tree, "opt_state": opt, "guard": None})
    del params, moments, opt
    t0 = time.perf_counter()
    ours = read_pytree(path)
    t_port = time.perf_counter() - t0
    t0 = time.perf_counter()
    theirs = jax_load(path)
    t_jax = time.perf_counter() - t0
    assert_same_as_jax(ours, theirs)
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)
    print(f"full-width ESRNet state, {size / 1e6:.1f} MB on disk: port read {t_port:.2f} s, "
          f"JAX (TensorStore) read {t_jax:.2f} s")


def test_leaves_json_matches_the_committed_fixtures_through_jax():
    with open(os.path.join(fixtures.DATA, "leaves.json")) as f:
        committed = json.load(f)
    assert committed == fixtures.listing()


@pytest.mark.parametrize("name", fixtures.FIXTURES)
def test_the_port_reads_every_fixture_to_leaves_json(name):
    with open(os.path.join(fixtures.DATA, "leaves.json")) as f:
        expected = json.load(f)[name]
    got = list(_flat(read_pytree(os.path.join(fixtures.DATA, name))))
    assert [p for p, _ in got] == [leaf["path"] for leaf in expected]
    for (path, value), leaf in zip(got, expected):
        if leaf["dtype"] is None:
            assert value is None, path
            continue
        dtype, shape, data = _bits(value)
        assert (dtype, list(shape), hashlib.sha256(data).hexdigest()) == \
            (leaf["dtype"], leaf["shape"], leaf["sha256"]), path


def test_the_ocdbt_store_equals_tensorstore_with_interior_nodes(tmp_path):
    """Small nodes force a B-tree of height > 0; a small inline limit puts
    most values in data files."""
    ts = pytest.importorskip("tensorstore")
    spec = {"driver": "ocdbt", "base": f"file://{tmp_path}/",
            "config": {"max_decoded_node_bytes": 400, "max_inline_value_bytes": 16}}
    kv = ts.KvStore.open(spec).result()
    rng = np.random.default_rng(0)
    for i in range(150):
        kv.write(f"key{i:04d}/{'x' * (i % 5)}", rng.bytes(int(rng.integers(0, 200)))).result()
    kv.write("key0007/", b"rewritten").result()
    store = OcdbtStore(str(tmp_path))
    keys = sorted(k.decode() for k in kv.list().result())
    assert store.keys() == keys
    for k in keys:
        assert store.get(k) == kv.read(k).result().value, k
    with pytest.raises(KeyError):
        store.get("no/such/key")


def test_a_corrupted_node_raises(tmp_path):
    path = str(tmp_path / "tree")
    jax_save(path, {"a": np.arange(4, dtype=np.float32)})
    manifest = os.path.join(path, "manifest.ocdbt")
    with open(manifest, "rb") as f:
        data = bytearray(f.read())
    data[20] ^= 0x10
    with open(manifest, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match="CRC-32C"):
        read_pytree(path)


def _plain_dir(tmp_path):
    path = str(tmp_path / "plain")
    _save(path, {"a": np.arange(6, dtype=np.float32), "b": 1.5}, use_ocdbt=False)
    return path


def _edit_json(file, **changes):
    with open(file) as f:
        meta = json.load(f)
    meta.update(changes)
    with open(file, "w") as f:
        json.dump(meta, f)


def test_zarr3_another_compressor_or_dtype_raise_and_name_it(tmp_path):
    path = _plain_dir(tmp_path)
    zarray = os.path.join(path, "a", ".zarray")
    original = open(zarray).read()
    _edit_json(zarray, compressor={"id": "blosc", "cname": "lz4"})
    with pytest.raises(ValueError, match="blosc"):
        read_pytree(path)
    open(zarray, "w").write(original)
    _edit_json(zarray, dtype="<c8")
    with pytest.raises(ValueError, match="<c8"):
        read_pytree(path)
    open(zarray, "w").write(original)
    assert read_pytree(path)["b"] == 1.5
    _edit_json(os.path.join(path, "_METADATA"), use_zarr3=True)
    with pytest.raises(ValueError, match="use_zarr3"):
        read_pytree(path)


def test_what_is_an_orbax_directory(tmp_path):
    assert not is_orbax_dir(str(tmp_path))
    (tmp_path / orbax_read.CHECKPOINT_METADATA).write_text("{}")
    assert not is_orbax_dir(str(tmp_path))
    (tmp_path / "manifest.ocdbt").write_bytes(b"")
    assert is_orbax_dir(str(tmp_path))
    other = tmp_path / "other"
    other.mkdir()
    (other / orbax_read.METADATA).write_text("{}")
    assert is_orbax_dir(str(other))
    shutil.rmtree(other)
    assert not is_orbax_dir(str(other))
