"""Port weight I/O (real_esrgan_tpu_torch/models/convert.py,
train/checkpoint.py) against the JAX package's loaders: every tensor must
equal the JAX tree after HWIO -> OIHW, exactly."""

import os
import pickle

import numpy as np
import pytest
import torch

from real_esrgan_tpu.models import convert as jax_convert
from real_esrgan_tpu.train.checkpoint import load_generator_params as jax_load
from real_esrgan_tpu_torch.models import Generator
from real_esrgan_tpu_torch.models import convert
from real_esrgan_tpu_torch.train.checkpoint import load_generator_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = [os.path.join(ROOT, "assets", f"inenv10_{n}_ema.npz") for n in ("esrnet", "esrgan")]


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _port_key(jax_key):
    """flax path -> reference state_dict key (the grammar of convert.py)."""
    parts = jax_key.split("/")
    leaf = "weight" if parts[-1] == "kernel" else "bias"
    if parts[0].startswith("trunk_"):
        return f"trunk.{parts[0][6:]}.{parts[1]}.{parts[2]}.{leaf}"
    name = f"{parts[0]}.0" if parts[0] in ("upsampling1", "upsampling2", "conv3") else parts[0]
    return f"{name}.{leaf}"


@pytest.mark.parametrize("path", ASSETS, ids=["esrnet", "esrgan"])
def test_npz_assets_equal_jax_tree(path):
    tree = jax_load(path)
    sd = load_generator_params(path)
    flat = dict(_flatten(tree))
    assert len(flat) == len(sd) == 702
    for key, value in flat.items():
        port = sd[_port_key(key)].numpy()
        want = np.transpose(value, (3, 2, 0, 1)) if value.ndim == 4 else value
        assert port.dtype == np.float32
        np.testing.assert_array_equal(port, want, err_msg=key)
    Generator().load_state_dict(sd)  # strict: names and shapes match the model


def _small_jax_tree():
    """A 1-RRDB JAX generator tree of random numpy arrays."""
    rng = np.random.default_rng(0)
    model = Generator(num_rrdb=1)
    sd = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
          for k, v in model.state_dict().items()}
    return jax_convert.convert_generator(sd), sd


def test_pth_tar_roundtrip_from_jax_export(tmp_path):
    tree = jax_load(ASSETS[0])
    exported = jax_convert.export_generator(tree)
    path = str(tmp_path / "g.pth.tar")
    torch.save({"ema_state_dict": {"model." + k: torch.from_numpy(v) for k, v in exported.items()},
                "state_dict": {k: torch.zeros(1) for k in exported}}, path)
    sd = load_generator_params(path)
    assert set(sd) == set(exported)
    for k, v in exported.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    assert not load_generator_params(path, prefer_ema=False)["conv1.weight"].any()


def test_bare_state_dict_pth_loads(tmp_path):
    _, sd = _small_jax_tree()
    path = str(tmp_path / "g.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    loaded = load_generator_params(path)
    Generator(num_rrdb=1).load_state_dict(loaded)
    for k, v in sd.items():
        np.testing.assert_array_equal(loaded[k].numpy(), v)


def test_converters_match_jax():
    tree, sd = _small_jax_tree()
    port_tree = convert.convert_generator(sd)
    assert dict(_flatten(port_tree)).keys() == dict(_flatten(tree)).keys()
    for (k, a), (_, b) in zip(sorted(_flatten(port_tree)), sorted(_flatten(tree))):
        np.testing.assert_array_equal(a, b, err_msg=k)
    port_sd = convert.export_generator(tree)
    jax_sd = jax_convert.export_generator(tree)
    assert port_sd.keys() == jax_sd.keys()
    for k in jax_sd:
        np.testing.assert_array_equal(port_sd[k], jax_sd[k])
    carried = convert.state_dict_from_jax_params(tree)
    for k in sd:
        np.testing.assert_array_equal(carried[k].numpy(), sd[k])
    assert convert.strip_prefix({"model.a": 1, "b": 2}) == {"a": 1, "b": 2}


def test_orbax_directory_raises_with_the_conversion_route(tmp_path):
    """An empty directory is a checkpoint of neither kind and raises naming
    both; the JAX trainer's Orbax directory (no EMA saved) loads its params,
    the committed snapshot's head, trunk_0 and tail."""
    with pytest.raises(ValueError, match="neither a checkpoint directory of the port .* nor an "
                                         "Orbax checkpoint directory"):
        load_generator_params(str(tmp_path))
    orbax = load_generator_params(os.path.join(ROOT, "tests", "data", "jax_orbax", "g_c64_b1"))
    npz = load_generator_params(os.path.join(ROOT, "assets", "inenv10_esrnet_ema.npz"))
    assert len(orbax) == 42
    for k, v in orbax.items():
        assert torch.equal(v, npz[k]), k
    with pytest.raises(ValueError, match="unrecognized"):
        load_generator_params(str(tmp_path / "weights.bin"))


def _assert_same_as_jax(path, sd):
    """The port's load of ``path`` equals the JAX loader's tree, tensor for
    tensor after HWIO -> OIHW, and equals ``sd``."""
    loaded = load_generator_params(path)
    flat = dict(_flatten(jax_load(path)))
    assert len(flat) == len(loaded) == len(sd)
    for key, value in flat.items():
        port = loaded[_port_key(key)].numpy()
        want = np.transpose(value, (3, 2, 0, 1)) if value.ndim == 4 else value
        assert port.dtype == np.float32
        np.testing.assert_array_equal(port, want, err_msg=key)
    for k, v in sd.items():
        np.testing.assert_array_equal(loaded[k].numpy(), v, err_msg=k)


def test_pth_tar_with_a_numpy_scalar_beside_the_weights(tmp_path):
    """The reference saves ``best_niqe`` (a numpy float64) beside the
    weights; the weights-only unpickler must take it."""
    _, sd = _small_jax_tree()
    path = str(tmp_path / "g_best.pth.tar")
    torch.save({"epoch": 1, "best_niqe": np.float64(3.9),
                "ema_state_dict": {"model." + k: torch.from_numpy(v) for k, v in sd.items()}},
               path)
    _assert_same_as_jax(path, sd)


@pytest.mark.parametrize("dtype", [np.float32, np.float16], ids=["f32", "f16"])
def test_pth_tar_with_an_ema_state_dict_of_numpy_arrays(tmp_path, dtype):
    _, sd = _small_jax_tree()
    sd = {k: v.astype(dtype).astype(np.float32) for k, v in sd.items()}  # values dtype holds
    path = str(tmp_path / "g.pth.tar")
    torch.save({"ema_state_dict": {k: v.astype(dtype) for k, v in sd.items()}}, path)
    _assert_same_as_jax(path, sd)


class NotWeights:
    """A class no weights file holds: the weights-only unpickler refuses it."""


def test_pth_tar_with_an_arbitrary_class_still_raises(tmp_path):
    _, sd = _small_jax_tree()
    path = str(tmp_path / "g.pth.tar")
    torch.save({"best_niqe": np.float64(3.9), "extra": NotWeights(),
                "ema_state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    with pytest.raises(pickle.UnpicklingError):
        load_generator_params(path)
