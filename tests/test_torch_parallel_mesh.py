"""``real_esrgan_tpu_torch/parallel/mesh.py``, the port's counterpart of
real_esrgan_tpu/parallel/mesh.py on ``torch.distributed``.

The environment parsing takes both JAX's launch names and torchrun's; at
world size 1 (no process group) every collective returns its input; at
world size 2 (two spawned processes, gloo on localhost, JAX's names, at
most ``TIMEOUT`` seconds) the broadcasts hand rank 0's values to rank 1
and ``all_reduce_mean`` is the mean, the same bits on both ranks.
"""

import json

import numpy as np
import pytest
import torch

from real_esrgan_tpu_torch.parallel import mesh
from real_esrgan_tpu_torch.tools.dp_check import launch_local

TIMEOUT = 120.0
NAMES = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
         "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def test_jax_launch_names():
    cfg = mesh.distributed_env({"COORDINATOR_ADDRESS": "10.0.0.2:8476", "NUM_PROCESSES": "4",
                                "PROCESS_ID": "3"})
    assert cfg == {"init_method": "tcp://10.0.0.2:8476", "world_size": 4, "rank": 3,
                   "local_rank": None, "local_world_size": None}


def test_torchrun_names():
    cfg = mesh.distributed_env({"MASTER_ADDR": "node0", "MASTER_PORT": "29500",
                                "WORLD_SIZE": "8", "RANK": "5", "LOCAL_RANK": "1",
                                "LOCAL_WORLD_SIZE": "4"})
    assert cfg == {"init_method": "tcp://node0:29500", "world_size": 8, "rank": 5,
                   "local_rank": 1, "local_world_size": 4}


def test_jax_names_win_over_torchrun_names():
    cfg = mesh.distributed_env({"COORDINATOR_ADDRESS": "a:1", "NUM_PROCESSES": "2",
                                "PROCESS_ID": "1", "MASTER_ADDR": "b", "MASTER_PORT": "2",
                                "WORLD_SIZE": "9", "RANK": "7"})
    assert (cfg["init_method"], cfg["world_size"], cfg["rank"]) == ("tcp://a:1", 2, 1)


@pytest.mark.parametrize("env", [
    {"COORDINATOR_ADDRESS": "a:1", "NUM_PROCESSES": "2"},           # no rank
    {"COORDINATOR_ADDRESS": "a", "NUM_PROCESSES": "2", "PROCESS_ID": "0"},  # no port
    {"MASTER_ADDR": "a", "WORLD_SIZE": "2", "RANK": "0"},           # no MASTER_PORT
])
def test_an_incomplete_launch_raises(env):
    with pytest.raises(ValueError, match="distributed launch needs"):
        mesh.distributed_env(env)


def test_no_names_no_group(monkeypatch):
    for name in NAMES:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("RANK", "3")  # torchrun's rank alone asks for no group
    assert mesh.distributed_env() is None
    assert mesh.maybe_initialize_distributed() is False
    with mesh.process_group() as up:
        assert up is False


def test_every_collective_is_a_no_op_at_world_size_1():
    assert (mesh.rank(), mesh.world_size(), mesh.is_lead()) == (0, 1, True)
    grads = {"a": torch.randn(3, 4), "b": torch.randn(5, dtype=torch.float64)}
    out = mesh.all_reduce_mean(grads)
    assert all(out[k] is grads[k] for k in grads)
    assert mesh.all_reduce_mean(grads, force=True)["a"] is grads["a"]  # no group: nothing runs
    assert mesh.broadcast_string("g_epoch_3") == "g_epoch_3"
    tree = {"x": torch.ones(2), "n": 3}
    assert mesh.broadcast_pytree(tree) is tree
    assert mesh.shard_slice(48, 0, 1) == slice(0, 48)


def test_shard_slice():
    assert [mesh.shard_slice(48, r, 4) for r in range(4)] == [
        slice(0, 12), slice(12, 24), slice(24, 36), slice(36, 48)]
    with pytest.raises(ValueError, match="do not split evenly"):
        mesh.shard_slice(10, 0, 4)


def test_local_device_without_cuda():
    assert mesh.local_device(cpu=True) == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.local_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.local_devices()


WORKER = r'''
import dataclasses, datetime, json
import numpy as np, torch
from real_esrgan_tpu_torch.parallel import mesh

@dataclasses.dataclass
class Box:
    a: torch.Tensor
    n: int

with mesh.process_group("gloo", timeout=datetime.timedelta(seconds=60)):
    r, w = mesh.rank(), mesh.world_size()
    print(f"rank {r} of {w}", flush=True)
    text = mesh.broadcast_string("samples/run/g_epoch_7 é" if r == 0 else "")
    tree = {"t": torch.full((2, 3), float(r)), "np": np.arange(4) * (r + 1),
            "nested": ({"i": 7 * (r + 1), "f": 0.5 * (r + 1), "b": r == 0,
                        "bf": torch.full((2,), float(r), dtype=torch.bfloat16),
                        "mask": torch.tensor([r == 0, r == 1])}, None, "kept"),
            "box": Box(torch.tensor([r, r + 1]), r)}
    got = mesh.broadcast_pytree(tree)
    grads = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3) * (r + 1),
             "b": torch.full((5,), float(r), dtype=torch.float64),
             "loss": torch.tensor(float(r + 1))}
    mean = mesh.all_reduce_mean(grads)
    try:
        mesh.broadcast_pytree({"x": torch.zeros(2 + r)})
        mismatch = "no error"
    except ValueError as exc:
        mismatch = str(exc)
    nested = got["nested"][0]
    print("RESULT " + json.dumps({
        "rank": r, "text": text, "t": got["t"].tolist(), "np": got["np"].tolist(),
        "np_type": type(got["np"]).__name__, "i": nested["i"], "f": nested["f"],
        "b": nested["b"], "types": [type(nested[k]).__name__ for k in ("i", "f", "b")],
        "bf": nested["bf"].float().tolist(), "bf_dtype": str(nested["bf"].dtype),
        "mask": nested["mask"].tolist(), "rest": list(got["nested"][1:]),
        "box": [got["box"].a.tolist(), got["box"].n, type(got["box"]).__name__],
        "mean": {k: v.tolist() for k, v in mean.items()},
        "mean_dtypes": {k: str(v.dtype) for k, v in mean.items()}, "mismatch": mismatch}))
'''


@pytest.fixture(scope="module")
def two_ranks():
    runs = launch_local(["-c", WORKER], 2, TIMEOUT, env={"OMP_NUM_THREADS": "1"})
    results = []
    for r, (rc, out) in enumerate(runs):
        assert rc == 0, f"rank {r} failed:\n{out[-4000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert line, out[-4000:]
        results.append(json.loads(line[-1][len("RESULT "):]))
    return results


def test_broadcast_string_at_world_size_2(two_ranks):
    assert [r["text"] for r in two_ranks] == ["samples/run/g_epoch_7 é"] * 2


def test_broadcast_pytree_at_world_size_2(two_ranks):
    for r in two_ranks:
        assert r["t"] == [[0.0] * 3] * 2
        assert r["np"] == [0, 1, 2, 3] and r["np_type"] == "ndarray"
        assert (r["i"], r["f"], r["b"]) == (7, 0.5, True)
        assert r["types"] == ["int", "float", "bool"]
        assert r["bf"] == [0.0, 0.0] and r["bf_dtype"] == "torch.bfloat16"
        assert r["mask"] == [True, False]
        assert r["rest"] == [None, "kept"]
        assert r["box"] == [[0, 1], 0, "Box"]


def test_broadcast_pytree_refuses_trees_of_another_structure_on_every_rank(two_ranks):
    for r in two_ranks:
        assert "differ in structure" in r["mismatch"]


def test_all_reduce_mean_is_the_mean_at_world_size_2(two_ranks):
    a = (np.arange(6).reshape(2, 3) * 1 + np.arange(6).reshape(2, 3) * 2) / 2
    for r in two_ranks:
        assert np.array_equal(np.asarray(r["mean"]["a"]), a)
        assert r["mean"]["b"] == [0.5] * 5
        assert r["mean"]["loss"] == 1.5
        assert r["mean_dtypes"] == {"a": "torch.float32", "b": "torch.float64",
                                    "loss": "torch.float32"}
    assert two_ranks[0]["mean"] == two_ranks[1]["mean"]


def test_launch_local_reports_a_failing_rank():
    runs = launch_local(["-c", "import sys; print('rank {} of 2'.format(__import__('os')"
                         ".environ['PROCESS_ID'])); sys.exit(int(__import__('os')"
                         ".environ['PROCESS_ID']))"], 2, TIMEOUT)
    assert [rc for rc, _ in runs] == [0, 1]


def test_launch_local_kills_a_rank_past_its_time():
    runs = launch_local(["-c", "import time; print('rank 0 of 1', flush=True); "
                         "time.sleep(60)"], 1, 2.0)
    (rc, out), = runs
    assert rc is None and "killed after" in out
