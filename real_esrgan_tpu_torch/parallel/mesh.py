"""Process groups, device placement and the collectives of data-parallel
training: the port of real_esrgan_tpu/parallel/mesh.py on ``torch.distributed``.

JAX is single-controller per host: one process drives every local device
through a ``Mesh``, ``process_count()`` counts hosts, and XLA inserts the
gradient all-reduce when a jitted step consumes a batch sharded over the mesh
with replicated parameters.  The port follows PyTorch's idiom for training
instead: one process (a rank) per GPU, and ``world_size()`` counts GPUs.  Every
rank holds the whole training state, takes its slice of each global batch and
averages the gradients with ``all_reduce_mean``.  For serving it keeps JAX's
shape: one process with a list of devices (``local_devices()``), over which
``parallel/tiling.py`` spreads each tile batch.

==============================  ==========================================
JAX (``real_esrgan_tpu``)        this module
==============================  ==========================================
``process_index()``              ``rank()``
``process_count()`` (hosts)      ``world_size()`` (GPUs)
``make_mesh()``                  ``local_devices()``
``batch_sharding``/``shard_batch``  ``shard_slice(n, rank(), world_size())``
``replicated_sharding``          every rank holds the state, sent once by
                                 ``broadcast_pytree``
XLA's gradient all-reduce        ``all_reduce_mean``
``broadcast_string``             ``broadcast_string``
``broadcast_pytree``             ``broadcast_pytree``
==============================  ==========================================

Every collective is a no-op at world size 1, as in JAX, so a run with no
process group behaves as before the group existed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import hashlib
import os
from typing import Dict, Iterator, List, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

# Other ranks wait in the next step's collective while the lead validates and
# saves, so the group's timeout must outlast one lead-only validation.
DEFAULT_TIMEOUT = datetime.timedelta(hours=1)

_NO_CUDA = "CUDA is not available: pass device='cpu' (or --cpu) to run on the CPU"


def distributed_env(environ: Optional[Mapping[str, str]] = None) -> Optional[dict]:
    """The process group a launcher asked for, or None when it asked for none.

    Reads JAX's names (``COORDINATOR_ADDRESS`` as host:port, ``NUM_PROCESSES``,
    ``PROCESS_ID``), so one launch line serves both packages, and torchrun's
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  A group is
    asked for by ``COORDINATOR_ADDRESS`` or ``MASTER_ADDR``; the world size and
    rank then come from either set, JAX's first.  ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` are torchrun's, read where set.  JAX's
    ``MEGASCALE_*`` names (multi-slice TPU pods) have no counterpart: NCCL
    finds its own transport across hosts.

    Returns ``{"init_method", "world_size", "rank", "local_rank",
    "local_world_size"}`` (the last two None where unset)."""
    env = os.environ if environ is None else environ
    if env.get("COORDINATOR_ADDRESS"):
        host, _, port = env["COORDINATOR_ADDRESS"].rpartition(":")
    elif env.get("MASTER_ADDR"):
        host, port = env["MASTER_ADDR"], env.get("MASTER_PORT", "")
    else:
        return None
    world = env.get("NUM_PROCESSES") or env.get("WORLD_SIZE")
    rank_ = env.get("PROCESS_ID") or env.get("RANK")
    if not host or not port or world is None or rank_ is None:
        raise ValueError("a distributed launch needs an address with a port "
                         "(COORDINATOR_ADDRESS=host:port, or MASTER_ADDR and MASTER_PORT), a "
                         "world size (NUM_PROCESSES or WORLD_SIZE) and a rank (PROCESS_ID or "
                         f"RANK); got address {host!r}:{port!r}, world {world}, rank {rank_}")
    optional = lambda name: int(env[name]) if env.get(name) else None  # noqa: E731
    return {"init_method": f"tcp://{host}:{port}", "world_size": int(world), "rank": int(rank_),
            "local_rank": optional("LOCAL_RANK"), "local_world_size": optional("LOCAL_WORLD_SIZE")}


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _local_index(rank_: int, local_rank: Optional[int]) -> int:
    """The rank's CUDA device: ``LOCAL_RANK`` where the launcher set it, else
    the rank modulo the visible devices (ranks fill a host in order)."""
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError(_NO_CUDA)
    index = local_rank if local_rank is not None else rank_ % count
    if index >= count:
        raise RuntimeError(f"local rank {index} has no GPU: {count} visible")
    return index


def maybe_initialize_distributed(backend: Optional[str] = None,
                                 timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> bool:
    """Joins the process group the environment names (``distributed_env``).

    True when a group is up (also when one was up already: idempotent), False
    when the environment names none.  ``backend`` defaults to ``nccl`` where
    the rank's device is CUDA and ``gloo`` on the CPU; a CPU run on a machine
    with a GPU passes ``gloo``.  Under NCCL the rank's GPU becomes its
    current device."""
    if _initialized():
        return True
    cfg = distributed_env()
    if cfg is None:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    device = None
    if backend == "nccl":
        device = torch.device("cuda", _local_index(cfg["rank"], cfg["local_rank"]))
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=cfg["init_method"],
                            world_size=cfg["world_size"], rank=cfg["rank"], timeout=timeout,
                            device_id=device)
    return True


@contextlib.contextmanager
def process_group(backend: Optional[str] = None,
                  timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Iterator[bool]:
    """``maybe_initialize_distributed`` for the body of an entry point; yields
    whether a group is up.  A group this call created ends with it: after a
    barrier when the body returned (so no rank leaves while the lead still
    saves), at once when it raised."""
    created = not _initialized() and maybe_initialize_distributed(backend, timeout)
    try:
        yield _initialized()
        if created:
            dist.barrier()
    finally:
        if created:
            dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if _initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def is_lead() -> bool:
    """Rank 0: the one rank that validates and writes checkpoints."""
    return rank() == 0


def single_host() -> bool:
    """Whether every rank runs on this host: ``LOCAL_WORLD_SIZE`` (torchrun's)
    equals the world size; without it, a launch is taken as one host's."""
    local = os.environ.get("LOCAL_WORLD_SIZE")
    return local is None or int(local) == world_size()


def local_device(cpu: bool = False) -> torch.device:
    """This rank's device: ``cpu`` when asked for; else ``cuda:LOCAL_RANK``
    under a process group and the current CUDA device without one.  Raises
    when there is no CUDA device and the CPU was not asked for."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(_NO_CUDA)
    if not _initialized():
        return torch.device("cuda")
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", _local_index(rank(), int(local) if local else None))


def local_devices() -> List[torch.device]:
    """Every visible GPU of this process, for the single-process tile spread
    (``make_mesh``'s place).  Raises without CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError(_NO_CUDA)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def shard_slice(n: int, rank_: int, world: int) -> slice:
    """Rank ``rank_``'s equal share of ``n`` leading rows out of ``world``;
    ``n`` must divide evenly, so a mean of the ranks' means is the mean."""
    if n % world:
        raise ValueError(f"{n} rows do not split evenly over {world} ranks")
    per = n // world
    return slice(rank_ * per, (rank_ + 1) * per)


def _stage(flat: torch.Tensor) -> torch.Tensor:
    """``flat`` where the backend can reduce it: gloo takes CUDA tensors only
    through the host, so they go through host memory there."""
    if flat.is_cuda and dist.get_backend() == "gloo":
        return flat.cpu()
    return flat


def all_reduce_mean(tensors: Dict[str, torch.Tensor], force: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """The mean over the ranks of each floating tensor of ``tensors``: the
    gradient all-reduce XLA inserts on the JAX side.

    The tensors of one dtype and device travel in one flat buffer (one
    collective, not one a parameter); the sum is divided by the world size.
    Every rank gets the same bits back.  At world size 1 it returns the
    tensors as they are, unless ``force`` and a group is up (a one-rank
    group then still runs its collective).  Under NCCL the buffer never
    leaves the GPU; under gloo a CUDA buffer is staged through host memory,
    since gloo reduces on the CPU."""
    world = world_size()
    if world == 1 and not (force and _initialized()):
        return dict(tensors)
    groups: Dict[tuple, List[str]] = {}
    for name, t in tensors.items():
        if not t.is_floating_point():
            raise TypeError(f"all_reduce_mean takes floating tensors; {name} is {t.dtype}")
        groups.setdefault((t.dtype, t.device), []).append(name)
    out = {}
    for names in groups.values():
        parts = [tensors[n] for n in names]
        flat = torch.cat([t.reshape(-1) for t in parts])
        staged = _stage(flat)
        dist.all_reduce(staged)
        flat = staged.to(flat.device).div_(world)
        for name, t, piece in zip(names, parts, torch.split(flat, [t.numel() for t in parts])):
            out[name] = piece.view(t.shape)
    return {name: out[name] for name in tensors}


def _comm_device() -> torch.device:
    """Where a collective's buffer lives: the rank's GPU under NCCL, the CPU
    under gloo."""
    return local_device() if dist.get_backend() == "nccl" else torch.device("cpu")


def broadcast_string(s: str, max_len: int = 4096) -> str:
    """Every rank returns rank 0's string (a no-op at world size 1), through a
    uint8 buffer of ``max_len`` bytes.

    The trainers' ``--resume auto`` resolves the checkpoint path once, on the
    lead, which writes the checkpoints, and sends it: ranks that each looked
    for themselves could disagree without a shared filesystem, and ranks that
    resume at different epochs deadlock in their collectives."""
    if world_size() == 1:
        return s
    raw = s.encode()[:max_len].ljust(max_len, b"\x00")
    buf = torch.from_numpy(np.frombuffer(raw, np.uint8).copy()).to(_comm_device())
    dist.broadcast(buf, 0)
    return bytes(buf.cpu().numpy()).rstrip(b"\x00").decode()


def _flatten(tree, leaves: list):
    """Appends ``tree``'s leaves to ``leaves`` and returns a function that
    rebuilds the tree from an iterator of new leaves.  Containers: dict,
    list, tuple and dataclass instances; leaves: tensors, numpy arrays and
    Python bool/int/float; anything else (None, strings) rides unchanged."""
    if isinstance(tree, dict):
        parts = {k: _flatten(v, leaves) for k, v in tree.items()}
        return lambda it: {k: part(it) for k, part in parts.items()}
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v, leaves) for v in tree]
        return lambda it: type(tree)(part(it) for part in parts)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        parts = {f.name: _flatten(getattr(tree, f.name), leaves)
                 for f in dataclasses.fields(tree)}
        return lambda it: dataclasses.replace(tree, **{k: part(it) for k, part in parts.items()})
    if isinstance(tree, (torch.Tensor, np.ndarray, bool, int, float)):
        leaves.append(tree)
        return lambda it: next(it)
    return lambda it: tree


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(leaf))
    return torch.tensor(leaf)  # bool, int64 or float64


def _restore_leaf(leaf, value: torch.Tensor):
    if isinstance(leaf, torch.Tensor):
        return value.to(leaf.device)
    if isinstance(leaf, np.ndarray):
        return value.cpu().numpy()
    return type(leaf)(value.item())


def _signature(leaves: list, tensors: List[torch.Tensor], rebuild) -> bytes:
    """A digest of the tree's structure and its leaves' kinds, shapes and
    dtypes, not their values."""
    shape = rebuild(iter(f"{type(v).__name__}{tuple(t.shape)}{t.dtype}"
                         for v, t in zip(leaves, tensors)))
    return hashlib.sha256(repr(shape).encode()).digest()


def broadcast_pytree(tree):
    """Every rank returns rank 0's ``tree`` (a no-op at world size 1): a
    nested dict, list, tuple or dataclass of tensors, numpy arrays and
    Python numbers.  Its structure must be the same on every rank, as in
    JAX: a digest of it is sent first, and where any rank's differs every
    rank raises.  Each tensor comes back on the device of the rank's own
    leaf.

    The lead loads a checkpoint from its own disk and hands the same state
    to every rank, so no shared filesystem is needed."""
    if world_size() == 1:
        return tree
    leaves: list = []
    rebuild = _flatten(tree, leaves)
    tensors = [_as_tensor(v) for v in leaves]
    device = _comm_device()
    digest = torch.frombuffer(bytearray(_signature(leaves, tensors, rebuild)), dtype=torch.uint8)
    lead_digest = digest.to(device, copy=True)
    dist.broadcast(lead_digest, 0)
    same = torch.tensor([int(torch.equal(lead_digest.cpu(), digest))], device=device)
    dist.all_reduce(same, op=dist.ReduceOp.MIN)  # every rank learns of any mismatch
    if not same.item():
        raise ValueError("broadcast_pytree: the ranks' trees differ in structure from rank 0's")
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    values: list = [None] * len(tensors)
    for dtype, idx in groups.items():
        wire = torch.uint8 if dtype == torch.bool else dtype  # gloo carries no bool
        sizes = [tensors[i].numel() for i in idx]
        if is_lead():
            flat = torch.cat([tensors[i].reshape(-1).to(device, wire) for i in idx])
        else:
            flat = torch.empty(sum(sizes), dtype=wire, device=device)
        dist.broadcast(flat, 0)
        for i, piece in zip(idx, torch.split(flat, sizes)):
            values[i] = piece.view(tensors[i].shape).to(dtype)
    return rebuild(iter(_restore_leaf(leaf, v) for leaf, v in zip(leaves, values)))
