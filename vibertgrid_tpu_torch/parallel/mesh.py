"""Process bootstrap, rank helpers and batch placement (port of
``vibertgrid_tpu/parallel/mesh.py``).

The port runs one process per device, as torchrun launches it: each process
reads ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` and joins one ``torch.distributed`` group. The JAX package
gets three things for free from one program over the global batch, and the
port makes each of them explicit:

- the gradient of the global-batch loss: every batch-wide reduction of the
  loss and of the BatchNorms sums over all ranks
  (:mod:`vibertgrid_tpu_torch.parallel.collectives`), and the train step
  all-reduces the gradients (``train/state.py``);
- SyncBatchNorm: the statistics of a training BatchNorm are those of every
  rank's batch (``models/norm.py``);
- the eval gather: each process scores its loader shard and
  ``eval/harness.py::validate`` gathers the metric objects with
  :func:`process_allgather_objects`.

Tensor parallelism (a ``model`` axis above 1) is not ported
(``parallel/sharding.py::param_shardings``).
"""

from __future__ import annotations

import builtins
import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

ROADMAP_TP = ("tensor parallelism (mesh_model > 1) is not ported yet: ROADMAP.md, "
              "Queue 1, item H")


def get_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def local_device_index() -> int:
    """This process's card: ``LOCAL_RANK`` modulo the cards on the host."""
    return int(os.environ.get("LOCAL_RANK", get_rank())) % max(torch.cuda.device_count(), 1)


def init_distributed_mode(timeout: float = 300.0, backend: str | None = None,
                          device: str | torch.device = "cuda") -> bool:
    """Join the process group that torchrun's environment describes; returns
    whether one is joined. Without ``WORLD_SIZE`` in the environment this is
    a no-op (one process). ``backend=None`` takes NCCL when the ranks run on
    ``device``'s type ``cuda`` and gloo when they run on the CPU; an explicit
    backend is used as given (two processes on one card need gloo: NCCL
    refuses two ranks on one device).

    A bootstrap that fails raises, within ``timeout`` seconds: falling back
    to one process would train on a part of the data."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ.get("RANK", "0"))
    missing = [k for k in ("MASTER_ADDR", "MASTER_PORT") if not os.environ.get(k)]
    if missing:
        raise RuntimeError(f"WORLD_SIZE={world} without {', '.join(missing)}: no rendezvous "
                           "to join (torchrun sets them)")
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_device_index())
    dist.init_process_group(
        backend,
        init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=timeout))
    return True


def setup_rank0_print() -> None:
    """Gate ``print()`` to rank 0 (``print(..., force=True)`` prints on any
    rank), as the reference's ``distributed_utils.py:57-70`` does."""
    if is_main_process():
        return
    orig = builtins.print

    def quiet_print(*args, force: bool = False, **kwargs):
        if force:
            orig(*args, **kwargs)

    builtins.print = quiet_print


def make_mesh(data: int | None = None, model: int = 1) -> tuple[int, int]:
    """Check a ``(data, model)`` layout against the processes and return it.
    One process is one data shard, so ``data`` (``None``: the world size)
    must equal the world size; more raises, as the JAX package's
    ``make_mesh`` asserts. ``model > 1`` raises ``NotImplementedError``."""
    world = get_world_size()
    if (model or 1) > 1:
        raise NotImplementedError(ROADMAP_TP)
    data = world if data is None else int(data)
    if data > world:
        raise ValueError(f"mesh_data={data} needs {data} processes, the world has {world}")
    if data != world:
        raise ValueError(f"mesh_data={data} with {world} processes: each process is one "
                         "data shard")
    return data, 1


def process_allgather_objects(obj) -> list:
    """Every process's ``obj``, in rank order (``all_gather_object``); the
    identity in one process, where no collective is issued."""
    world = get_world_size()
    if world == 1:
        return [obj]
    out = [None] * world
    dist.all_gather_object(out, obj)
    return out


def process_allgather_bytes(payload: bytes) -> list[bytes]:
    """Every process's ``payload``, in rank order; the identity in one process."""
    return [bytes(b) for b in process_allgather_objects(bytes(payload))]


def shard_batch(batch, rank: int, world: int):
    """Rank ``rank``'s rows of a host batch of ``world`` equal shares: the
    contiguous block ``[rank·b/world, (rank+1)·b/world)`` of every tensor's
    leading axis (the JAX package's ``P("data")`` placement). ``batch``: a
    tensor, a dataclass of tensors (``Batch``) or a dict of them."""
    def rows(x):
        b = x.shape[0]
        if b % world:
            raise ValueError(f"batch of {b} rows does not split into {world} equal shares")
        n = b // world
        return x[rank * n:(rank + 1) * n]

    if isinstance(batch, torch.Tensor):
        return rows(batch)
    if isinstance(batch, dict):
        return {k: rows(v) for k, v in batch.items()}
    return dataclasses.replace(batch, **{f.name: rows(getattr(batch, f.name))
                                         for f in dataclasses.fields(batch)})


@torch.no_grad()
def replicate(module: torch.nn.Module, src: int = 0) -> torch.nn.Module:
    """Broadcast rank ``src``'s parameters and buffers to every rank, in
    place; a no-op in one process."""
    if get_world_size() > 1:
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src)
    return module
