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

:func:`make_mesh` lays the processes out on a ``(data, model)`` mesh as the
JAX package's ``devices.reshape(data, model)`` does: rank ``d·model + m``
is data shard ``d`` and model shard ``m``. The ranks of one model group
(one ``d``) hold the same documents and split the encoder's weights
(tensor parallelism, ``parallel/sharding.py``); the ranks of one data group
(one ``m``) hold the same slices of the weights and split the batch. The
:class:`Layout` it returns, with the two process groups, is what the rest
of the port reads instead of the rank and the world size.
"""

from __future__ import annotations

import builtins
import dataclasses
import datetime
import os
from typing import Any

import torch
import torch.distributed as dist


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


@dataclasses.dataclass(frozen=True)
class Layout:
    """This process's place on a ``(data, model)`` mesh of processes:
    ``rank = data_index·model + model_index``. ``data_group`` holds the
    ``data`` ranks of this model shard (None when ``data`` is 1),
    ``model_group`` the ``model`` ranks of this data shard (None when
    ``model`` is 1). One process is ``Layout()``."""

    data: int = 1
    model: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: Any = None
    model_group: Any = None

    @property
    def rank(self) -> int:
        return self.data_index * self.model + self.model_index


_LAYOUT: tuple | None = None  # (the world group it was made in, the layout)


def make_mesh(data: int | None = None, model: int = 1) -> Layout:
    """Lay the processes out on a ``(data, model)`` mesh and return this
    process's :class:`Layout`. ``data`` (``None``: ``world // model``) times
    ``model`` must be the world size, as the JAX package's ``make_mesh``
    asserts. Every rank calls it with the same arguments: it creates the
    data groups and the model groups, every rank every group in one order.
    The layout is kept, and :func:`current_layout` returns it."""
    global _LAYOUT
    world = get_world_size()
    model = int(model or 1)
    if model < 1 or world % model:
        raise ValueError(f"mesh_model={model} does not divide the {world} processes")
    data = world // model if data is None else int(data)
    if data * model != world:
        raise ValueError(f"mesh_data={data} x mesh_model={model} needs {data * model} "
                         f"processes, the world has {world}")
    if _LAYOUT is not None and _LAYOUT[0] is _world_group() and (
            _LAYOUT[1].data, _LAYOUT[1].model) == (data, model):
        return _LAYOUT[1]
    d, m = divmod(get_rank(), model)
    data_group = model_group = None
    if data > 1 and model > 1:
        model_groups = [dist.new_group([i * model + j for j in range(model)]) for i in range(data)]
        data_groups = [dist.new_group([i * model + j for i in range(data)]) for j in range(model)]
        data_group, model_group = data_groups[m], model_groups[d]
    elif data > 1:
        data_group = dist.group.WORLD
    elif model > 1:
        model_group = dist.group.WORLD
    layout = Layout(data, model, d, m, data_group, model_group)
    _LAYOUT = (_world_group(), layout)
    return layout


def _world_group():
    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def current_layout() -> Layout:
    """The layout :func:`make_mesh` made in this process group, else data
    parallelism over every process (``make_mesh()``)."""
    if _LAYOUT is not None and _LAYOUT[0] is _world_group():
        return _LAYOUT[1]
    return make_mesh()


def process_allgather_objects(obj, group=None) -> list:
    """Every process's ``obj`` (of ``group``, by default every process), in
    rank order (``all_gather_object``); the identity in one process, where
    no collective is issued."""
    world = get_world_size() if group is None else dist.get_world_size(group)
    if world == 1:
        return [obj]
    out = [None] * world
    dist.all_gather_object(out, obj, group=group)
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
def replicate(module: torch.nn.Module, layout: Layout | None = None) -> torch.nn.Module:
    """Broadcast the parameters and buffers of the first rank of this
    process's data group to the group, in place (``layout``: the current
    one); a no-op where the data group is one process. Under tensor
    parallelism each model shard's slices come from its own first rank."""
    layout = layout or current_layout()
    if layout.data > 1:
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, layout.model_index, group=layout.data_group)
    return module
