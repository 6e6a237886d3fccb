"""The train step's clip norm and dual update as two hand-written launches
(``csrc/fused_update.cu``), each over a list of tensors on the card.

- :func:`grad_sq_norm`: the sum of the squares of a list of fp32 gradients,
  accumulated in fp64, as a 0-d fp64 tensor (``train/state.py::_squares``).
- :func:`dual_update`: one SGD-with-momentum or AdamW update of every tensor
  of a list, each with its group's kind (``train/optim.py::DualOptimizer``).

They take every CUDA tensor of the update: fp32 parameters and gradients,
and state all bf16 or all fp32 (anything else raises), laid out in any
strides. A tensor is described by its *entry* (:func:`update_entry`,
:func:`norm_entry`): its flags, shape, and each operand's address and
strides. Each launch reads a descriptor list built from the
entries: an int64 tensor on the device of one row of ``ROW`` a contiguous
run that the operands of a tensor share (their addresses there, its length,
flags, first chunk: a contiguous tensor is one run, a ZeRO-1 slice along a
later axis one run a row of its leading axes), then one entry a chunk of
``CHUNK`` elements, the row it belongs to. A list is a function of its
entries alone, so :func:`descriptors` caches it by them (the most recently
used ``_KEEP``): storage at the same addresses reuses it, new gradients
build another. A list is built on the host and copied from pinned memory,
never while the stream is captured into a CUDA graph, where a list that is
not in the cache raises. So whoever captures builds the lists first, and
keeps them for as long as the graph, which reads them at every replay (the
train step: ``train/state.py::prepare_update``).
"""

from __future__ import annotations

import collections
import dataclasses
import functools

import numpy as np
import torch

from vibertgrid_tpu_torch.ops import kernels

CHUNK = 16384       # kChunk in csrc/fused_update.cu
NORM_BLOCKS = 1024  # kNormBlocks there
ROW = 8             # kRow there: 4 addresses, run length, flags, first chunk, 0
ADAMW, STATE_BF16, ALIGNED = 1, 2, 4
_KEEP = 16          # lists the cache keeps, the most recently used

_lists: collections.OrderedDict = collections.OrderedDict()  # entries -> TensorList


@dataclasses.dataclass(frozen=True)
class TensorList:
    table: torch.Tensor  # [n_rows · ROW + n_chunks] int64
    n_rows: int
    n_chunks: int


def _operand(t: torch.Tensor) -> tuple:
    return t.data_ptr(), t.stride()


def update_entry(param: torch.Tensor, grad: torch.Tensor, states, adamw: bool) -> tuple:
    """A tensor's entry for :func:`dual_update`. ``states``: the momentum
    (SGD) or the two moments (AdamW). Raises where the kernel cannot take
    it: a parameter or gradient that is not fp32, states not all bf16 or all
    fp32, operands of other shapes or on other devices."""
    kind, shape, dev = states[0].dtype, param.shape, param.get_device()
    if (param.dtype != torch.float32 or grad.dtype != torch.float32
            or kind not in (torch.bfloat16, torch.float32)):
        raise TypeError(f"the update kernel takes fp32 parameters and gradients and bf16 or "
                        f"fp32 state, not {param.dtype}, {grad.dtype} and {kind}")
    for t in (grad, *states):
        if t.dtype != kind and t is not grad:
            raise TypeError(f"the update kernel takes state all bf16 or all fp32, not "
                            f"{[s.dtype for s in states]}")
        if t.shape != shape or t.get_device() != dev:
            raise ValueError("the update kernel takes a parameter's gradient and state of its "
                             "shape on its device")
    flags = (ADAMW if adamw else 0) | (STATE_BF16 if kind == torch.bfloat16 else 0)
    return (flags, shape, _operand(param), _operand(grad), *map(_operand, states))


def norm_entry(grad: torch.Tensor) -> tuple:
    """A gradient's entry for :func:`grad_sq_norm` (fp32, else raises)."""
    if grad.dtype != torch.float32:
        raise TypeError(f"the norm kernel takes fp32 gradients, not {grad.dtype}")
    return (0, grad.shape, None, _operand(grad))


@functools.lru_cache(maxsize=4096)
def _dense(shape: tuple) -> tuple:
    """The strides of a contiguous tensor of ``shape``, and its elements."""
    strides, numel = [], 1
    for size in reversed(shape):
        strides.append(numel)
        numel *= size
    return tuple(reversed(strides)), numel


def _tail(shape: tuple, strides: tuple) -> int:
    """The elements of the longest run of trailing axes laid out
    contiguously (axes of size 1 whatever their stride)."""
    length = 1
    for size, stride in zip(reversed(shape), reversed(strides)):
        if size == 1:
            continue
        if stride != length:
            break
        length *= size
    return length


@functools.lru_cache(maxsize=256)
def _offsets(shape: tuple, strides: tuple, length: int) -> np.ndarray:
    """The element offsets of the starts of an operand's runs of ``length``
    elements: run r starts at its element ``r · length`` in the shape's
    order."""
    runs = _dense(shape)[1] // length
    offset, rest = np.zeros(runs, dtype=np.int64), np.arange(runs, dtype=np.int64) * length
    for extent, stride in zip(reversed(shape), reversed(strides)):
        offset += rest % extent * stride
        rest //= extent
    offset.flags.writeable = False
    return offset


def _runs(entry: tuple, numel: int) -> np.ndarray:
    """``[runs, 6]``: the rows of an entry whose operands are not all
    contiguous, one a run as long as the shortest contiguous tail of the
    operands."""
    flags, shape, *operands = entry
    shape = tuple(shape)
    length = min(_tail(shape, op[1]) for op in operands if op is not None)
    out = np.zeros((numel // length, 6), dtype=np.int64)
    sizes = _sizes(flags)
    for col, op in enumerate(operands):
        if op is not None:
            out[:, col] = op[0] + _offsets(shape, op[1], length) * sizes[col]
    out[:, 4] = length
    out[:, 5] = flags
    return out


def _sizes(flags: int) -> tuple:
    """The element sizes of a row's parameter, gradient and states."""
    return (4, 4) + (2 if flags & STATE_BF16 else 4,) * 2


def rows_of(entries) -> np.ndarray:
    """``[rows, 6]`` int64: the rows of the entries' runs (four addresses, 0
    for none, the run's length, flags), a contiguous tensor's one row first,
    then the runs of the others; flagged ``ALIGNED`` where every address
    admits the kernel's 4-element accesses."""
    single, strided = [], []
    for entry in entries:
        flags, shape, *operands = entry
        dense, numel = _dense(tuple(shape))
        if numel == 0:
            continue
        if all(op is None or op[1] == dense for op in operands):
            pointers = [0 if op is None else op[0] for op in operands]
            single.append((*pointers, *[0] * (4 - len(pointers)), numel, flags))
        else:
            strided.append(_runs(entry, numel))
    rows = np.concatenate([np.array(single, dtype=np.int64).reshape(-1, 6), *strided])
    state = 4 * np.where(rows[:, 5] & STATE_BF16, 2, 4)
    aligned = ((rows[:, 0] % 16 == 0) & (rows[:, 1] % 16 == 0) & (rows[:, 2] % state == 0)
               & (rows[:, 3] % state == 0))
    rows[:, 5] |= np.where(aligned, ALIGNED, 0)
    return rows


def build(entries: tuple, device) -> TensorList:
    """The descriptor list of ``entries`` on ``device``: each run's row with
    its first chunk, then each chunk's row; copied from pinned memory on
    CUDA."""
    rows = rows_of(entries)
    chunks = -(-rows[:, 4] // CHUNK)
    n = len(rows)
    host = np.zeros(n * ROW + int(chunks.sum()), dtype=np.int64)
    table = host[:n * ROW].reshape(n, ROW)
    table[:, :6] = rows
    table[:, 6] = np.cumsum(chunks) - chunks
    host[n * ROW:] = np.repeat(np.arange(n, dtype=np.int64), chunks)
    out = torch.from_numpy(host)
    device = torch.device(device)
    if device.type == "cuda":
        out = out.pin_memory().to(device, non_blocking=True)
    else:
        out = out.to(device)
    return TensorList(out, n, int(chunks.sum()))


def descriptors(entries, device) -> TensorList:
    """The list of ``entries``, from the cache or built (see the module's
    docstring); under CUDA graph capture only from the cache."""
    entries = tuple(entries)
    found = _lists.get(entries)
    if found is None:
        if torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a CUDA graph capture found no descriptor list for these tensors: "
                               "build it before the capture (train/state.py::prepare_update)")
        found = _lists[entries] = build(entries, device)
        while len(_lists) > _KEEP:
            _lists.popitem(last=False)
    _lists.move_to_end(entries)
    return found


def norm_list(grads: list) -> TensorList:
    """:func:`grad_sq_norm`'s descriptor list of ``grads`` (:func:`descriptors`)."""
    return descriptors([norm_entry(g) for g in grads], grads[0].device)


def grad_sq_norm(grads: list) -> torch.Tensor:
    """``Σ g²`` over every element of ``grads`` (fp32, on one CUDA device)
    as a 0-d fp64 tensor."""
    dev = grads[0].device
    if any(g.device != dev for g in grads):
        raise ValueError("the norm kernel takes gradients on one device")
    found = norm_list(grads)
    partials = torch.empty(NORM_BLOCKS, dtype=torch.float64, device=dev)
    out = torch.empty((), dtype=torch.float64, device=dev)
    kernels.LAUNCHES["grad_sq_norm"] += 1
    kernels.check(kernels.library().vg_grad_sq_norm(
        found.table.data_ptr(), found.n_rows, found.n_chunks, partials.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream), "grad_sq_norm")
    return out


def dual_update(entries: list, table: torch.Tensor, count: torch.Tensor,
                scale: torch.Tensor | None, *, momentum: float, beta1: float, beta2: float,
                eps: float) -> None:
    """One update of the tensors of ``entries`` (:func:`update_entry`, on
    ``table``'s device): the scalars of row ``min(count, last)`` of the
    optimizer's fp32 ``table`` ``[last + 1, 8]``, ``count`` its 0-d int64
    counter, ``scale`` the clip's 0-d fp32 factor or None."""
    dev = table.device
    if scale is not None and (scale.dim() != 0 or scale.dtype != torch.float32
                              or scale.device != dev):
        raise ValueError(f"the update kernel takes a 0-d fp32 clip factor on {dev}")
    found = descriptors(entries, dev)
    kernels.LAUNCHES["dual_update"] += 1
    kernels.check(kernels.library().vg_dual_update(
        found.table.data_ptr(), found.n_rows, found.n_chunks, table.data_ptr(),
        count.data_ptr(), table.shape[0] - 1, None if scale is None else scale.data_ptr(),
        momentum, beta1, 1.0 - beta1, beta2, 1.0 - beta2, eps,
        torch.cuda.current_stream(dev).cuda_stream), "dual_update")
