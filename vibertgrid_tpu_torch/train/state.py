"""Train state and the train / eval / inference steps (port of
``vibertgrid_tpu/train/state.py``).

A step is forward, backward, the conditional gradient clip, both optimizer
updates and the BatchNorm statistics. Unlike the JAX package's pure step, it
updates the model and the optimizer state **in place** and returns the same
:class:`TrainState` object. Nothing in a step reads a value back from the
device or copies one from the host but its seeds: the clip decision is a
``torch.where`` on the device, the dropout sites and the sampled losses read
the step's seeds from one int32 tensor uploaded from pinned memory
(:class:`~vibertgrid_tpu_torch.train.seeds.DeviceSeeds`), the optimizer reads
its learning rates, weight decays and bias corrections from a device table
at a device counter, and the loss is returned as a 0-d tensor the caller
may fetch when it wants to.

On the card, in one process, each batch shape's whole step is one CUDA
graph: the first step of a shape runs eagerly on a side stream (its real
update, and the warm-up of the libraries' choices and workspaces), then the
same body is captured for that shape without running; every later step of
the shape copies its batch into the graph's inputs, uploads its seeds and
replays the graph, with at most two replays in flight. The graphs share one
memory pool and one set of gradient buffers, which each graph copies its
gradients to after its backward and a replay hands to the parameters'
``.grad``, as an eager step leaves them; so a graph holds only its inputs
and its loss. At most 32 graphs are made; the shapes first seen after that
run eagerly (replacing graphs as shapes come and go cost more captures
than the replays saved, on the driver's multi-scale batches). CPU steps
and steps under a process group (data or tensor parallelism, whose
collectives run inside the step) stay eager; all take the same values.
Under a profiler the step records its ranges (``train_step`` with
``forward``, ``backward`` and ``optimizer``;
:mod:`vibertgrid_tpu_torch.utils.profiling`), the ``train_step`` range
marked ``replayed``, ``captured`` or ``eager``, the ``optimizer`` range with
the share of the update that the hand-written launch took (on the card the
clip's sum of squares and both updates are one launch each,
:mod:`vibertgrid_tpu_torch.ops.fused_update`). A replayed step's inner
ranges carry the device intervals its graph's timing events measure, and no
host interval: the host issues nothing for them. The syncs its thread
makes are counted, which tests that claim.

When a process group exists, the train step is the data-parallel one: the
forward and backward run inside
:func:`~vibertgrid_tpu_torch.parallel.collectives.global_batch`, so the loss
is the global batch's (the same value on every rank), and the gradients are
averaged over the data group before the clip reads them (under ZeRO-1 those
of the split parameters are reduce-scattered: each rank receives the mean of
the slices it updates); every rank then takes the same clip decision and
the same update. Under tensor parallelism (the model's layout has a model
axis above 1) the encoder's split parameters hold this rank's slices and
their gradients are this rank's slices of the whole gradients; the
replicated parameters' gradients are the same on every rank of a model
group, which computes them from the same values.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import weakref

import torch
import torch.distributed as dist

from vibertgrid_tpu_torch.models.vibertgrid import Batch, ViBERTgridNet
from vibertgrid_tpu_torch.ops import fused_update, kernels
from vibertgrid_tpu_torch.parallel.collectives import average_gradients, global_batch
from vibertgrid_tpu_torch.parallel.mesh import Layout, current_layout
from vibertgrid_tpu_torch.parallel.sharding import param_shardings, reduce_scatter_mean
from vibertgrid_tpu_torch.train.optim import DualOptimizer
from vibertgrid_tpu_torch.train.seeds import DeviceSeeds, upload
from vibertgrid_tpu_torch.utils import profiling
from vibertgrid_tpu_torch.utils.profiling import span

_RUN_AHEAD = 2  # replays in flight at most
_GRAPHS = 32    # graphs kept at most


@dataclasses.dataclass
class TrainState:
    model: ViBERTgridNet       # parameters and BatchNorm statistics
    optimizer: DualOptimizer   # momentum / Adam moments and the schedules' index
    step: int = 0


def create_train_state(model: ViBERTgridNet, optimizer: DualOptimizer) -> TrainState:
    return TrainState(model=model, optimizer=optimizer, step=0)


def _squares(grads) -> torch.Tensor | None:
    """``Σ g²`` over every element of ``grads``, a 0-d fp64 tensor (None for
    no gradient): on the card one hand-written launch
    (:func:`~vibertgrid_tpu_torch.ops.fused_update.grad_sq_norm`, fp32
    gradients, else it raises), on the CPU the library's fp64 norms."""
    grads = list(grads)
    if not grads:
        return None
    if grads[0].is_cuda:
        return fused_update.grad_sq_norm(grads)
    return torch.stack(torch._foreach_norm(grads, dtype=torch.float64)).square().sum()


def clip_scale(loss: torch.Tensor, grads, loss_clip_tresh: float, clip_norm: float,
               owned=(), *, split=(), split_owned=(), layout: Layout | None = None):
    """The factor of the conditional clip, on the device: ``clip_norm /
    gnorm`` when the loss spiked above ``loss_clip_tresh`` **and** the global
    gradient norm exceeds ``clip_norm``, else 1. ``grads``: the whole
    gradients, the same on every rank. ``owned``: under ZeRO-1, this rank's
    slices of the split parameters' gradients, whose squares the data group
    sums into the norm (one all-reduce of a scalar). Under tensor
    parallelism, ``split`` holds this rank's slices of the encoder's split
    gradients and ``split_owned`` their ZeRO-1 slices: the model group sums
    their squares, so that each whole gradient counts once and each
    replicated one once. The norm is accumulated in float64, so that it does
    not depend on how the gradients are split (in float32 the host's sums
    differ by ~1e-4)."""
    layout = layout or Layout()
    sq = _squares(grads)
    if sq is None:
        sq = torch.zeros((), dtype=torch.float64, device=loss.device)
    if owned:
        part = _squares(owned)
        dist.all_reduce(part, group=layout.data_group)
        sq = sq + part
    if split or split_owned:
        part = _squares(split)
        if split_owned:  # the ZeRO-1 slices over the data group, then all over the model group
            slices = _squares(split_owned)
            dist.all_reduce(slices, group=layout.data_group)
            part = slices if part is None else part + slices
        dist.all_reduce(part, group=layout.model_group)
        sq = sq + part
    gnorm = sq.sqrt().float()
    clip = (loss.detach() > loss_clip_tresh) & (gnorm > clip_norm)
    return torch.where(clip, clip_norm / gnorm.clamp(min=1e-12), 1.0)


def _clip_lists(optimizer: DualOptimizer, owned: dict, split) -> tuple:
    """:func:`clip_scale`'s gradients: the whole ones and the ZeRO-1 slices
    ``owned``, each of the parameters that ``split`` does not hold and of
    those it does."""
    whole = {p: p.grad for g in optimizer.param_groups for p in g["params"]
             if p.grad is not None and p not in optimizer.shards}
    return ([g for p, g in whole.items() if p not in split],
            [o for p, o in owned.items() if p not in split],
            [g for p, g in whole.items() if p in split],
            [o for p, o in owned.items() if p in split])


def apply_gradients(optimizer: DualOptimizer, loss: torch.Tensor, parallel: bool,
                    loss_clip_tresh: float, clip_norm: float,
                    layout: Layout | None = None, split=frozenset()) -> None:
    """The train step after its backward: with ``parallel``, the gradients
    averaged over the data group of ``layout`` (by default the current one;
    under ZeRO-1 those of the split parameters reduce-scattered), then the
    clip and both updates. ``split``: the parameters that tensor parallelism
    splits (:func:`~vibertgrid_tpu_torch.parallel.sharding.param_shardings`)."""
    layout = layout or (current_layout() if parallel else Layout())
    owned = {}
    if parallel and layout.data > 1:
        grads = {p: p.grad for g in optimizer.param_groups for p in g["params"]
                 if p.grad is not None}
        average_gradients([g for p, g in grads.items() if p not in optimizer.shards],
                          layout.data_group)
        zero = {p: g for p, g in grads.items() if p in optimizer.shards}
        reduce_scatter_mean(zero, optimizer.shards, layout.data_group)
        owned = {p: optimizer._owned(g, p) for p, g in zero.items()}
    whole, owned_rest, split_whole, split_owned = _clip_lists(optimizer, owned, split)
    scale = clip_scale(loss, whole, loss_clip_tresh, clip_norm, owned_rest, split=split_whole,
                       split_owned=split_owned, layout=layout)
    optimizer.step(grad_scale=scale)


def prepare_update(optimizer: DualOptimizer, split=frozenset()) -> list:
    """The descriptor lists that the clip's norm and the update of a step
    without a process group launch on, for the gradients the parameters hold
    now, built where they are not cached: a CUDA graph capture of the step
    finds them (a capture copies nothing from the host), and the caller keeps
    them for as long as the graph."""
    lists = [fused_update.norm_list(grads) for grads in _clip_lists(optimizer, {}, split)
             if grads and grads[0].is_cuda]
    return lists + [optimizer.prepare()]


def _replicas_agree(layout: Layout | None):
    """Under tensor parallelism every rank of a model group computes the
    replicated layers (the CNN, the heads, the losses) itself, and their
    parameters must stay bit-equal: the step runs cuDNN's deterministic
    convolution algorithms (a flag, scoped to the step: no formulation
    chooses cuDNN's algorithm). Otherwise fp32 backwards may add with
    atomics, whose order two ranks sharing a card see differently."""
    if layout is None or layout.model == 1:
        return contextlib.nullcontext()
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=c.benchmark, benchmark_limit=c.benchmark_limit,
                   deterministic=True, allow_tf32=c.allow_tf32)


class _Counted:
    """A seed stream that counts its draws: a model's first step learns how
    many seeds a step draws."""

    def __init__(self, seeds):
        self.seeds, self.drawn = seeds, 0

    def next(self) -> int:
        self.drawn += 1
        return self.seeds.next()


@dataclasses.dataclass
class _Graph:
    """One batch shape's captured step and the tensors it reads and writes."""

    graph: torch.cuda.CUDAGraph
    batch: Batch            # the static inputs, refilled before each replay
    seeds: torch.Tensor     # [n] int32, the static seeds, refilled likewise
    loss: torch.Tensor      # the static loss, written by each replay
    grads: list             # (parameter, the shared buffer its gradient goes to, or None)
    table: torch.Tensor     # the optimizer's schedule table the graph reads
    marks: profiling.Marks  # the timing events of its ranges
    fused_share: float      # the optimizer's fused_share at the captured update
    lists: list             # the descriptor lists its clip and update read


def _signature(state: TrainState, batch: Batch) -> tuple:
    return (id(state.model), id(state.optimizer)) + tuple(
        (tuple(t.shape), t.dtype) for t in (getattr(batch, f.name)
                                           for f in dataclasses.fields(batch)))


def make_train_step(loss_clip_tresh: float = 10.0, clip_norm: float = 2.0):
    """``train_step(state, batch, seeds) -> (state, loss)``: one update of
    ``state`` in place. ``seeds``: the step's seed stream (``next() -> int``)
    for the dropout sites and the sampled losses. Clipping reproduces the
    reference's "clip when the loss spikes" rule. With a process group (made
    before this is called) the step is data-parallel over its data group,
    each data rank passing its share of the global batch and every rank the
    same seeds; the layout is the model's (``ModelConfig.mesh``) where it has
    one, else :func:`~vibertgrid_tpu_torch.parallel.mesh.current_layout`.

    On the card without a process group each batch shape's step becomes a
    CUDA graph after its first sight (see the module docstring); the loss
    returned is the caller's own tensor, which later steps do not touch."""
    parallel = dist.is_available() and dist.is_initialized()
    draws = weakref.WeakKeyDictionary()  # model -> seeds a step draws
    graphs: dict = {}   # batch signature -> _Graph
    buffers: dict = {}  # parameter -> the gradient buffer every graph writes
    inflight: collections.deque = collections.deque()
    side = pool = None

    def placement(model: ViBERTgridNet) -> tuple:
        """The model's layout and the parameters it splits."""
        layout = model.config.mesh or (current_layout() if parallel else None)
        return layout, frozenset(p for p, ax in param_shardings(model, layout).items()
                                 if ax is not None)

    def body(state: TrainState, batch: Batch, seeds, into: dict | None = None) -> torch.Tensor:
        """The step. ``into``: buffers ``{parameter: tensor}`` that the
        gradients are copied to after the backward, and read from after."""
        model, optimizer = state.model, state.optimizer
        layout, split = placement(model)
        optimizer.zero_grad(set_to_none=True)
        with global_batch(parallel, layout), _replicas_agree(layout):
            out = model(batch, train=True, compute_loss=True, seeds=seeds)
            loss = out.total_loss
            with span("backward"):
                loss.backward()
        if into is not None:
            got = [p for g in optimizer.param_groups for p in g["params"] if p.grad is not None]
            if any(p not in into for p in got):
                raise RuntimeError("the step gave a gradient to a parameter with no buffer")
            torch._foreach_copy_([into[p] for p in got], [p.grad for p in got])
            for p in got:
                p.grad = into[p]
        with span("optimizer") as record:
            apply_gradients(optimizer, loss, parallel, loss_clip_tresh, clip_norm, layout, split)
            if record is not None:
                record.fused_share = optimizer.fused_share
        return loss.detach()

    def eager(state: TrainState, batch: Batch, seeds) -> torch.Tensor:
        """The body with the step's seeds on the device once the model's
        number of draws is known, else with the stream's ints, counted."""
        model = state.model
        n = draws.get(model)
        if n is None:
            counted = _Counted(seeds)
            loss = body(state, batch, counted)
            draws[model] = counted.drawn
            return loss
        on_device = DeviceSeeds(upload(seeds, n, batch.images.device))
        loss = body(state, batch, on_device)
        if on_device.drawn != n:
            raise RuntimeError(f"the step drew {on_device.drawn} seeds, not {n}")
        return loss

    def capture(state: TrainState, batch: Batch) -> _Graph:
        """Capture the body for ``batch``'s shape without running it, right
        after an eager step of that shape, whose gradients are handed back
        after. The gradients the graph makes in its pool are copied to
        buffers that every graph shares, made outside the pool for the
        parameters that eager step gave a gradient."""
        nonlocal pool
        optimizer = state.optimizer
        dev = batch.images.device
        params = [p for g in optimizer.param_groups for p in g["params"]]
        eager_grads = [p.grad for p in params]
        for p, grad in zip(params, eager_grads):
            if grad is not None and p not in buffers:
                buffers[p] = torch.empty_like(grad)
        static = Batch(**{f.name: torch.empty_like(getattr(batch, f.name))
                          for f in dataclasses.fields(batch)})
        slots = torch.empty(draws[state.model], dtype=torch.int32, device=dev)
        pool = pool if pool is not None else torch.cuda.graph_pool_handle()
        graph, marks = torch.cuda.CUDAGraph(), profiling.Marks()
        count, launched = optimizer.count, dict(kernels.LAUNCHES)
        side.wait_stream(torch.cuda.current_stream(dev))
        try:
            for p, grad in zip(params, eager_grads):  # the gradients the capture will hold
                p.grad = None if grad is None else buffers[p]
            with torch.cuda.stream(side), profiling.marking(marks):
                # the lists the captured clip and update read: a capture copies nothing in
                lists = prepare_update(optimizer, placement(state.model)[1])
                # thread-local: the loader's thread may pin and copy meanwhile
                graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    loss = body(state, static, DeviceSeeds(slots), into=buffers)
                except BaseException:
                    with contextlib.suppress(Exception):
                        graph.capture_end()
                    raise
                graph.capture_end()
            grads = [(p, p.grad) for p in params]
            fused_share = optimizer.fused_share
        finally:  # the capture ran nothing: no update, no launch
            optimizer.advance_host_count(count - optimizer.count)
            kernels.LAUNCHES.update(launched)
            for p, grad in zip(params, eager_grads):
                p.grad = grad
        torch.cuda.current_stream(dev).wait_stream(side)
        return _Graph(graph, static, slots, loss, grads, optimizer.table, marks, fused_share,
                      lists)

    def replay(state: TrainState, batch: Batch, seeds, entry: _Graph) -> torch.Tensor:
        """Refill the graph's inputs and replay it. Its kernels are not
        counted in ``kernels.LAUNCHES``: the host launches none of them."""
        dev = batch.images.device
        for f in dataclasses.fields(batch):
            getattr(entry.batch, f.name).copy_(getattr(batch, f.name))
        upload(seeds, entry.seeds.numel(), dev, out=entry.seeds)
        if len(inflight) >= _RUN_AHEAD:
            inflight.popleft().synchronize()
        for record in profiling.replay(entry.graph, entry.marks):
            if record.name == "optimizer":
                record.fused_share = entry.fused_share
        done = torch.cuda.Event()
        done.record()
        inflight.append(done)
        state.optimizer.advance_host_count(1)
        for p, grad in entry.grads:  # the step's gradients, as an eager step leaves them
            p.grad = grad
        return entry.loss.clone()

    def graphed(state: TrainState, batch: Batch, seeds) -> tuple[torch.Tensor, str]:
        nonlocal side, pool
        key = _signature(state, batch)
        entry = graphs.get(key)
        if entry is not None and entry.table is state.optimizer.table:
            return replay(state, batch, seeds, entry), "replayed"
        dev = batch.images.device
        side = side if side is not None else torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            loss = eager(state, batch, seeds)
        torch.cuda.current_stream(dev).wait_stream(side)
        loss.record_stream(torch.cuda.current_stream(dev))  # the caller reads it there
        if entry is None and len(graphs) >= _GRAPHS:
            return loss, "eager"  # the cache is full: later shapes stay eager
        if entry is not None:  # the optimizer's schedules were set anew
            while inflight:  # a graph is dropped only once no replay of it runs
                inflight.popleft().synchronize()
            del graphs[key]
            if not graphs:  # the pool went with its last graph
                pool = None
        graphs[key] = capture(state, batch)
        return loss, "captured"

    def train_step(state: TrainState, batch: Batch, seeds):
        with span("train_step", step=True) as record:
            if parallel or batch.images.device.type != "cuda":
                loss, mode = eager(state, batch, seeds), "eager"
            else:
                loss, mode = graphed(state, batch, seeds)
            if record is not None:
                record.mode = mode
            state.step += 1
            return state, loss

    return train_step


def normalize_uint8_images(images: torch.Tensor, sizes: torch.Tensor, mean, std):
    """The uint8 wire format: raw resized uint8 images ``[B, H, W, 3]`` are
    normalised on the device and the canvas padding beyond each sample's
    valid ``sizes [B, 2]`` (height, width) is set back to 0, so the model
    sees the layout of the fp32 path (pad after normalise)."""
    dev = images.device
    mean = torch.as_tensor(mean, dtype=torch.float32, device=dev)
    std = torch.as_tensor(std, dtype=torch.float32, device=dev)
    out = (images.float() / 255.0 - mean) / std
    h, w = images.shape[1], images.shape[2]
    valid = (torch.arange(h, device=dev)[None, :, None] < sizes[:, 0, None, None]) & (
        torch.arange(w, device=dev)[None, None, :] < sizes[:, 1, None, None])
    return torch.where(valid[..., None], out, 0.0)


def make_eval_step(image_stats=None):
    """``eval_step(state, batch) -> ModelOutput`` with the losses, in eval
    mode and without gradients. ``image_stats=(mean, std)`` selects the uint8
    wire format: ``eval_step(state, batch, sizes)`` takes uint8 images and
    normalises them on the device (:func:`normalize_uint8_images`)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch):
        return state.model(batch, train=False, compute_loss=True)

    if image_stats is None:
        return eval_step

    def eval_step_u8(state: TrainState, batch: Batch, sizes: torch.Tensor):
        images = normalize_uint8_images(batch.images, sizes, *image_stats)
        return eval_step(state, dataclasses.replace(batch, images=images))

    return eval_step_u8


def make_inference_step():
    """``inference_step(state, batch) -> pred_label [B, S, C]``."""

    @torch.no_grad()
    def inference_step(state: TrainState, batch: Batch):
        return state.model(batch, train=False, compute_loss=False).pred_label

    return inference_step
