"""Train state and the train / eval / inference steps (port of
``vibertgrid_tpu/train/state.py``).

A step is plain eager PyTorch: forward, backward, the conditional gradient
clip, both optimizer updates and the BatchNorm statistics. Unlike the JAX
package's pure step, it updates the model and the optimizer state **in
place** and returns the same :class:`TrainState` object. Nothing in a step
reads a value back from the device: the clip decision is a ``torch.where``
on the device, the schedules are indexed by a host counter, and the loss is
returned as a 0-d tensor the caller may fetch when it wants to.

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

import contextlib
import dataclasses

import torch
import torch.distributed as dist

from vibertgrid_tpu_torch.models.vibertgrid import Batch, ViBERTgridNet
from vibertgrid_tpu_torch.parallel.collectives import average_gradients, global_batch
from vibertgrid_tpu_torch.parallel.mesh import Layout, current_layout
from vibertgrid_tpu_torch.parallel.sharding import param_shardings, reduce_scatter_mean
from vibertgrid_tpu_torch.train.optim import DualOptimizer


@dataclasses.dataclass
class TrainState:
    model: ViBERTgridNet       # parameters and BatchNorm statistics
    optimizer: DualOptimizer   # momentum / Adam moments and the schedules' index
    step: int = 0


def create_train_state(model: ViBERTgridNet, optimizer: DualOptimizer) -> TrainState:
    return TrainState(model=model, optimizer=optimizer, step=0)


def _squares(grads) -> torch.Tensor | None:
    grads = list(grads)
    if not grads:
        return None
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


def apply_gradients(optimizer: DualOptimizer, loss: torch.Tensor, parallel: bool,
                    loss_clip_tresh: float, clip_norm: float,
                    layout: Layout | None = None, split=frozenset()) -> None:
    """The train step after its backward: with ``parallel``, the gradients
    averaged over the data group of ``layout`` (by default the current one;
    under ZeRO-1 those of the split parameters reduce-scattered), then the
    clip and both updates. ``split``: the parameters that tensor parallelism
    splits (:func:`~vibertgrid_tpu_torch.parallel.sharding.param_shardings`)."""
    layout = layout or (current_layout() if parallel else Layout())
    grads = {p: p.grad for g in optimizer.param_groups for p in g["params"]
             if p.grad is not None}
    whole = {p: g for p, g in grads.items() if p not in optimizer.shards}
    owned = {}
    if parallel and layout.data > 1:
        average_gradients(list(whole.values()), layout.data_group)
        zero = {p: g for p, g in grads.items() if p in optimizer.shards}
        reduce_scatter_mean(zero, optimizer.shards, layout.data_group)
        owned = {p: optimizer._owned(g, p) for p, g in zero.items()}
    # whole gradients and ZeRO-1 slices, those of the split parameters apart
    scale = clip_scale(
        loss, [g for p, g in whole.items() if p not in split], loss_clip_tresh, clip_norm,
        [o for p, o in owned.items() if p not in split],
        split=[g for p, g in whole.items() if p in split],
        split_owned=[o for p, o in owned.items() if p in split], layout=layout)
    optimizer.step(grad_scale=scale)


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


def make_train_step(loss_clip_tresh: float = 10.0, clip_norm: float = 2.0):
    """``train_step(state, batch, seeds) -> (state, loss)``: one update of
    ``state`` in place. ``seeds``: the step's seed stream (``next() -> int``)
    for the dropout sites and the sampled losses. Clipping reproduces the
    reference's "clip when the loss spikes" rule. With a process group (made
    before this is called) the step is data-parallel over its data group,
    each data rank passing its share of the global batch and every rank the
    same seeds; the layout is the model's (``ModelConfig.mesh``) where it has
    one, else :func:`~vibertgrid_tpu_torch.parallel.mesh.current_layout`."""
    parallel = dist.is_available() and dist.is_initialized()

    def train_step(state: TrainState, batch: Batch, seeds):
        model, optimizer = state.model, state.optimizer
        layout = model.config.mesh or (current_layout() if parallel else None)
        split = frozenset(p for p, ax in param_shardings(model, layout).items()
                          if ax is not None)
        optimizer.zero_grad(set_to_none=True)
        with global_batch(parallel, layout), _replicas_agree(layout):
            out = model(batch, train=True, compute_loss=True, seeds=seeds)
            loss = out.total_loss
            loss.backward()
        apply_gradients(optimizer, loss, parallel, loss_clip_tresh, clip_norm, layout, split)
        state.step += 1
        return state, loss.detach()

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
