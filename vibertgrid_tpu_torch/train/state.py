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
averaged over the ranks before the clip reads them (under ZeRO-1 those of
the split parameters are reduce-scattered: each rank receives the mean of
the slices it updates); every rank then takes the same clip decision and
the same update.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from vibertgrid_tpu_torch.models.vibertgrid import Batch, ViBERTgridNet
from vibertgrid_tpu_torch.parallel.collectives import average_gradients, global_batch
from vibertgrid_tpu_torch.parallel.sharding import reduce_scatter_mean
from vibertgrid_tpu_torch.train.optim import DualOptimizer


@dataclasses.dataclass
class TrainState:
    model: ViBERTgridNet       # parameters and BatchNorm statistics
    optimizer: DualOptimizer   # momentum / Adam moments and the schedules' index
    step: int = 0


def create_train_state(model: ViBERTgridNet, optimizer: DualOptimizer) -> TrainState:
    return TrainState(model=model, optimizer=optimizer, step=0)


def clip_scale(loss: torch.Tensor, grads, loss_clip_tresh: float, clip_norm: float,
               owned=()):
    """The factor of the conditional clip, on the device: ``clip_norm /
    gnorm`` when the loss spiked above ``loss_clip_tresh`` **and** the global
    gradient norm exceeds ``clip_norm``, else 1. ``owned``: under ZeRO-1,
    this rank's slices of the split parameters' gradients, whose squares
    the ranks sum into the norm (one all-reduce of a scalar). The norm is
    accumulated in float64, so that it does not depend on how the
    gradients are split (in float32 the host's sums differ by ~1e-4)."""
    sq = torch.stack(torch._foreach_norm(grads, dtype=torch.float64)).square().sum()
    if owned:
        part = torch.stack(torch._foreach_norm(list(owned), dtype=torch.float64)).square().sum()
        dist.all_reduce(part)
        sq = sq + part
    gnorm = sq.sqrt().float()
    clip = (loss.detach() > loss_clip_tresh) & (gnorm > clip_norm)
    return torch.where(clip, clip_norm / gnorm.clamp(min=1e-12), 1.0)


def apply_gradients(optimizer: DualOptimizer, loss: torch.Tensor, parallel: bool,
                    loss_clip_tresh: float, clip_norm: float) -> None:
    """The train step after its backward: with ``parallel``, the gradients
    averaged over the ranks (under ZeRO-1 those of the split parameters
    reduce-scattered), then the clip and both updates."""
    grads = {p: p.grad for g in optimizer.param_groups for p in g["params"]
             if p.grad is not None}
    whole = [g for p, g in grads.items() if p not in optimizer.shards]
    owned = []
    if parallel:
        average_gradients(whole)
        owned = reduce_scatter_mean({p: g for p, g in grads.items()
                                     if p in optimizer.shards}, optimizer.shards)
    optimizer.step(grad_scale=clip_scale(loss, whole, loss_clip_tresh, clip_norm, owned))


def make_train_step(loss_clip_tresh: float = 10.0, clip_norm: float = 2.0):
    """``train_step(state, batch, seeds) -> (state, loss)``: one update of
    ``state`` in place. ``seeds``: the step's seed stream (``next() -> int``)
    for the dropout sites and the sampled losses. Clipping reproduces the
    reference's "clip when the loss spikes" rule. With a process group (made
    before this is called) the step is data-parallel over its ranks, each
    rank passing its share of the global batch and the same seeds."""
    parallel = dist.is_available() and dist.is_initialized()

    def train_step(state: TrainState, batch: Batch, seeds):
        model, optimizer = state.model, state.optimizer
        optimizer.zero_grad(set_to_none=True)
        with global_batch(parallel):
            out = model(batch, train=True, compute_loss=True, seeds=seeds)
            loss = out.total_loss
            loss.backward()
        apply_gradients(optimizer, loss, parallel, loss_clip_tresh, clip_norm)
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
