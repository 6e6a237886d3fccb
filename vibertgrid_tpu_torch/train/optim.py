"""Dual optimizer: SGD for the CNN side, AdamW for BERT (port of
``vibertgrid_tpu/train/optim.py``).

Parameters whose name contains the ``bert_model`` module go to AdamW,
everything else to SGD with momentum (torch-style coupled weight decay: the
decay is added to the gradient before the momentum). Learning rates and
weight decays follow per-iteration schedule arrays (StepLR every 15 epochs
× 0.1, cosine weight decay), indexed by a host step counter.

The momentum buffer and the Adam moments are *stored* in
``optimizer_state_dtype`` (bf16 by default); the arithmetic is fp32 and the
state is cast once on write. The updates run as ``torch._foreach_*`` passes
over each group's tensor lists.

Under ZeRO-1 (:func:`vibertgrid_tpu_torch.parallel.sharding.shard_optimizer_state`)
each rank keeps the state of its slices of the large parameters only,
updates those slices (from gradients of which only those slices are
reduced), and the ranks of the data group then all-gather the updated
slices. Under tensor parallelism the parameters are this rank's slices
already, and so are their states.
"""

from __future__ import annotations

import numpy as np
import torch

from vibertgrid_tpu_torch.parallel.sharding import all_gather_slices
from vibertgrid_tpu_torch.train.schedules import (
    cosine_scheduler,
    schedule_value,
    step_scheduler,
)


def param_group_label(name: str) -> str:
    """'bert' for parameters under the ``bert_model`` module, else 'cnn'."""
    return "bert" if "bert_model" in name.split(".") else "cnn"


def _f32(tensors):
    return [t.float() for t in tensors]


def _store(states, values):
    torch._foreach_copy_(states, values)  # casts to the state dtype on write


class DualOptimizer(torch.optim.Optimizer):
    """SGD (group ``cnn``) and AdamW (group ``bert``) with scheduled learning
    rate and weight decay.

    ``step(grad_scale)`` applies one update from the parameters' ``.grad``;
    ``grad_scale`` (a 0-d tensor or None) multiplies every gradient first,
    which is how the train step applies its conditional clip without
    reading anything back from the device.
    """

    def __init__(self, named_parameters, schedules: dict, *, momentum: float = 0.9,
                 beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
                 state_dtype: torch.dtype | None = torch.bfloat16):
        groups = {"cnn": [], "bert": []}
        for name, p in named_parameters:
            if p.requires_grad:
                groups[param_group_label(name)].append(p)
        super().__init__(
            [dict(params=groups["cnn"], kind="cnn"), dict(params=groups["bert"], kind="bert")],
            defaults={},
        )
        self.schedules = schedules
        self.momentum, self.beta1, self.beta2, self.eps = momentum, beta1, beta2, eps
        self.state_dtype = state_dtype
        self.count = 0  # updates applied so far: the schedules' index
        self.shards: dict = {}  # ZeRO-1: {param: (axis, start, length)} this rank owns
        self.group = None  # ZeRO-1: the data group the slices are exchanged over
        for group in self.param_groups:
            for p in group["params"]:
                zeros = lambda: torch.zeros_like(p, dtype=state_dtype or p.dtype)
                if group["kind"] == "cnn":
                    self.state[p] = {"momentum": zeros()}
                else:
                    self.state[p] = {"mu": zeros(), "nu": zeros()}

    def _sgd(self, owners, params, grads, lr: float, wd: float):
        bufs = [self.state[p]["momentum"] for p in owners]
        g = torch._foreach_add(grads, params, alpha=wd)      # grad + wd·p
        buf = torch._foreach_mul(_f32(bufs), self.momentum)  # momentum·b + g
        torch._foreach_add_(buf, g)
        torch._foreach_add_(params, buf, alpha=-lr)
        _store(bufs, buf)

    def _adamw(self, owners, params, grads, lr: float, wd: float):
        b1, b2 = self.beta1, self.beta2
        mus = [self.state[p]["mu"] for p in owners]
        nus = [self.state[p]["nu"] for p in owners]
        mu = torch._foreach_mul(_f32(mus), b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        nu = torch._foreach_mul(_f32(nus), b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        # bias corrections in fp32, as the JAX package computes them
        count = np.float32(self.count + 1)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** count)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** count)
        # u = (mu / bc1) / (sqrt(nu / bc2) + eps); p -= lr·(u + wd·p)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, params, alpha=wd)
        torch._foreach_add_(params, upd, alpha=-lr)
        _store(mus, mu)
        _store(nus, nu)

    def _owned(self, t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``t`` (a parameter or its gradient): all of it
        unless ZeRO-1 split ``p``'s state."""
        if p not in self.shards:
            return t
        ax, start, length = self.shards[p]
        return t.narrow(ax, start, length)

    def set_shards(self, shards: dict, group=None) -> None:
        """ZeRO-1: keep only the slices ``{param: (axis, start, length)}`` of
        the named parameters' state, and update only those slices; the
        updated slices are exchanged over ``group`` (the data group; by
        default every process)."""
        for p, (ax, start, length) in shards.items():
            self.state[p] = {k: v.narrow(ax, start, length).clone()
                             for k, v in self.state[p].items()}
        self.shards = dict(shards)
        self.group = group

    def gathered_state(self) -> dict:
        """``{param: {slot: whole tensor}}``: the state as one process holds
        it, the ZeRO-1 slices gathered from every rank (a collective when the
        state is split)."""
        out = {p: dict(st) for p, st in self.state.items()}
        if self.shards:
            slots = {slot for p in self.shards for slot in self.state[p]}
            for slot in sorted(slots):
                whole = all_gather_slices({p: self.state[p][slot] for p in self.shards
                                           if slot in self.state[p]}, self.shards,
                                          group=self.group)
                for p, t in whole.items():
                    out[p][slot] = t
        return out

    @torch.no_grad()
    def step(self, grad_scale: torch.Tensor | None = None):
        for group in self.param_groups:
            kind = group["kind"]
            owners = [p for p in group["params"] if p.grad is not None]
            if not owners:
                continue
            params = [self._owned(p, p) for p in owners]
            grads = _f32([self._owned(p.grad, p) for p in owners])
            if grad_scale is not None:
                grads = torch._foreach_mul(grads, grad_scale)
            lr = schedule_value(self.schedules[f"lr_{kind}"], self.count)
            wd = schedule_value(self.schedules[f"wd_{kind}"], self.count)
            (self._sgd if kind == "cnn" else self._adamw)(owners, params, grads, lr, wd)
        if self.shards:  # every rank takes the others' updated slices
            all_gather_slices({p: self._owned(p, p) for p in self.shards}, self.shards,
                              out={p: p for p in self.shards}, group=self.group)
        self.count += 1

    _OWN = ("schedules", "momentum", "beta1", "beta2", "eps", "state_dtype", "count", "shards",
            "group")

    def __getstate__(self):  # the base class keeps only its own fields
        state = super().__getstate__()
        state.update({name: getattr(self, name) for name in self._OWN})
        return state

    def load_named_state(self, named_parameters, named_state: dict, count: int = 0):
        """Set the momentum / moment slots by parameter name (as
        :func:`vibertgrid_tpu_torch.convert.optimizer_state_from_optax`
        returns them, whole tensors; under ZeRO-1 this rank's slices are
        taken) and the schedules' index."""
        for name, p in named_parameters:
            for slot, value in named_state.get(name, {}).items():
                value = self._owned(value, p)
                self.state[p][slot].copy_(value.to(self.state[p][slot].device))
        self.count = count


def make_optimizer(hyp: dict, num_epochs: int, niter_per_ep: int, named_parameters,
                   return_schedules: bool = False):
    """Build the dual optimizer from a reference-compatible YAML dict
    (``optimizer_cnn_hyp``, ``optimizer_bert_hyp``, ``lr_steps`` or
    ``lr_step_size``/``lr_gamma``, ``optimizer_state_dtype``).

    The learning rates follow a recurring ×``lr_gamma`` decay every
    ``lr_step_size`` (15) epochs, the weight decays a cosine.
    ``return_schedules=True`` also returns the per-iteration arrays
    ``{"lr_cnn", "wd_cnn", "lr_bert", "wd_bert"}``."""
    cnn = hyp["optimizer_cnn_hyp"]
    bert = hyp["optimizer_bert_hyp"]
    sd_name = hyp.get("optimizer_state_dtype", "bfloat16")
    state_dtype = None if sd_name in ("float32", "fp32") else getattr(torch, sd_name)

    gamma = float(hyp.get("lr_gamma", 0.1))
    if hyp.get("lr_steps") is not None:
        milestones = [int(s) for s in hyp["lr_steps"]]
    else:
        step_size = int(hyp.get("lr_step_size", 15))
        milestones = list(range(step_size, num_epochs, step_size)) or [num_epochs]

    def lr(group):
        return step_scheduler(
            base_value=group["learning_rate"], steps=milestones, gamma=gamma,
            num_epoches=num_epochs, niter_per_ep=niter_per_ep,
            warmup_epoches=group.get("warm_up_epoches", 0),
            start_warmup_value=group.get("warm_up_init_lr", 0.0),
        )

    def wd(group):
        return cosine_scheduler(
            base_value=group["weight_decay"], final_value=group["min_weight_decay"],
            epoches=num_epochs, niter_per_ep=niter_per_ep,
        )

    schedules = {"lr_cnn": lr(cnn), "wd_cnn": wd(cnn), "lr_bert": lr(bert), "wd_bert": wd(bert)}
    optimizer = DualOptimizer(
        named_parameters, schedules, momentum=cnn.get("momentum", 0.9),
        beta1=bert.get("beta1", 0.9), beta2=bert.get("beta2", 0.999),
        eps=bert.get("epsilon", 1e-8), state_dtype=state_dtype,
    )
    if return_schedules:
        return optimizer, schedules
    return optimizer
