"""Dual optimizer: SGD for the CNN side, AdamW for BERT (port of
``vibertgrid_tpu/train/optim.py``).

Parameters whose name contains the ``bert_model`` module go to AdamW,
everything else to SGD with momentum (torch-style coupled weight decay: the
decay is added to the gradient before the momentum). Learning rates and
weight decays follow per-iteration schedule arrays (StepLR every 15 epochs
× 0.1, cosine weight decay).

The update's per-step scalars are rows of one fp32 table, computed once on
the host as the fp32 values the update has always used: the learning rates
(negated), the weight decays and Adam's two bias corrections, with their
reciprocals.

The momentum buffer and the Adam moments are *stored* in
``optimizer_state_dtype`` (bf16 by default); the arithmetic is fp32 and the
state is cast once on write. On the card, one hand-written launch updates
every tensor of both groups
(:func:`vibertgrid_tpu_torch.ops.fused_update.dual_update`: fp32 parameters
and gradients, bf16 or fp32 state, any strides; anything else raises),
reading this update's row of the table on the device, at a step counter
there that every update advances, so each replay of a captured train step
reads its own row. On the CPU the update runs as ``torch._foreach_*``
passes over each group's lists, with the row at ``count`` as host floats
(their ``alpha=`` and scalar forms); the launch computes each element with
those passes' operations and roundings, bit for bit. ``count`` is the
host's copy of the counter (checkpoints save it; setting it sets both).
``fused_share`` is the percentage of the last update's elements that the
launch took.

Under ZeRO-1 (:func:`vibertgrid_tpu_torch.parallel.sharding.shard_optimizer_state`)
each rank keeps the state of its slices of the large parameters only,
updates those slices (from gradients of which only those slices are
reduced), and the ranks of the data group then all-gather the updated
slices. Under tensor parallelism the parameters are this rank's slices
already, and so are their states.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vibertgrid_tpu_torch.ops import fused_update
from vibertgrid_tpu_torch.parallel.sharding import all_gather_slices
from vibertgrid_tpu_torch.train.schedules import cosine_scheduler, step_scheduler


def param_group_label(name: str) -> str:
    """'bert' for parameters under the ``bert_model`` module, else 'cnn'."""
    return "bert" if "bert_model" in name.split(".") else "cnn"


def _f32(tensors):
    return [t.float() for t in tensors]


def _store(states, values):
    torch._foreach_copy_(states, values)  # casts to the state dtype on write


# columns of DualOptimizer's table
_NEG_LR_CNN, _WD_CNN, _NEG_LR_BERT, _WD_BERT, _BC1, _BC2, _INV_BC1, _INV_BC2 = range(8)
_MAX_ROWS = 1 << 20
_SLOTS = {"cnn": ("momentum",), "bert": ("mu", "nu")}  # each group's state, in the kernel's order


@functools.lru_cache(maxsize=None)
def _bias_corrections(beta1: float, beta2: float) -> np.ndarray:
    """``[n, 4]`` fp32: Adam's ``1 − β1^(k+1)`` and ``1 − β2^(k+1)`` for
    update k, each a scalar fp32 power as the JAX package computes it, until
    both reach 1 (at most ``_MAX_ROWS`` rows), then their reciprocals."""
    b1, b2, one = np.float32(beta1), np.float32(beta2), np.float32(1.0)
    rows = []
    while len(rows) < _MAX_ROWS and (not rows or rows[-1] != (one, one)):
        count = np.float32(len(rows) + 1)
        rows.append((one - b1 ** count, one - b2 ** count))
    bc = np.array(rows, dtype=np.float32)
    out = np.concatenate([bc, (1.0 / bc.astype(np.float64)).astype(np.float32)], axis=1)
    out.flags.writeable = False
    return out


class DualOptimizer(torch.optim.Optimizer):
    """SGD (group ``cnn``) and AdamW (group ``bert``) with scheduled learning
    rate and weight decay.

    ``step(grad_scale)`` applies one update from the parameters' ``.grad``;
    ``grad_scale`` (a 0-d tensor or None; on the card fp32, on the
    parameters' device) multiplies every gradient first,
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
        self.momentum, self.beta1, self.beta2, self.eps = momentum, beta1, beta2, eps
        self.state_dtype = state_dtype
        params = groups["cnn"] + groups["bert"]
        device = params[0].device if params else torch.device("cpu")
        self._count = 0  # updates applied so far: the schedules' index
        self._count_t = torch.zeros((), dtype=torch.int64, device=device)
        self.schedules = schedules  # builds the table
        self.shards: dict = {}  # ZeRO-1: {param: (axis, start, length)} this rank owns
        self.group = None  # ZeRO-1: the data group the slices are exchanged over
        self.fused_share: float | None = None  # % of the last update's elements the launch took
        for group in self.param_groups:
            for p in group["params"]:
                zeros = lambda: torch.zeros_like(p, dtype=state_dtype or p.dtype)
                if group["kind"] == "cnn":
                    self.state[p] = {"momentum": zeros()}
                else:
                    self.state[p] = {"mu": zeros(), "nu": zeros()}

    @property
    def count(self) -> int:
        return self._count

    @count.setter
    def count(self, value: int) -> None:
        self._count = int(value)
        self._count_t.fill_(self._count)

    def advance_host_count(self, updates: int) -> None:
        """Move the host's count alone by ``updates``: a replayed CUDA graph
        of the train step advances the device counter itself, and a capture
        runs no update (``-1`` undoes the count its Python added)."""
        self._count += updates

    @property
    def table(self) -> torch.Tensor:
        """The schedule table the update reads: a new tensor whenever the
        schedules are set."""
        return self._table

    @property
    def schedules(self) -> dict:
        return self._schedules

    @schedules.setter
    def schedules(self, schedules: dict) -> None:
        """Set the schedule arrays and build the table the update reads: row
        ``n`` holds update ``n``'s ``-lr`` and ``wd`` of each group (the
        schedules' last value past their end), Adam's bias corrections
        ``1 − β^(n+1)`` in fp32, as the JAX package computes them, and their
        reciprocals. The rows run until the corrections reach 1, so the last
        row holds for every later update (at most ``_MAX_ROWS``)."""
        self._schedules = schedules
        corrections = _bias_corrections(float(self.beta1), float(self.beta2))
        rows = max(len(corrections), *(len(v) for v in schedules.values()))
        held = lambda a: np.pad(a, ((0, rows - len(a)),) + ((0, 0),) * (a.ndim - 1), mode="edge")
        table = np.empty((rows, 8), dtype=np.float32)
        for col, name, sign in ((_NEG_LR_CNN, "lr_cnn", -1), (_WD_CNN, "wd_cnn", 1),
                                (_NEG_LR_BERT, "lr_bert", -1), (_WD_BERT, "wd_bert", 1)):
            # schedule_value's fp32 value of each row; the sign flips exactly
            table[:, col] = sign * held(np.asarray(schedules[name]).astype(np.float32))
        table[:, _BC1:] = held(corrections)
        self._host_table = table
        self._table = torch.from_numpy(table).to(self._count_t.device)

    def _place(self, device) -> None:
        if self._count_t.device != device:
            self._count_t, self._table = self._count_t.to(device), self._table.to(device)

    def _row(self) -> list:
        """The passes' scalars: the table's row at ``count``, as host floats."""
        last = self._host_table.shape[0] - 1
        return [float(v) for v in self._host_table[min(self._count, last)]]

    def _sgd(self, owners, params, grads, neg_lr, wd):
        bufs = [self.state[p]["momentum"] for p in owners]
        g = torch._foreach_add(grads, params, alpha=wd)     # grad + wd·p
        buf = torch._foreach_mul(_f32(bufs), self.momentum)  # momentum·b + g
        torch._foreach_add_(buf, g)
        torch._foreach_add_(params, buf, alpha=neg_lr)
        _store(bufs, buf)

    def _adamw(self, owners, params, grads, neg_lr, wd, bc1, bc2):
        b1, b2 = self.beta1, self.beta2
        mus = [self.state[p]["mu"] for p in owners]
        nus = [self.state[p]["nu"] for p in owners]
        mu = torch._foreach_mul(_f32(mus), b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        nu = torch._foreach_mul(_f32(nus), b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        # u = (mu / bc1) / (sqrt(nu / bc2) + eps); p -= lr·(u + wd·p)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, params, alpha=wd)
        torch._foreach_add_(params, upd, alpha=neg_lr)
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

    def _items(self) -> list:
        """This update's tensors ``(kind, owner, parameter, gradient)``, the
        parameter and gradient this rank's slices."""
        return [(group["kind"], p, self._owned(p, p), self._owned(p.grad, p))
                for group in self.param_groups for p in group["params"] if p.grad is not None]

    def _entries(self, items: list, device) -> list:
        """The launch's entries of ``items``, all on ``device``
        (:func:`~vibertgrid_tpu_torch.ops.fused_update.update_entry`, which
        raises for what it cannot take)."""
        out = []
        for kind, p, param, grad in items:
            if param.device != device:
                raise ValueError(f"the update kernel takes tensors on one device, not {device} "
                                 f"and {param.device}")
            states = [self.state[p][slot] for slot in _SLOTS[kind]]
            out.append(fused_update.update_entry(param, grad, states, kind == "bert"))
        return out

    def prepare(self) -> fused_update.TensorList | None:
        """The launch's descriptor list for the gradients the parameters
        hold now, built where it is not cached: a CUDA graph capture of the
        update needs it (a capture copies nothing from the host), and the
        caller keeps it for as long as the graph. None where no tensor is
        on the card."""
        items = [item for item in self._items() if item[2].is_cuda]
        if not items:
            return None
        dev = items[0][2].device
        self._place(dev)
        return fused_update.descriptors(self._entries(items, dev), dev)

    @torch.no_grad()
    def _passes(self, items: list, grad_scale: torch.Tensor | None) -> None:
        """The update of ``items`` as ``torch._foreach_*`` passes over each
        group's lists: the CPU's update, and the launch's reference."""
        row = self._row()
        for kind in ("cnn", "bert"):
            chosen = [item for item in items if item[0] == kind]
            if not chosen:
                continue
            owners = [p for _, p, _, _ in chosen]
            params = [param for _, _, param, _ in chosen]
            grads = _f32([grad for _, _, _, grad in chosen])
            if grad_scale is not None:
                grads = torch._foreach_mul(grads, grad_scale)
            if kind == "cnn":
                self._sgd(owners, params, grads, row[_NEG_LR_CNN], row[_WD_CNN])
            else:
                self._adamw(owners, params, grads, row[_NEG_LR_BERT], row[_WD_BERT],
                            row[_BC1], row[_BC2])

    @torch.no_grad()
    def step(self, grad_scale: torch.Tensor | None = None):
        items = self._items()
        card = [item for item in items if item[2].is_cuda]
        host = [item for item in items if not item[2].is_cuda]
        if card:
            dev = card[0][2].device
            self._place(dev)
            fused_update.dual_update(
                self._entries(card, dev), self._table, self._count_t, grad_scale,
                momentum=self.momentum, beta1=self.beta1, beta2=self.beta2, eps=self.eps)
        if host:
            self._passes(host, grad_scale)
        total = sum(item[2].numel() for item in items)
        self.fused_share = 100.0 * sum(item[2].numel() for item in card) / total if total else 0.0
        if self.shards:  # every rank takes the others' updated slices
            all_gather_slices({p: self._owned(p, p) for p in self.shards}, self.shards,
                              out={p: p for p in self.shards}, group=self.group)
        self._count_t += 1
        self._count += 1

    _OWN = ("_schedules", "_host_table", "_table", "momentum", "beta1", "beta2", "eps",
            "state_dtype", "_count", "_count_t", "shards", "group", "fused_share")

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
