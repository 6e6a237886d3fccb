"""The plain reference of the train step and the numbers the comparison
reads.

:func:`run` follows the program's first steps from the same weights,
batches and seeds: the forward of :mod:`benchmark.reference.model` in fp32
with TF32 off, its backward by autograd, the clip when the loss spikes
(above 10, the gradients scaled to a global norm of 2 where their norm is
above it) and the dual optimizer of the configuration (SGD with momentum
and coupled weight decay on the CNN side, AdamW on the encoder) with fp32
state. It reports the class scores of the first forward, each step's loss,
each leaf's first gradient as the optimizer gets it (after the clip), and
each leaf's norm of the change after the first step and after the last.

The program's side of the same numbers is read from its own state:
:func:`first_gradients` works the first gradient out of its optimizer's
slots after one step, :func:`change_norms` the change from its parameters.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from benchmark.reference import lowp, model

GROUPS = ("cnn", "bert")


def group_of(name: str) -> str:
    """'bert' for the encoder's leaves (AdamW), else 'cnn' (SGD)."""
    return "bert" if name.split(".")[0] == "bert_model" else "cnn"


def _f32(x: float) -> float:
    return float(np.float32(x))


def learning_rate(hyp: dict, group: str, step: int, niter_per_ep: int) -> float:
    """The configuration's step schedule: the base rate, times ``lr_gamma``
    at every ``lr_step_size`` epochs."""
    g = hyp[f"optimizer_{group}_hyp"]
    if g.get("warm_up_epoches", 0):
        raise ValueError("the reference follows no warm-up")
    size, epochs = int(hyp.get("lr_step_size", 15)), int(hyp["end_epoch"])
    milestones = list(range(size, epochs, size)) or [epochs]
    passed = sum(step >= m * niter_per_ep for m in milestones)
    return _f32(g["learning_rate"] * float(hyp.get("lr_gamma", 0.1)) ** passed)


def weight_decay(hyp: dict, group: str, step: int, niter_per_ep: int) -> float:
    """The configuration's cosine from ``weight_decay`` to ``min_weight_decay``
    over the run."""
    g = hyp[f"optimizer_{group}_hyp"]
    base, final = g["weight_decay"], g["min_weight_decay"]
    total = int(hyp["end_epoch"]) * (niter_per_ep + 1)
    return _f32(final + 0.5 * (base - final) * (1 + math.cos(math.pi * step / total)))


def first_gradients(states: dict, p0: dict, hyp: dict, niter_per_ep: int) -> dict:
    """``{name: fp32 host tensor}``: the program's first gradient as its
    optimizer got it, from the optimizer's state after one update
    (``states``: name -> that leaf's slots): SGD's momentum buffer is then
    ``g + wd·p0`` (the decay is coupled), AdamW's first moment
    ``(1 - beta1)·g``."""
    wd = weight_decay(hyp, "cnn", 0, niter_per_ep)
    beta1 = hyp["optimizer_bert_hyp"].get("beta1", 0.9)
    out = {}
    with torch.no_grad():
        for name, st in states.items():
            if group_of(name) == "cnn":
                g = st["momentum"].double() - wd * p0[name].double()
            else:
                g = st["mu"].double() / (1.0 - beta1)
            out[name] = g.float().cpu()
    return out


def norms(tensors: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}


def change_norms(params: dict, p0: dict) -> dict:
    with torch.no_grad():
        return {n: float(torch.linalg.vector_norm(p.double() - p0[n].double()))
                for n, p in params.items()}


def run(cfg: dict, weights: dict, batches: list, seed: int, niter_per_ep: int, device,
        control: bool = False) -> dict:
    """``len(batches)`` steps from ``weights`` (``{name: tensor}``, the
    state dict both sides load); ``batches``: ``{field: array}`` as the
    program received them. ``control``: every product in fp8
    (:mod:`benchmark.reference.lowp`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hyp = cfg["hyp"]
    params = {n: w.detach().clone().float().requires_grad_()
              for n, w in weights.items() if not n.endswith(("running_mean", "running_var"))}
    p0 = {n: p.detach().clone() for n, p in params.items()}
    slots: dict = {}
    losses, grads, scores, first_changes = [], None, None, None
    b1 = hyp["optimizer_bert_hyp"].get("beta1", 0.9)
    b2 = hyp["optimizer_bert_hyp"].get("beta2", 0.999)
    eps = hyp["optimizer_bert_hyp"].get("epsilon", 1e-8)
    momentum = hyp["optimizer_cnn_hyp"].get("momentum", 0.9)
    for k, arrays in enumerate(batches):
        batch = {f: torch.as_tensor(a, device=device) for f, a in arrays.items()}
        with lowp.fp8_products() if control else contextlib.nullcontext():
            loss, out = model.forward(params, batch, model.step_seeds(seed, k), cfg)
            g = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        g = {n: torch.zeros_like(p) if x is None else x.detach()
             for (n, p), x in zip(params.items(), g)}
        losses.append(float(loss.detach()))
        gnorm = math.sqrt(sum(float(torch.linalg.vector_norm(x.double())) ** 2
                              for x in g.values()))
        scale = 2.0 / gnorm if losses[-1] > 10.0 and gnorm > 2.0 else 1.0
        lr = {grp: learning_rate(hyp, grp, k, niter_per_ep) for grp in GROUPS}
        wd = {grp: weight_decay(hyp, grp, k, niter_per_ep) for grp in GROUPS}
        with torch.no_grad():
            for n, p in params.items():
                grad = g[n] * scale
                grp = group_of(n)
                if grp == "cnn":
                    buf = slots.setdefault(n, {"momentum": torch.zeros_like(p)})["momentum"]
                    buf.mul_(momentum).add_(grad + wd[grp] * p)
                    p.sub_(lr[grp] * buf)
                else:
                    st = slots.setdefault(n, {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)})
                    st["mu"].mul_(b1).add_((1 - b1) * grad)
                    st["nu"].mul_(b2).add_((1 - b2) * grad * grad)
                    u = (st["mu"] / (1 - b1 ** (k + 1))) / (
                        torch.sqrt(st["nu"] / (1 - b2 ** (k + 1))) + eps)
                    p.sub_(lr[grp] * (u + wd[grp] * p))
        if k == 0:
            grads = {n: (g[n] * scale).float().cpu() for n in g}
            scores = (out.detach().float().cpu().numpy(), np.asarray(arrays["box_mask"]))
            first_changes = change_norms(params, p0)
        del g
    return {"losses": losses, "gradients": grads, "changes": change_norms(params, p0),
            "first_changes": first_changes, "scores": scores}


@contextlib.contextmanager
def first_scores(program_model):
    """Keep the class scores ``[B, S, C]`` (and the valid segments) of the
    program model's first forward: the field-type head's output in the first
    train step, every document of the batch."""
    kept = []
    forward = program_model.forward

    def keeping(batch, *args, **kwargs):
        out = forward(batch, *args, **kwargs)
        if not kept:
            kept.append((out.pred_label.detach().float().cpu().numpy(),
                         batch.box_mask.detach().cpu().numpy()))
        return out

    program_model.forward = keeping
    try:
        yield kept
    finally:
        del program_model.forward


def scores_gap(got, want) -> float:
    """The widest gap between two first steps' class scores over the valid
    segments; infinite where the batches differ in shape. The two-stage
    head's class columns are 0 wherever its gate (column 0, a probability)
    says negative, so a class column is compared where both gates take the
    same side of 0.5."""
    (a, mask_a), (b, mask_b) = got, want
    if a.shape != b.shape or not np.array_equal(mask_a, mask_b):
        return math.inf
    keep = np.broadcast_to(mask_b[..., None], a.shape).copy()
    keep[..., 1:] &= ((a[..., :1] >= 0.5) == (b[..., :1] >= 0.5))
    return float(np.abs(a - b)[keep].max(initial=0.0))


def _gap(got: dict, want: dict, n: str) -> float:
    return abs(got[n] - want[n]) / max(want[n], 1e-30)


def median_leaf(got: dict, want: dict, keep=None) -> float:
    """The median over the leaves of each leaf's gap of norms, against its
    own reference norm."""
    gaps = sorted(_gap(got, want, n) for n in want if keep is None or n in keep)
    return gaps[len(gaps) // 2] if gaps else 0.0


def median_leaf_by_group(got: dict, want: dict, keep=None) -> float:
    """:func:`median_leaf` within each optimizer group (SGD's CNN side,
    AdamW's encoder), the larger of the two: a fault confined to one group
    moves its own median."""
    return max(median_leaf(got, want, {n for n in want if group_of(n) == grp
                                        and (keep is None or n in keep)})
               for grp in GROUPS)


def median_difference_by_group(got: dict, want: dict, keep=None) -> float:
    """Within each optimizer group, the median over the leaves of
    ``|got - want| / |want|`` (tensors, whole-leaf norms); the larger of the
    two groups."""
    gaps = {grp: [] for grp in GROUPS}
    for n in want:
        if keep is None or n in keep:
            w = want[n].double()
            gaps[group_of(n)].append(float(torch.linalg.vector_norm(got[n].double() - w)
                                           / torch.linalg.vector_norm(w).clamp(min=1e-30)))
    return max(sorted(v)[len(v) // 2] for v in gaps.values() if v)


def worst_leaf(got: dict, want: dict, keep=None) -> tuple[float, str]:
    """The largest gap of norms over the leaves, each against the larger of
    its reference norm and the median leaf's: ``(gap, leaf)``."""
    names = [n for n in want if keep is None or n in keep]
    if not names:
        return 0.0, ""
    ordered = sorted(want[n] for n in names)
    median = ordered[len(ordered) // 2]
    worst = max(names, key=lambda n: abs(got[n] - want[n]) / max(want[n], median, 1e-30))
    return abs(got[worst] - want[worst]) / max(want[worst], median, 1e-30), worst
