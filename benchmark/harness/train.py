"""A training cell: the port's train step (``train/state.py::make_train_step``)
on a ``TrainState``, seeded by ``train/seeds.py::step_seeds``, fed through
``data/dataset.py::prefetch_to_device``.

The feed: batches of the mix collated by the port's ``Collator`` in set-up
(the published train transform: a short side drawn from the configuration's
sizes a page) and cycled through the prefetcher: the tokenizer, the page
reading and the collate are off the step's path.

Set-up builds one train state from the seeded weights, drives it through its
first steps on the feed (the first three are the ones the reference
follows), warms every batch of the feed, and hands the same state and feed
to the window. The window issues steps until its time is up, then waits for
the device: the documents of every step issued, over that time. After the
window the reference repeats the first three steps.
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import math
import time

import numpy as np
import torch

from benchmark.harness import cli, counts, probe as probe_mod, traffic, weights

CHECKED_STEPS = 3


class _Ids:
    """The [CLS] / [SEP] ids of a vocabulary whose ids are drawn, not read."""

    def __init__(self, cls_id: int, sep_id: int):
        self.cls_token_id, self.sep_token_id = cls_id, sep_id


def _shape(batch, window: int, train=True) -> counts.Shape:
    return counts.Shape(b=batch.images.shape[0], h=batch.images.shape[1],
                        w=batch.images.shape[2], tokens=batch.tokens.shape[1], window=window,
                        s=batch.boxes.shape[1], train=train)


def _documents(mix: dict, seed: int, n: int) -> list:
    """``(image, tokens, seg_ids, boxes, classes)`` of ``n`` documents."""
    images = traffic.page_images(mix, seed)
    out = []
    for d in traffic.documents(mix, seed, n):
        ids = np.concatenate(d.ids).astype(np.int32)
        seg_ids = np.repeat(np.arange(len(d.ids), dtype=np.int32), [len(x) for x in d.ids])
        out.append((images[d.kind][d.image], ids, seg_ids, d.boxes, d.classes))
    return out


def run(ctx) -> list:
    from vibertgrid_tpu_torch.data.dataset import Sample, prefetch_to_device
    from vibertgrid_tpu_torch.train.driver import build_all
    from vibertgrid_tpu_torch.train.optim import make_optimizer
    from vibertgrid_tpu_torch.train.seeds import step_seeds
    from vibertgrid_tpu_torch.train.state import create_train_state, make_train_step

    from benchmark.reference import train as ref

    cell, config, mix, probe = ctx.cell, ctx.config, ctx.mix, ctx.probe
    device, seed = ctx.device, ctx.seed
    knobs = cell["train"]
    hyp = dict(config["hyp"])
    b, niter = knobs["batch"], knobs["niter_per_ep"]
    window = config["model"]["window_tokens"]
    tokenizer = _Ids(*knobs["cls_sep"])  # ids drawn over the vocabulary: no tokenizer
    _, _, model, _, collator, _ = build_all(hyp, "sroie", tokenizer, device=device, seed=0)
    ctx.shapes = weights.shapes_of(model)
    model.load_state_dict(weights.draw(ctx.shapes, seed, device), strict=True)
    optimizer = make_optimizer(hyp, hyp["end_epoch"], niter, model.named_parameters())
    state = create_train_state(model, optimizer)
    train_step = make_train_step()
    if ctx.faults is not None:
        train_step = ctx.faults("train", state=state, step=train_step)

    rng = np.random.default_rng([seed & 0xFFFFFFFFFFFFFFFF, 9])
    docs = _documents(mix, seed, b * knobs["distinct_batches"])
    samples = [Sample(image=im, tokens=t, seg_ids=si, boxes=bx, seg_classes=c,
                      texts=[""] * len(c)) for im, t, si, bx, c in docs]
    collated = [collator(samples[i:i + b], train=True, rng=rng)
                for i in range(0, len(samples), b)]
    feed = prefetch_to_device(itertools.cycle(collated), device)

    def step(batch):
        nonlocal state
        state, loss = train_step(state, batch, step_seeds(seed, state.step))
        return loss

    # the first steps, through the window's own call and feed
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    first, losses = [], []
    with ref.first_scores(model) as kept:
        for k in range(CHECKED_STEPS):
            batch, _ = next(feed)
            first.append({f.name: getattr(batch, f.name).cpu().numpy()
                          for f in dataclasses.fields(batch)})
            losses.append(step(batch))
            if k == 0:
                p0 = weights.draw(ctx.shapes, seed, device)
                got = {"gradients": ref.first_gradients(
                           {n: optimizer.state[p] for n, p in params.items()}, p0, hyp, niter),
                       "first_changes": ref.change_norms(params, p0)}
                del p0
    got["scores"] = kept[0]
    p0 = weights.draw(ctx.shapes, seed, device)
    got["changes"] = ref.change_norms(params, p0)
    del p0
    got["losses"] = [float(x) for x in losses]
    for _ in range(len(collated) - CHECKED_STEPS):  # warm-up: the feed's other batches
        step(next(feed)[0])
    for p in probe.spans.values():
        p.clear()
    if device.type == "cuda":
        torch.cuda.synchronize()
    probe.setup_s = time.perf_counter() - ctx.t0

    with probe_mod.traced(probe, ctx.trace):
        start = time.perf_counter()
        while time.perf_counter() - start < ctx.seconds:
            with probe.span("loader_wait"):
                batch, _ = next(feed)
            probe.forwards.append((time.perf_counter(), _shape(batch, window)))
            with probe.span("step"):
                step(batch)
            probe.steps += 1
            probe.docs += batch.images.shape[0]
        if device.type == "cuda":
            torch.cuda.synchronize()
        probe.window = (start, time.perf_counter())
    if device.type == "cuda":
        probe.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    del state, model, optimizer, params
    feed.close()
    del feed, collated, samples
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return _check(ctx, _reference_batches(ctx, docs), first, got)


def _reference_batches(ctx, docs) -> list:
    """The first batches worked out again from the benchmark's own documents
    and the feed's generator."""
    from benchmark.reference import collate

    b, rng = ctx.cell["train"]["batch"], np.random.default_rng([ctx.seed & 0xFFFFFFFFFFFFFFFF, 9])
    window = ctx.config["model"]["window_tokens"]
    return [collate.batch(docs[i:i + b], ctx.config["hyp"], window, rng)
            for i in range(0, CHECKED_STEPS * b, b)]


def _check(ctx, mine: list, first: list, got: dict) -> list:
    from benchmark.reference import collate
    from benchmark.reference import train as ref

    cfg = {"model": ctx.config["model"], "hyp": ctx.config["hyp"],
           "cls_sep": ctx.cell["train"]["cls_sep"]}
    args = (cfg, weights.draw(ctx.shapes, ctx.seed, ctx.device), mine, ctx.seed,
            ctx.cell["train"]["niter_per_ep"], ctx.device)
    want = ref.run(*args)
    if ctx.control:  # the reference in fp8, in the program's place
        got = ref.run(*args, control=True)
    for side in (got, want):
        side["grads"] = ref.norms(side["gradients"])
    ordered = sorted(want["grads"].values())
    moved = {n for n, g in want["grads"].items() if g >= 1e-3 * ordered[len(ordered) // 2]}
    steps = [abs(g - w) / max(abs(w), 1e-30) if math.isfinite(g) else math.inf
             for g, w in zip(got["losses"], want["losses"])]
    numbers = {
        "batch_mismatch": collate.mismatches(first, mine),
        "first_scores_gap": ref.scores_gap(got["scores"], want["scores"]),
        "first_loss_gap": steps[0],
        "loss_gap": max(steps),
        "gradient_gap": ref.worst_leaf(got["grads"], want["grads"]),
        "change_gap": ref.worst_leaf(got["changes"], want["changes"], keep=moved),
        "median_gradient_gap": ref.median_leaf_by_group(got["grads"], want["grads"]),
        "median_gradient_difference": ref.median_difference_by_group(
            got["gradients"], want["gradients"], keep=moved),
        "median_first_change_gap": ref.median_leaf_by_group(
            got["first_changes"], want["first_changes"], keep=moved),
        "median_change_gap": ref.median_leaf_by_group(got["changes"], want["changes"],
                                                      keep=moved),
    }
    for name in ("gradient_gap", "change_gap"):  # (gap, leaf): the leaf goes to the notes
        numbers[name], ctx.notes[name + "_leaf"] = numbers[name]
    ctx.notes.update(losses=got["losses"], reference_losses=want["losses"],
                     leaves_left_out=sorted(set(want["grads"]) - moved))
    return cli.compared(ctx, numbers)
