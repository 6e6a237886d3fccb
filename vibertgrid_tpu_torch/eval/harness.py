"""Validation and evaluation harness (port of ``vibertgrid_tpu/eval/harness.py``).

``validate`` follows ``pipeline/train_val_utils.py:349-665`` and the eval
CLIs' bodies (``eval_SROIE.py:75-257``, ``eval_EPHOIE.py``,
``eval_FUNSD.py:24-67``), parameterised by a :class:`DatasetSpec`.

Eval modes (``example_config.yaml:55-58``):

- ``seqeval``: token-level BIO F1 through :mod:`seqeval_lite`;
- ``strcmp``: runs joined into entity strings and compared exactly with the
  key dicts (the official SROIE protocol);
- ``seq_and_str``: both.

The model's outputs arrive padded, ``[B, S, C]``; each sample's valid
segments are sliced on the host. With more than one process each scores its
loader shard, and after the last batch the losses, counters, tag sequences,
pred/gt pairs and per-sample records are gathered from every process (the
reference's ``all_reduce`` and ``all_gather_object``,
``pipeline/train_val_utils.py:537-552``), so every process returns the same
metrics; the processes may have different numbers of batches, so nothing is
exchanged per batch.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Iterable

import numpy as np
import torch

from vibertgrid_tpu_torch.data.dataset import to_device
from vibertgrid_tpu_torch.data.spec import DatasetSpec
from vibertgrid_tpu_torch.eval.criteria import token_classification_criteria, token_F1_criteria
from vibertgrid_tpu_torch.eval.entities import (
    ephoie_result_filter,
    join_entities,
    sroie_result_filter,
)
from vibertgrid_tpu_torch.eval.seqeval_lite import bio_f1, classification_report, per_type_f1
from vibertgrid_tpu_torch.parallel.mesh import current_layout, process_allgather_objects

RESULT_FILTERS: dict[str, Callable | None] = {
    "sroie": sroie_result_filter,
    "synthetic": None,
    "ephoie": ephoie_result_filter,
    "funsd": None,
}

_LOG_FMT = "pred_key: [{pred_key}] gt_key: [{gt_key}] status: {status}"


def _tags_from_ids(ids, idx_to_tag):
    return [idx_to_tag[int(i)] for i in ids]


def strcmp_compare(pred_keys: list[str], key_dict: dict, class_list, result_filter=None):
    """Exact-string scoring of one document.

    Returns ``(recall_acc, precision_acc, n_gt, n_det, log, report_correct)``.
    The counters follow ``validate``'s protocol (train_val_utils.py:495-518: a
    class counts only where its gt is not empty); ``report_correct`` and the
    log's status follow the eval CLI's per-sample report (eval_SROIE.py:192-237:
    ``pred == gt`` is CORRECT even when both are empty). The two differ exactly
    on classes with an empty gt, and the reference uses each in its own place.
    """
    recall_acc = precision_acc = 0.0
    n_det = n_gt = 0.0
    report_correct = 0.0
    log = {}
    for ci in range(1, len(class_list)):
        pred = pred_keys[ci]
        if result_filter is not None:
            pred = result_filter(pred, ci)
            if pred is None:
                pred = ""
        gt = key_dict.get(class_list[ci], "")
        if len(pred):
            n_det += 1
        correct = pred == gt  # the report's rule (eval_SROIE.py:201)
        if correct:
            report_correct += 1
        if len(gt):
            n_gt += 1
            if correct:
                recall_acc += 1
                precision_acc += 1
        log[class_list[ci]] = _LOG_FMT.format(
            pred_key=pred, gt_key=gt, status="CORRECT" if correct else "ERROR"
        )
    return recall_acc, precision_acc, n_gt, n_det, log, report_correct


def _fetch(out) -> tuple[float | None, float | None, float | None, np.ndarray, np.ndarray]:
    """``(loss, loss_c, loss_aux, pred_label, gt_label)`` of one batch's
    output on the host, in **one** device-to-host copy: the losses, the
    predictions and the labels packed into one fp32 vector (labels and CRF
    tags are small integers, exact in fp32)."""
    losses = [getattr(out, name, None) for name in ("total_loss", "loss_c", "loss_aux")]
    pred, gt = out.pred_label, out.gt_label
    parts = [t.detach().float().reshape(-1) for t in (*losses, pred, gt) if t is not None]
    flat = torch.cat(parts).cpu().numpy()
    scalars = iter(flat[: sum(t is not None for t in losses)].tolist())
    loss, loss_c, loss_aux = (None if t is None else next(scalars) for t in losses)
    at = len(flat) - pred.numel() - gt.numel()
    pred_np = flat[at : at + pred.numel()].reshape(pred.shape)
    gt_np = flat[at + pred.numel():].reshape(gt.shape).astype(np.int64)
    return loss, loss_c, loss_aux, pred_np, gt_np


def validate(
    eval_step: Callable,
    state: Any,
    loader: Iterable,
    spec: DatasetSpec,
    *,
    eval_mode: str | None = None,
    tag_to_idx: dict | None = None,
    strcmp_thresh: float = 0.0,
    seqeval_average: str | None = None,
    result_filter: Callable | str | None = "default",
    verbose: bool = True,
) -> dict:
    """Run the model over a test loader and compute the entity metrics.

    ``eval_step(state, batch[, sizes]) -> ModelOutput``
    (:func:`vibertgrid_tpu_torch.train.state.make_eval_step`); a batch of
    uint8 images takes the wire's per-sample valid sizes from
    ``aux.image_sizes``. Returns precision / recall / F1 (and the token-level
    metrics in the seq modes)."""
    eval_mode = eval_mode or spec.default_eval_mode
    seqeval_average = seqeval_average or spec.seqeval_average
    if result_filter == "default":
        result_filter = RESULT_FILTERS.get(spec.name)
    class_list = list(spec.class_list)
    num_classes = len(class_list)
    idx_to_tag = {v: k for k, v in (tag_to_idx or {}).items()}

    recall_sum = precision_sum = num_gt = num_det = 0.0
    losses, losses_c, losses_aux = [], [], []
    pred_tag_seqs, gt_tag_seqs = [], []
    pred_gt_pairs: list = []  # (scores [N, C] or ids [N], gt [N]) a document
    per_sample = {}

    for batch, aux in loader:
        images = getattr(batch, "images", None)  # tests stub the batch
        if images is not None and images.dtype == torch.uint8:
            # the uint8 wire: the step normalises on the device and sets the
            # canvas padding back to 0 from each sample's valid size
            sizes = to_device(np.asarray(aux.image_sizes, np.int32), images.device)
            out = eval_step(state, batch, sizes)
        else:
            out = eval_step(state, batch)
        loss_v, loss_c_v, loss_aux_v, pred, gt = _fetch(out)
        for kept, value in ((losses, loss_v), (losses_c, loss_c_v), (losses_aux, loss_aux_v)):
            if value is not None:
                kept.append(value)
        for i, n_seg in enumerate(aux.n_segments):
            if n_seg == 0:
                continue
            probs_or_tags = pred[i, :n_seg]
            gt_ids = gt[i, :n_seg]
            pred_gt_pairs.append((probs_or_tags, gt_ids))

            if eval_mode in ("seqeval", "seq_and_str"):
                if tag_to_idx is None:
                    raise ValueError(f"eval_mode {eval_mode!r} needs tag_to_idx")
                if probs_or_tags.ndim == 2:
                    pred_ids = probs_or_tags.argmax(-1)
                else:
                    pred_ids = probs_or_tags.astype(np.int64)
                pred_ids = np.clip(pred_ids, 0, len(idx_to_tag) - 1)
                pred_tag_seqs.append(_tags_from_ids(pred_ids, idx_to_tag))
                gt_tag_seqs.append(_tags_from_ids(gt_ids, idx_to_tag))

            if eval_mode in ("strcmp", "seq_and_str") and probs_or_tags.ndim == 2:
                # the heads emit probabilities; the reference softmaxes them
                # again (train_val_utils.py:446), and so does this
                z = probs_or_tags - probs_or_tags.max(-1, keepdims=True)
                probs = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
                pred_keys = join_entities(probs, aux.texts[i], num_classes,
                                          language=spec.language, score_thresh=strcmp_thresh)
                key_dict = aux.key_dicts[i] or {}
                r, p, g, d, log, rep = strcmp_compare(pred_keys, key_dict, class_list,
                                                      result_filter)
                recall_sum += r
                precision_sum += p
                num_gt += g
                num_det += d
                # the per-sample report's shape and rules (eval_SROIE.py:212-237)
                s_prec = 0.0 if d == 0 else rep / d
                s_rec = 1.0 if num_classes - 1 == 0 else rep / (num_classes - 1)
                s_hmean = 0.0 if s_prec + s_rec == 0 else 2 * s_prec * s_rec / (s_prec + s_rec)
                per_sample[key_dict.get("filename", len(per_sample))] = {
                    "precision": s_prec,
                    "recall": s_rec,
                    "hmean": s_hmean,
                    "correct": rep,
                    "log": log,
                    "pred": pred_keys,
                }

    layout = current_layout()
    if layout.data > 1:  # every data shard's documents; a model group computed its own once
        shards = process_allgather_objects(dict(
            losses=(losses, losses_c, losses_aux),
            counters=(recall_sum, precision_sum, num_gt, num_det),
            pred_tag_seqs=pred_tag_seqs, gt_tag_seqs=gt_tag_seqs,
            pred_gt_pairs=pred_gt_pairs, per_sample=per_sample,
        ), group=layout.data_group)
        losses, losses_c, losses_aux = ([x for sh in shards for x in sh["losses"][i]]
                                        for i in range(3))
        recall_sum, precision_sum, num_gt, num_det = (
            sum(sh["counters"][i] for sh in shards) for i in range(4))
        pred_tag_seqs = [x for sh in shards for x in sh["pred_tag_seqs"]]
        gt_tag_seqs = [x for sh in shards for x in sh["gt_tag_seqs"]]
        pred_gt_pairs = [x for sh in shards for x in sh["pred_gt_pairs"]]
        per_sample = {k: v for sh in shards for k, v in sh["per_sample"].items()}

    results: dict = {"loss": float(np.mean(losses)) if losses else None}
    # the loss's parts (total = loss_c + λ·loss_aux), for diagnosis only
    if losses_c:
        results["loss_c"] = float(np.mean(losses_c))
    if losses_aux:
        results["loss_aux"] = float(np.mean(losses_aux))
    if pred_gt_pairs:
        # token accuracy (pipeline/criteria.py:12-21) and the per-class
        # TP/TN/FP/FN dict (criteria.py:55-95) of the reference's token branch
        n_correct = n_total = 0.0
        for p_, g_ in pred_gt_pairs:
            c, n = token_classification_criteria(g_, p_)
            n_correct += c
            n_total += n
        results["token_accuracy"] = 0.0 if n_total == 0 else n_correct / n_total
        if pred_gt_pairs[0][0].ndim == 2:
            results["token_F1_dict"] = token_F1_criteria(pred_gt_pairs)
    if eval_mode in ("seqeval", "seq_and_str") and pred_tag_seqs:
        p, r, f = bio_f1(gt_tag_seqs, pred_tag_seqs, seqeval_average)
        results.update(token_precision=p, token_recall=r, token_F1=f)
        # per-type F1: a model collapsed onto the majority class scores on
        # one type at most (the learnability gate reads it)
        results["per_type_F1"] = per_type_f1(gt_tag_seqs, pred_tag_seqs)
        if verbose:
            print(classification_report(gt_tag_seqs, pred_tag_seqs))
    if eval_mode in ("strcmp", "seq_and_str"):
        recall = 0.0 if num_gt == 0 else recall_sum / num_gt
        precision = 0.0 if num_det == 0 else precision_sum / num_det
        f1 = 0.0 if recall + precision == 0 else 2 * recall * precision / (recall + precision)
        results.update(precision=precision, recall=recall, F1=f1)
        results["per_sample"] = per_sample
    # the scalar that ranks checkpoints (train_SROIE.py:374-377)
    results["primary_F1"] = results.get("F1", results.get("token_F1", 0.0))
    if verbose:
        shown = {k: round(v, 4) for k, v in results.items() if isinstance(v, float)}
        print(f"validate[{spec.name}] {shown}")
    return results


def evaluate_dataset(eval_step, state, loader, spec, tag_mode: str = "B", **kw) -> dict:
    """The eval_*.py loop: ``validate`` with the spec's tags and filters."""
    return validate(eval_step, state, loader, spec, tag_to_idx=spec.tag_to_idx(tag_mode), **kw)


def inference_once(eval_step, state, batch, aux, spec: DatasetSpec, draw: bool = False,
                   save_path: str = "./inference_result.jpg") -> list[dict]:
    """One document's inference (train_val_utils.py:668-733): prints the time,
    returns a ``{text: box}`` dict for each class but the background, and
    draws the boxes on the image when ``draw``."""
    if len(aux.n_segments) != 1:
        raise ValueError("inference_once expects a batch of one document")
    t0 = time.time()
    out = eval_step(state, batch)
    pred = out.pred_label.float().cpu().numpy()
    print(f"inference speed: {(time.time() - t0) * 1000:.1f}ms")

    n = aux.n_segments[0]
    probs = pred[0, :n]
    pred_cls = probs.argmax(-1) if probs.ndim == 2 else probs.astype(int)
    boxes = batch.boxes[0, :n].cpu().numpy()
    class_result = [dict() for _ in range(spec.num_classes - 1)]
    for text, box, cls in zip(aux.texts[0], boxes, pred_cls):
        if int(cls) == 0:
            continue
        class_result[int(cls) - 1][text] = box.tolist()
    for item in class_result:
        print(item)
    if draw:
        from vibertgrid_tpu_torch.utils.visualize import draw_box

        draw_box(batch.images[0].float().cpu().numpy(), class_result, list(spec.class_list),
                 save_path=save_path)
    return class_result
