"""Token- and pixel-level metric kernels.

Numpy ports of ViBERTgrid-PyTorch's ``pipeline/criteria.py`` (the seqeval-based
``BIO_F1_criteria`` lives in :mod:`vibertgrid_tpu_torch.eval.seqeval_lite`
instead). Semantics are preserved exactly, including the reference's
``.int()`` truncation of probability scores in :func:`token_F1_criteria`.
"""

from __future__ import annotations

import numpy as np


def token_classification_criteria(
    gt_label: np.ndarray, pred_label: np.ndarray
) -> tuple[float, int]:
    """Token-level accuracy counts (``pipeline/criteria.py:12-21``).

    ``pred_label``: ``[N, C]`` scores (argmaxed over classes) or ``[N]``
    already-decoded ids. Returns ``(num_correct, num_entities)``.
    """
    pred_label = np.asarray(pred_label)
    gt_label = np.asarray(gt_label)
    if pred_label.ndim == 2:
        pred_label = pred_label.argmax(axis=1)
    num_correct = float((gt_label.astype(np.int64) == pred_label.astype(np.int64)).sum())
    return num_correct, int(gt_label.shape[0])


def token_F1_criteria(pred_gt_list: list[tuple[np.ndarray, np.ndarray]]) -> dict:
    """Per-class TP/TN/FP/FN + P/R/F1 dict (``pipeline/criteria.py:55-95``).

    ``pred_gt_list``: per-document ``(pred [N, C], gt [N])`` pairs,
    concatenated over documents. The reference casts the float class scores
    with ``.int()`` before comparing to 1/0 — probabilities truncate to 0
    unless exactly 1.0, so only fully-confident predictions count as
    positives. That quirk is metric-defining and reproduced here
    (``pipeline/criteria.py:66, 71-74``).
    """
    pred = np.concatenate([np.asarray(p) for p, _ in pred_gt_list], axis=0)
    gt = np.concatenate(
        [np.asarray(g).reshape(-1) for _, g in pred_gt_list], axis=0
    ).astype(np.int64)

    num_classes = pred.shape[1]
    # torch ``.int()`` truncates toward zero.
    pred_int = np.trunc(pred).astype(np.int64)

    result_dict: dict = {}
    for c in range(num_classes):
        is_gt = gt == c
        col = pred_int[:, c]
        TP = int((col[is_gt] == 1).sum())
        TN = int((col[~is_gt] == 0).sum())
        FP = int((col[~is_gt] == 1).sum())
        FN = int((col[is_gt] == 0).sum())
        precision = TP / (TP + FP + 1e-8)
        recall = TP / (TP + FN + 1e-8)
        f1 = 2 * precision * recall / (precision + recall + 1e-8)
        result_dict[c] = {
            "TP": TP,
            "TN": TN,
            "FP": FP,
            "FN": FN,
            "precision": precision,
            "recall": recall,
            "F1": f1,
        }
    result_dict["num_classes"] = num_classes
    return result_dict


def semantic_segmentation_classification_criteria(
    pred_ss_label: np.ndarray,
    class_ss_label: np.ndarray,
    coor: np.ndarray,
) -> tuple[float, int]:
    """Per-box pixel-classification accuracy over the aux seg maps
    (``pipeline/criteria.py:98-117``).

    ``pred_ss_label``/``class_ss_label``: ``[B, C, H, W]`` score maps;
    ``coor``: ``[B, N, 4]`` (the reference indexes ``coor[b, n]`` with shape
    ``[B, 1, N, 4]`` semantics — pass the squeezed form). A box counts as
    correct when every pixel's argmax class matches. (The reference's
    ``if gt_label == pred_label`` on a multi-pixel crop would raise in torch;
    the only well-defined case — all pixels agree — is the semantics
    implemented here, and it degenerates to the reference's for 1-pixel
    crops.) Empty crops count as correct, matching the reference's fallthrough.
    """
    pred_ss_label = np.asarray(pred_ss_label)
    class_ss_label = np.asarray(class_ss_label)
    coor = np.asarray(coor)
    if coor.ndim == 4:  # reference passes [B, 1, N, 4]
        coor = coor.reshape(coor.shape[0], -1, 4)
    batch_size, num_entities = coor.shape[0], coor.shape[1]
    classify_correct = 0.0
    for b in range(batch_size):
        for n in range(num_entities):
            x0, y0, x1, y1 = (int(v) for v in coor[b, n])
            gt = class_ss_label[b, :, y0:y1, x0:x1].argmax(axis=0)
            pr = pred_ss_label[b, :, y0:y1, x0:x1].argmax(axis=0)
            if (gt == pr).all():
                classify_correct += 1
    return classify_correct, num_entities
