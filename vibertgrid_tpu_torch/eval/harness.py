"""Evaluation harness (port of ``vibertgrid_tpu/eval/harness.py``): for now
the per-dataset result filters that serving applies after the entity join;
``validate``, ``evaluate_dataset``, ``strcmp_compare`` and ``inference_once``
come with the training driver."""

from __future__ import annotations

from typing import Callable

from vibertgrid_tpu_torch.eval.entities import ephoie_result_filter, sroie_result_filter

RESULT_FILTERS: dict[str, Callable | None] = {
    "sroie": sroie_result_filter,
    "synthetic": None,
    "ephoie": ephoie_result_filter,
    "funsd": None,
}
