"""Evaluation: entity joining ("strcmp", the official SROIE protocol) and the
per-dataset result filters."""

from vibertgrid_tpu_torch.eval.entities import (  # noqa: F401
    ephoie_result_filter,
    join_entities,
    sroie_result_filter,
)
from vibertgrid_tpu_torch.eval.harness import RESULT_FILTERS  # noqa: F401
