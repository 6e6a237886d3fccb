"""Evaluation: BIO entity F1 (seqeval-compatible), entity joining ("strcmp",
the official SROIE protocol), the per-dataset result filters and the
validation harness."""

from vibertgrid_tpu_torch.eval.entities import (  # noqa: F401
    ephoie_result_filter,
    join_entities,
    sroie_result_filter,
)
from vibertgrid_tpu_torch.eval.harness import (  # noqa: F401
    RESULT_FILTERS,
    evaluate_dataset,
    validate,
)
from vibertgrid_tpu_torch.eval.seqeval_lite import (  # noqa: F401
    bio_f1,
    classification_report,
    get_entities,
)
