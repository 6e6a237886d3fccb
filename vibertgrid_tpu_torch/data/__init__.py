"""Host-side data pipeline: dataset specs, the image transform, bucketed
collation and the synthetic dataset (port of ``vibertgrid_tpu/data``, the
parts the serving path needs)."""

from vibertgrid_tpu_torch.data.dataset import (  # noqa: F401
    SEG_BUCKETS,
    WIN_BUCKETS,
    WINDOW,
    Collator,
    EvalAux,
    Sample,
)
from vibertgrid_tpu_torch.data.spec import (  # noqa: F401
    EPHOIE_SPEC,
    FUNSD_SPEC,
    SROIE_SPEC,
    DatasetSpec,
    get_spec,
)
from vibertgrid_tpu_torch.data.synthetic import make_synthetic_root  # noqa: F401
from vibertgrid_tpu_torch.data.transform import (  # noqa: F401
    ImageTransform,
    bilinear_resize,
    bucket_count,
    bucket_hw,
)
