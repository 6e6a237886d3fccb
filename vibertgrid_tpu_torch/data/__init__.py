"""Host-side data pipeline: dataset specs, the image transform, the dataset
reader, bucketed collation, the loaders, the prefetch to the device and the
synthetic dataset (port of ``vibertgrid_tpu/data``)."""

from vibertgrid_tpu_torch.data.dataset import (  # noqa: F401
    SEG_BUCKETS,
    WIN_BUCKETS,
    WINDOW,
    Collator,
    EvalAux,
    KIEDataset,
    Sample,
    bucketed_eval_loader,
    compute_mean_std,
    data_loader,
    prefetch_to_device,
    to_device,
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
