"""Modules of the ViBERTgrid model."""

from vibertgrid_tpu_torch.models.vibertgrid import (  # noqa: F401
    Batch,
    ModelConfig,
    ModelOutput,
    ViBERTgridNet,
)
