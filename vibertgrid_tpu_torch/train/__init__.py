"""Training: schedules, the dual optimizer, seeds and the train/eval steps."""

from vibertgrid_tpu_torch.train.optim import DualOptimizer, make_optimizer
from vibertgrid_tpu_torch.train.seeds import ReplaySeeds, SeedStream, step_seeds
from vibertgrid_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_inference_step,
    make_train_step,
)

__all__ = [
    "DualOptimizer", "ReplaySeeds", "SeedStream", "TrainState", "create_train_state",
    "make_eval_step", "make_inference_step", "make_optimizer", "make_train_step", "step_seeds",
]
