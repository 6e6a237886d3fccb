"""Per-iteration schedule arrays (the port's own copy of
``vibertgrid_tpu/train/schedules.py``, numpy only).

Cosine decay with optional linear warm-up, and a step schedule with
per-epoch boundaries, as arrays with one value per iteration. The optimizer
copies them into a device table indexed by its step counter
(``train/optim.py``); steps past the end hold the last value.
"""

from __future__ import annotations

import math

import numpy as np


def _warmup(base_value, niter_per_ep, warmup_epoches, start_warmup_value, warmup_steps):
    warmup_iters = warmup_epoches * (niter_per_ep + 1)
    if warmup_steps > 0:
        warmup_iters = warmup_steps
    schedule = np.array([])
    if warmup_epoches > 0:
        schedule = np.linspace(start_warmup_value, base_value, warmup_iters)
    return schedule, warmup_iters


def cosine_scheduler(
    base_value: float,
    final_value: float,
    epoches: int,
    niter_per_ep: int,
    warmup_epoches: int = 0,
    start_warmup_value: float = 0.0,
    warmup_steps: int = -1,
) -> np.ndarray:
    """Cosine array of length ``epoches * (niter_per_ep + 1)``."""
    warmup_schedule, warmup_iters = _warmup(
        base_value, niter_per_ep, warmup_epoches, start_warmup_value, warmup_steps)
    iters = np.arange(epoches * (niter_per_ep + 1) - warmup_iters)
    schedule = np.array(
        [
            final_value
            + 0.5 * (base_value - final_value) * (1 + math.cos(math.pi * i / len(iters)))
            for i in iters
        ]
    )
    return np.concatenate((warmup_schedule, schedule))


def step_scheduler(
    base_value: float,
    steps: list,
    gamma: float,
    num_epoches: int,
    niter_per_ep: int,
    warmup_epoches: int = 0,
    start_warmup_value: float = 0.0,
    warmup_steps: int = -1,
) -> np.ndarray:
    """Piecewise-constant array: the value is multiplied by ``gamma`` at each
    epoch boundary in ``steps``."""
    warmup_schedule, warmup_iters = _warmup(
        base_value, niter_per_ep, warmup_epoches, start_warmup_value, warmup_steps)
    total = num_epoches * (niter_per_ep + 1)
    change_steps = [step * niter_per_ep for step in steps]
    change_steps.append(total)
    schedule = [warmup_schedule]
    curr_value = base_value
    start_step = warmup_iters
    for change_step in change_steps:
        # Boundaries past the end of a short run contribute nothing.
        end_step = min(max(change_step, start_step), total)
        schedule.append(curr_value * np.ones(end_step - start_step))
        curr_value *= gamma
        start_step = end_step
    out = np.concatenate(schedule)
    assert len(out) == total, (len(out), total)
    return out


def schedule_value(arr: np.ndarray, step: int) -> float:
    """``arr[step]`` as the fp32 value the update uses, holding the last
    value past the end."""
    return float(np.float32(arr[min(max(step, 0), len(arr) - 1)]))
