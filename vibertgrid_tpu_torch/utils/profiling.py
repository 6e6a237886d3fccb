"""Tracing and profiling helpers (port of ``vibertgrid_tpu/utils/profiling.py``).

- :func:`trace`: a context manager around ``torch.profiler`` that writes a
  trace TensorBoard and Chrome's ``chrome://tracing`` open.
- :class:`step_timer`: wall-clock seconds a step, each tick synchronised by
  reading an output back to the host.
- :func:`flops_estimate`: the floating-point operations of one call, counted
  by ``torch.utils.flop_counter.FlopCounterMode``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.utils.flop_counter import FlopCounterMode


@contextlib.contextmanager
def trace(logdir: str = "./log/torch-trace"):
    """Profile the host and, where one is present, the card for the length
    of the ``with`` block and write the trace under ``logdir`` (a
    ``*.pt.trace.json`` file per call, TensorBoard's layout); yields
    ``logdir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield logdir


class step_timer:
    """Usage::

        timer = step_timer()
        for batch in loader:
            state, loss = train_step(state, batch, seeds)
            dt = timer.tick(loss)   # waits for the step: reads loss back
    """

    def __init__(self):
        self.t0 = time.perf_counter()
        self.history: list[float] = []

    def tick(self, sync_leaf=None) -> float:
        """Seconds since the last tick (or since the timer was made). With
        ``sync_leaf`` (a tensor) it first reads one element of it back to
        the host, which waits for the work that produced it."""
        if isinstance(sync_leaf, torch.Tensor):
            sync_leaf.detach().reshape(-1)[0].item()
        now = time.perf_counter()
        dt = now - self.t0
        self.t0 = now
        self.history.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.history) / max(len(self.history), 1)


def flops_estimate(fn, *args, **kwargs) -> dict:
    """``{"flops": n}``: the floating-point operations of ``fn(*args,
    **kwargs)``, run once under ``FlopCounterMode``, which counts the
    library's products, convolutions and attention by their shapes.

    The port's hand-written kernels (``csrc/``, launched through ctypes) are
    invisible to it, so a path that runs them counts only the work around
    them; their operations and bytes are in ``PERF.md``'s kernel table, as
    each kernel's bound (``chip_smoke.py`` computes them from the shapes)."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return {"flops": counter.get_total_flops()}
