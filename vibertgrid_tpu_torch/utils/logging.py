"""Logging utilities.

- :class:`TerminalLogger`: tee stdout to a logfile
  (ViBERTgrid-PyTorch's ``pipeline/train_val_utils.py:40-51``).
- :class:`MetricsLogger`: TensorBoard scalar groups with a step counter
  (``pipeline/train_val_utils.py:54-80``); JSONL where
  ``torch.utils.tensorboard`` cannot be imported.
- :func:`setup_seed`: the determinism knob
  (``pipeline/distributed_utils.py:8-13``): seeds Python, numpy and torch's
  default generators. The model's weights and every dropout and sampled loss
  take explicit generators and seeds besides (``train/seeds.py``).
"""

from __future__ import annotations

import json
import os
import random
import sys
import time


class TerminalLogger:
    def __init__(self, filename: str, stream=None) -> None:
        self.terminal = stream or sys.stdout
        os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
        self.log = open(filename, "a")

    def write(self, message: str):
        self.terminal.write(message)
        self.log.write(message)

    def flush(self):
        self.terminal.flush()
        self.log.flush()


class MetricsLogger:
    """TensorBoard scalars (falls back to JSONL); ``enabled=False`` (the
    ranks other than 0) writes nothing."""

    def __init__(self, logdir: str, comment: str = "", enabled: bool = True) -> None:
        self.step = 0
        self._writer = None
        self._jsonl = None
        if not enabled:
            return
        os.makedirs(logdir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # no tensorboard installed
            self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        else:
            self._writer = SummaryWriter(log_dir=logdir, comment=comment)

    def set_step(self, step: int | None = None):
        self.step = self.step + 1 if step is None else step

    def update(self, head: str = "scalar", step: int | None = None, **kwargs):
        s = self.step if step is None else step
        for k, v in kwargs.items():
            if v is None:
                continue
            v = float(v)
            if self._writer is not None:
                self._writer.add_scalar(f"{head}/{k}", v, s)
            elif self._jsonl is not None:
                self._jsonl.write(
                    json.dumps({"t": time.time(), "step": s, f"{head}/{k}": v}) + "\n"
                )

    def flush(self):
        if self._writer is not None:
            self._writer.flush()
        if self._jsonl is not None:
            self._jsonl.flush()

    def close(self):
        """Shut the writer down (the TB EventFileWriter owns a background
        thread — without close() every training run leaks one)."""
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None


def setup_seed(seed: int = 42) -> None:
    import numpy as np
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
