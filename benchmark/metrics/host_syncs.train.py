"""Synchronising CUDA calls a train step, counted by the program inside its
``train_step`` range (``torch.cuda.set_sync_debug_mode("warn")``)."""

from benchmark.metrics import _spans


def read(probe):
    return _spans.syncs_per_step()
