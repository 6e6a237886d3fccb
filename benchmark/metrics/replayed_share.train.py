"""Percent of the window's train steps replayed from a CUDA graph, read from
the program's ``train_step`` ranges, which ``train/state.py`` marks
``replayed``, ``captured`` or ``eager``. Nothing to read where the ranges
carry no such mark (a program without graphs) or none was recorded."""

from benchmark.metrics import _spans


def read(probe):
    steps = [s for s in _spans.recorded() or ()
             if s.name == "train_step" and s.host_end_ns is not None]
    modes = [getattr(s, "mode", None) for s in steps]
    if not steps or all(m is None for m in modes):
        return None
    return 100.0 * sum(m == "replayed" for m in modes) / len(steps)
