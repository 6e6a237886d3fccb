"""Mean host milliseconds a train step of the program's ``optimizer`` range
(``apply_gradients``: the clip and both updates)."""

from benchmark.metrics import _spans


def read(probe):
    return _spans.per_step("optimizer")
