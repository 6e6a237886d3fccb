"""Mean host milliseconds a train step of the program's ``backward`` range
(``loss.backward()``)."""

from benchmark.metrics import _spans


def read(probe):
    return _spans.per_step("backward")
