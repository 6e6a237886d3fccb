"""Mean milliseconds a train step between the ``backward`` range's start and
end events on the card's stream."""

from benchmark.metrics import _spans


def read(probe):
    return _spans.per_step("backward", device=True)
