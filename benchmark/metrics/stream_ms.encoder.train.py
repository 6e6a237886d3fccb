"""Mean milliseconds a train step between the ``encoder`` range's start and
end events on the card's stream (windows, the text encoder, the segment mean)."""

from benchmark.metrics import _spans


def read(probe):
    return _spans.per_step("encoder", device=True)
