"""Mean milliseconds a train step between the ``backbone`` range's start and
end events on the card's stream (the BERTgrid scatter and the ResNet-FPN)."""

from benchmark.metrics import _spans


def read(probe):
    return _spans.per_step("backbone", device=True)
