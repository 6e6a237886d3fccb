"""Mean milliseconds a train step between the start and end events of the two
``heads`` ranges on the card's stream (the segmentation head and its loss;
late fusion, the field-type head and its loss), summed."""

from benchmark.metrics import _spans


def read(probe):
    return _spans.per_step("heads", device=True)
