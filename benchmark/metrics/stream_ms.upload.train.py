"""Mean milliseconds a batch between the ``upload`` range's start and end
events on the prefetcher's side stream."""

from benchmark.metrics import _spans


def read(probe):
    return _spans.per_batch("upload", device=True)
