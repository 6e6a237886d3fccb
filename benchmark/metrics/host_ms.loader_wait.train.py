"""Mean host milliseconds of the program's own ``loader_wait`` range a batch:
the prefetcher's queue and the wait on the batch's copies."""

from benchmark.metrics import _spans


def read(probe):
    return _spans.per_batch("loader_wait")
