"""Mean host milliseconds of the prefetcher thread's ``upload`` range a batch:
pinning the batch and issuing its copies."""

from benchmark.metrics import _spans


def read(probe):
    return _spans.per_batch("upload")
