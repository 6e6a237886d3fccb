"""Roofline share of the ffn_saved kernel's calls in the window's train steps."""

from benchmark.metrics import _roofline


def read(probe):
    return _roofline.share(probe, "ffn_saved", train=True)
