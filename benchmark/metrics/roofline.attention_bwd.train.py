"""Roofline share of the attention_bwd kernel's calls in the window's train steps."""

from benchmark.metrics import _roofline


def read(probe):
    return _roofline.share(probe, "attention_bwd", train=True)
