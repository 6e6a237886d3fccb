"""Percent of the update's elements that the hand-written update kernel
took, the mean over the window's train steps, read from the mark the program
puts on each step's ``optimizer`` range (``train/state.py``: the optimizer's
``fused_share``; a replayed step's from its graph). Nothing to read where
the ranges carry no such mark (a program without the kernel) or none was
recorded."""

from benchmark.metrics import _spans


def read(probe):
    spans = _spans.recorded() or ()
    steps = {s.step for s in spans if s.name == "train_step" and s.host_end_ns is not None}
    shares = [getattr(s, "fused_share", None) for s in spans
              if s.name == "optimizer" and s.step in steps]
    shares = [x for x in shares if x is not None]
    if not shares:
        return None
    return sum(shares) / len(shares)
