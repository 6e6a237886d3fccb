"""``fused_share.optimizer.train`` (``benchmark/metrics/fused_share.optimizer.train.py``)
on hand-built ranges: the mean of the marks on the ``optimizer`` ranges of
the closed train steps, and nothing to read where the ranges carry no mark
(a program without the update kernel), where none was recorded, or without
a recorder."""

import types

import pytest

from benchmark.harness import cli
from vibertgrid_tpu_torch.utils import profiling

NAME = "fused_share.optimizer.train"


def _step(k, closed=True):
    return profiling.Span(name="train_step", parent=None, step=k, thread=1,
                          host_start_ns=k * 10, host_end_ns=k * 10 + 5 if closed else None)


def _optimizer(k, share):
    span = profiling.Span(name="optimizer", parent=None, step=k, thread=1, host_start_ns=None)
    span.fused_share = share
    return span


@pytest.mark.parametrize("shares, want", [
    ([100.0, 100.0, 100.0], 100.0),
    ([100.0, 50.0], 75.0),
    ([0.0, 0.0], 0.0),
])
def test_mean_share_of_the_closed_steps(shares, want, monkeypatch):
    spans = []
    for k, share in enumerate(shares):
        spans += [_step(k), _optimizer(k, share)]
    spans += [_step(99, closed=False), _optimizer(99, 1.0)]  # an open step is not read
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    assert cli.reader(NAME)(None) == pytest.approx(want)


def test_nothing_to_read_without_marks(monkeypatch):
    monkeypatch.setattr(profiling, "spans",
                        lambda: [_step(1), _optimizer(1, None), _step(2), _optimizer(2, None)])
    assert cli.reader(NAME)(None) is None
    unmarked = types.SimpleNamespace(name="optimizer", step=1)  # a span with no such field
    monkeypatch.setattr(profiling, "spans", lambda: [_step(1), unmarked])
    assert cli.reader(NAME)(None) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert cli.reader(NAME)(None) is None
    monkeypatch.delattr(profiling, "spans")
    assert cli.reader(NAME)(None) is None
