"""``replayed_share.train`` (``benchmark/metrics/replayed_share.train.py``) on
hand-built ``train_step`` ranges: the share of the closed steps marked
``replayed``, and nothing to read where the ranges carry no mark (a program
without graphs), where none was recorded, or without a recorder."""

import pytest

from benchmark.harness import cli
from vibertgrid_tpu_torch.utils import profiling

NAME = "replayed_share.train"


def _step(k, mode, closed=True):
    return profiling.Span(name="train_step", parent=None, step=k, thread=1,
                          host_start_ns=k * 10, host_end_ns=k * 10 + 5 if closed else None,
                          mode=mode)


@pytest.mark.parametrize("modes, want", [
    (["captured", "replayed", "replayed", "replayed"], 75.0),
    (["replayed"] * 5, 100.0),
    (["eager", "eager"], 0.0),
])
def test_share_of_replayed_steps(modes, want, monkeypatch):
    spans = [_step(k, m) for k, m in enumerate(modes)] + [_step(99, "captured", closed=False)]
    spans.append(profiling.Span(name="forward", parent=0, step=0, thread=1, host_start_ns=0,
                                host_end_ns=1))
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    assert cli.reader(NAME)(None) == pytest.approx(want)


def test_nothing_to_read_without_marks(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: [_step(1, None), _step(2, None)])
    assert cli.reader(NAME)(None) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert cli.reader(NAME)(None) is None
    monkeypatch.delattr(profiling, "spans")
    assert cli.reader(NAME)(None) is None
