"""The readers of the program's own ranges (``benchmark/metrics/_spans.py``) on
a hand-built list of spans: each metric's value, and nothing to read where
the program recorded nothing, has no recorder, or ran without CUDA."""

import pytest

from benchmark.harness import cli
from vibertgrid_tpu_torch.utils import profiling

MS = 1_000_000  # nanoseconds


def _span(name, step, host, device=None, syncs=0):
    return profiling.Span(name=name, parent=None, step=step, thread=1,
                          host_start_ns=host[0] * MS, host_end_ns=host[1] * MS,
                          device_start_ns=None if device is None else device[0] * MS,
                          device_end_ns=None if device is None else device[1] * MS, syncs=syncs)


def _step(k, t, syncs):
    """Step ``k`` from ``t`` ms: host and device intervals in ms."""
    return [
        _span("train_step", k, (t, t + 100), (t + 1, t + 150)),
        _span("forward", k, (t, t + 40 + k), (t + 1, t + 60)),
        _span("encoder", k, (t, t + 20), (t + 1, t + 31 + k)),
        _span("backbone", k, (t + 20, t + 30), (t + 31, t + 45)),
        _span("heads", k, (t + 30, t + 32), (t + 45, t + 48), syncs=syncs),
        _span("roi_align", k, (t + 32, t + 33), (t + 48, t + 50)),
        _span("heads", k, (t + 33, t + 40), (t + 50, t + 55)),
        _span("backward", k, (t + 40, t + 70), (t + 60, t + 130 + 2 * k)),
        _span("optimizer", k, (t + 70, t + 100), (t + 130, t + 150)),
    ]


SPANS = [
    _span("upload", None, (0, 3), (1, 2)),
    _span("loader_wait", None, (0, 1), (1, 1)),
    *_step(1, 1, syncs=1),
    _span("upload", None, (5, 9), (6, 10)),
    _span("loader_wait", None, (101, 104), (151, 151)),
    *_step(2, 104, syncs=0),
    _span("upload", None, (120, 125), (121, 123)),
    # a step still open when the window ended: not read
    profiling.Span(name="train_step", parent=None, step=3, thread=1, host_start_ns=300 * MS,
                   syncs=5),
    _span("forward", 3, (300, 340), (300, 340)),
]

EXPECTED = {
    "stream_ms.encoder.train": (31 + 32) / 2,
    "stream_ms.backbone.train": 14.0,
    "stream_ms.roi_align.train": 2.0,
    "stream_ms.heads.train": 3.0 + 5.0,
    "stream_ms.backward.train": (72 + 74) / 2,
    "stream_ms.optimizer.train": 20.0,
    "host_ms.loader_wait.train": (1 + 3) / 2,
    "host_ms.upload.train": (3 + 4 + 5) / 3,
    "stream_ms.upload.train": (1 + 4 + 2) / 3,
    "host_syncs.train": 0.5,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_reader_on_hand_built_spans(name, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(SPANS))
    assert cli.reader(name)(None) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_nothing_to_read_without_spans(name, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert cli.reader(name)(None) is None
    monkeypatch.delattr(profiling, "spans")  # the parent's program has no recorder
    assert cli.reader(name)(None) is None


@pytest.mark.parametrize("name", sorted(n for n in EXPECTED if n.startswith("stream_ms.")))
def test_no_device_interval_without_cuda(name, monkeypatch):
    host_only = [profiling.Span(name=s.name, parent=None, step=s.step, thread=1,
                                host_start_ns=s.host_start_ns, host_end_ns=s.host_end_ns)
                 for s in SPANS]
    monkeypatch.setattr(profiling, "spans", lambda: host_only)
    assert cli.reader(name)(None) is None


def test_every_new_reader_is_in_the_benchmark():
    _, layer = cli.benchmark_entries("train-roberta-r18d-b16")
    assert set(EXPECTED) <= {m["name"] for m in layer}
