"""The port's ranges (``vibertgrid_tpu_torch/utils/profiling.py``) on the CPU:

- with the profiler off, ``span()`` is one shared no-op and records nothing;
- under a CPU profiler a tiny train step (``TextEncoderConfig.tiny``,
  ``resnet_18_fpn``) records ``train_step`` > ``forward`` > (``encoder``,
  ``backbone``, ``heads``, ``roi_align``, ``heads``), ``backward``,
  ``optimizer``, each step's spans sharing its id, every child inside its
  parent;
- the ranges are the profiler's ``record_function`` events, on its clock;
- two steps traced and untraced give the same bits;
- ``prefetch_to_device`` records ``upload`` (producer thread) and
  ``loader_wait`` (consumer) a batch;
- a CUDA graph's captured ranges, replayed under the profiler, become
  spans of the open step with device intervals and no host interval;
- the sync counter, fed the warning that ``set_sync_debug_mode("warn")``
  raises, counts the step's thread under its innermost range and no other
  thread; on the card (``cuda``) a real ``.item()``, and one in a custom
  backward, which autograd runs on its device thread.

Imports neither JAX nor the JAX package, so the card runs the ``cuda`` test:
``python -m pytest --noconftest -m cuda tests/test_torch_tracing.py``.
"""

import contextlib
import dataclasses
import json
import os
import threading
import types
import warnings

import numpy as np
import pytest
import torch

from vibertgrid_tpu_torch.data.dataset import prefetch_to_device
from vibertgrid_tpu_torch.entry import FLAGSHIP_TRAIN, train_entry
from vibertgrid_tpu_torch.models.vibertgrid import Batch
from vibertgrid_tpu_torch.train.seeds import step_seeds
from vibertgrid_tpu_torch.utils import profiling
from vibertgrid_tpu_torch.utils.profiling import span, spans

TINY = dataclasses.replace(
    FLAGSHIP_TRAIN, bert_version="tiny-bert-test", backbone="resnet_18_fpn",
    compute_dtype=torch.float32, num_hard_positive_main_1=2, num_hard_negative_main_1=2,
    num_hard_positive_main_2=2, num_hard_negative_main_2=2, loss_aux_sample_list=[16, 32, 16],
    num_hard_positive_aux=16, num_hard_negative_aux=16)
SHAPE = dict(b=2, h=64, w=64, t=510, s=8, vocab=512)
STEP = ["train_step", "forward", "encoder", "backbone", "heads", "roi_align", "heads",
        "backward", "optimizer"]
PARENT = {"train_step": None, "forward": "train_step", "encoder": "forward",
          "backbone": "forward", "heads": "forward", "roi_align": "forward",
          "backward": "train_step", "optimizer": "train_step"}
SYNC = "called a synchronizing CUDA operation (as torch words it)"


def _profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _steps(n, traced, device="cpu"):
    """``n`` steps of one tiny state; ``(losses, parameters, profiler)``."""
    profiling.clear()
    state, train_step, batch = train_entry(device, config=TINY, shape=SHAPE)
    losses = []
    with (_profiler() if traced else contextlib.nullcontext()) as prof:
        if traced:
            with span("warm-up"):  # a process's first record_function pays a one-off cost
                pass
        for _ in range(n):
            state, loss = train_step(state, batch, step_seeds(7, state.step))
            losses.append(loss)
    params = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    return losses, params, prof


@pytest.fixture(scope="module")
def traced_steps():
    losses, params, prof = _steps(2, traced=True)
    return losses, params, prof, spans()


def test_a_span_without_the_profiler_is_the_shared_noop():
    profiling.clear()
    assert span("a") is span("b", step=True) is profiling._NOOP
    with span("train_step", step=True), span("forward"):
        pass
    assert spans() == []


def test_a_traced_train_step_records_its_tree(traced_steps):
    *_, recorded = traced_steps
    assert recorded[0].name == "warm-up"
    steps = recorded[1:]
    assert [s.name for s in steps] == STEP * 2
    main = threading.get_ident()
    for k, step_id in enumerate((1, 2)):
        own = steps[k * len(STEP):(k + 1) * len(STEP)]
        assert {s.step for s in own} == {step_id}
        for s in own:
            assert s.thread == main and s.syncs == 0 and s.device_start_ns is None
            assert s.host_start_ns <= s.host_end_ns
            if PARENT[s.name] is None:
                assert s.parent is None
                continue
            parent = recorded[s.parent]
            assert parent.name == PARENT[s.name] and parent.step == step_id
            assert parent.host_start_ns <= s.host_start_ns <= s.host_end_ns <= parent.host_end_ns
        # siblings in code order, one after the other
        forward = [s for s in own if s.parent is not None and recorded[s.parent].name == "forward"]
        assert all(a.host_end_ns <= b.host_start_ns for a, b in zip(forward, forward[1:]))


def test_the_ranges_are_record_function_events_on_the_profilers_clock(traced_steps):
    *_, prof, recorded = traced_steps
    names = set(STEP)
    events = sorted((e for e in prof.profiler.kineto_results.events() if e.name() in names),
                    key=lambda e: e.start_ns())
    ours = [s for s in recorded if s.name in names]
    assert [e.name() for e in events] == [s.name for s in ours]
    for e, s in zip(events, ours):
        assert abs(e.start_ns() - s.host_start_ns) < 100_000, (s.name, e.start_ns() - s.host_start_ns)
        assert abs(e.start_ns() + e.duration_ns() - s.host_end_ns) < 100_000, s.name


def test_tracing_changes_no_bit_of_two_steps(traced_steps):
    losses, params, *_ = traced_steps
    plain_losses, plain_params, _ = _steps(2, traced=False)
    assert spans() == []
    for a, b in zip(losses, plain_losses):
        assert torch.equal(a, b)
    assert params.keys() == plain_params.keys()
    for name in params:
        assert torch.equal(params[name], plain_params[name]), name


def _batch(k):
    rng = np.random.default_rng(k)
    return Batch(images=rng.standard_normal((1, 32, 32, 3)).astype(np.float32),
                 tokens=np.full((1, 510), k, np.int32), token_mask=np.ones((1, 510), np.int32),
                 seg_ids=np.zeros((1, 510), np.int32), boxes=np.zeros((1, 4, 4), np.int32),
                 box_mask=np.ones((1, 4), bool), seg_classes=np.zeros((1, 4), np.int32))


def test_prefetch_records_upload_and_loader_wait_a_batch():
    profiling.clear()
    with _profiler():
        got = [int(b.tokens[0, 0]) for b, _ in
               prefetch_to_device(((_batch(k), None) for k in range(3)), "cpu")]
    assert got == [0, 1, 2]
    recorded = spans()
    uploads = [s for s in recorded if s.name == "upload"]
    waits = [s for s in recorded if s.name == "loader_wait"]
    main = threading.get_ident()
    assert len(uploads) == 3 and {s.thread for s in uploads} != {main}
    # one wait a batch, and one that receives the end of the feed
    assert len(waits) == 4 and {s.thread for s in waits} == {main}
    assert all(s.parent is None and s.step is None and s.host_end_ns is not None
               for s in uploads + waits)


def test_the_sync_counter_counts_the_steps_thread_under_its_innermost_range():
    profiling.clear()
    shown = warnings.showwarning
    other = threading.Thread(target=lambda: warnings.warn(SYNC, UserWarning))
    with _profiler():
        warnings.warn(SYNC, UserWarning)  # outside any step: not counted
        with span("train_step", step=True):
            with span("forward"):
                warnings.warn(SYNC, UserWarning)
                warnings.warn(SYNC, UserWarning)
                other.start()
                other.join(timeout=10)
            with span("backward"):
                warnings.warn(SYNC, UserWarning)
            warnings.warn(SYNC, UserWarning)
        with span("train_step", step=True):
            pass
    assert not other.is_alive()
    assert warnings.showwarning is shown
    got = {(s.name, s.step): s.syncs for s in spans()}
    assert got == {("train_step", 1): 1, ("forward", 1): 2, ("backward", 1): 1,
                   ("train_step", 2): 0}


def test_trace_forgets_the_last_session_and_writes_the_ranges(tmp_path):
    profiling.clear()
    with _profiler():
        with span("earlier"):
            pass
    assert [s.name for s in spans()] == ["earlier"]
    with profiling.trace(str(tmp_path / "trace")) as logdir:
        with span("train_step", step=True):
            torch.nn.functional.linear(torch.randn(8, 16), torch.randn(32, 16))
    assert [(s.name, s.step) for s in spans()] == [("train_step", 1)]
    files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "train_step" for e in events)


class _Stamp:
    """A stand-in for a timing event: ``ms`` after the anchor's stamp."""

    def __init__(self, ms: float):
        self.ms = ms

    def elapsed_time(self, other) -> float:
        return other.ms - self.ms

    def synchronize(self) -> None:
        pass


def test_a_replays_ranges_become_spans_of_the_open_step_on_the_device_only():
    """``replay`` records a graph's captured ranges in the open train step,
    nested as captured, with device intervals from their events and no
    host interval; a replay of the same graph first reads the last one's
    events, which the new replay then records over."""
    marks = profiling.Marks()
    stamps = [_Stamp(ms) for ms in (1.0, 5.0, 1.5, 3.0, 5.0, 9.0)]
    marks.ranges = [("forward", None, *stamps[0:2]), ("encoder", 0, *stamps[2:4]),
                    ("backward", None, *stamps[4:6])]
    marks.last = stamps[5]

    def record_again():  # the replay's events record anew, 100 ms later
        for stamp in stamps:
            stamp.ms += 100.0

    graph = types.SimpleNamespace(replay=record_again)
    profiling.clear()
    profiling.replay(graph, marks)  # no profiler: nothing recorded
    assert marks.pending is None and spans() == []
    try:
        with _profiler():
            profiling._RECORDER._anchor = (_Stamp(0.0), 10**9)
            for _ in range(2):
                with span("train_step", step=True):
                    profiling.replay(graph, marks)
        recorded = spans()
    finally:
        profiling.clear()
    assert [(s.name, s.step) for s in recorded] == [
        (name, k) for k in (1, 2) for name in ("train_step", "forward", "encoder", "backward")]
    for k, offset in ((0, 200.0), (4, 300.0)):
        top, forward, encoder, backward = recorded[k:k + 4]
        assert (forward.parent, encoder.parent, backward.parent) == (k, k + 1, k)
        assert top.host_start_ns is not None and top.device_start_ns is None
        for s, (a, b) in ((forward, (1.0, 5.0)), (encoder, (1.5, 3.0)), (backward, (5.0, 9.0))):
            assert s.host_start_ns is None and s.host_end_ns is None and s.syncs == 0
            assert (s.device_start_ns, s.device_end_ns) == (
                10**9 + round((a + offset) * 1e6), 10**9 + round((b + offset) * 1e6))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the GPU: python -m pytest --noconftest -m cuda)")
    return torch.device("cuda")


class _SyncInBackward(torch.autograd.Function):
    """Doubles its input; its backward reads a value back to the host (on
    the card autograd runs it on its own device thread)."""

    @staticmethod
    def forward(ctx, a):
        return a * 2

    @staticmethod
    def backward(ctx, g):
        g.sum().item()
        return g * 2


@pytest.mark.cuda
def test_a_host_sync_in_a_step_counts_once_on_cuda(cuda_device):
    x = torch.ones(4, device=cuda_device, requires_grad=True)
    torch.cuda.synchronize()
    profiling.clear()
    mode = torch.cuda.get_sync_debug_mode()
    other = threading.Thread(target=lambda: (x * 3).sum().item())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        with span("train_step", step=True):
            with span("forward"):
                y = _SyncInBackward.apply(x).sum()
                y.detach().item()
                other.start()
                other.join(timeout=30)
            with span("backward"):
                y.backward()
    assert not other.is_alive()
    assert torch.cuda.get_sync_debug_mode() == mode
    recorded = spans()
    assert {s.name: s.syncs for s in recorded} == {"train_step": 0, "forward": 1, "backward": 1}
    step, forward, backward = recorded
    for s in recorded:
        assert s.device_start_ns is not None and s.device_start_ns <= s.device_end_ns
    assert step.device_start_ns <= forward.device_start_ns <= forward.device_end_ns
    assert backward.device_end_ns <= step.device_end_ns
