"""Tracing and profiling (port of ``vibertgrid_tpu/utils/profiling.py``).

- :func:`trace`: a context manager around ``torch.profiler`` that writes a
  trace TensorBoard and Chrome's ``chrome://tracing`` open; the program's
  ranges (:func:`span`) show in it beside the kernels.
- :func:`span`: a named range of the program (``train_step``, ``forward``,
  ``encoder``, ``upload``, ...). Tracing is on exactly while a
  ``torch.profiler`` session records; otherwise a span reads one flag and
  returns a shared no-op context, recording and allocating nothing.
- :func:`marking` and :func:`replay`: the ranges of a CUDA graph. While a
  graph is captured under :func:`marking`, each span opened on the
  capturing thread records a timing event at its start and end into the
  graph (:class:`Marks`), so that every replay times it on the device;
  :func:`replay` replays the graph and, while tracing is on, records those
  ranges as spans of the innermost open span, with the replay's device
  intervals and no host interval (the host issued nothing for them). A
  span opened in any other capture records nothing.
- :func:`spans`: the ranges recorded, each with its host interval and, on
  the card, its device interval; :func:`clear` forgets them.

A span recorded while tracing is on keeps its name, the span that encloses
it on its thread, the train step it belongs to and its host start and end
(:func:`host_ns`, the clock of the profiler's own event stamps); it opens
``torch.profiler.record_function(name)``; where CUDA is in use it records a
timing event at its start and at its end on the current stream. One anchor
event, recorded on an idle stream of its own when the first span opens and
stamped on the host clock there, places the device times on that clock.

A span opened with ``step=True`` (the train step) starts a new step id,
which every span it encloses shares; while it is open the synchronising
CUDA calls of the thread that opened it, and of autograd's device thread
working for it, are counted under that thread's innermost open span
(``torch.cuda.set_sync_debug_mode("warn")``, armed for the range and
disarmed after it; the library detects most, not all, such calls).

The recorder holds what was recorded since its last :func:`clear`, which
:func:`trace` calls on entry, so that it holds one profiling session's
spans; code that starts a ``torch.profiler`` session itself calls
:func:`clear` first.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
import warnings

import torch
from torch.autograd import profiler as _autograd_profiler

_NOOP = contextlib.nullcontext()
_SYNC_MESSAGE = "called a synchronizing CUDA operation"


def host_ns() -> int:
    """Nanoseconds on the clock the profiler stamps its events with (Unix
    time): spans' host times, and the device times the anchor maps."""
    return time.time_ns()


@dataclasses.dataclass
class Span:
    name: str
    parent: int | None      # index in spans() of the enclosing span on the same thread
    step: int | None        # id of the train step it lies in, None outside any step
    thread: int             # threading.get_ident() of the thread that opened it
    host_start_ns: int | None           # None for a range replayed from a CUDA graph
    host_end_ns: int | None = None      # None while open, and for a replayed range
    device_start_ns: int | None = None  # None without CUDA, or until spans() reads it
    device_end_ns: int | None = None
    syncs: int = 0          # synchronising calls made while it was the innermost open span
    mode: str | None = None  # train_step: "replayed", "captured" or "eager" (train/state.py)
    fused_share: float | None = None  # optimizer: % of the update the launch took (train/optim.py)
    _events: tuple | None = dataclasses.field(default=None, repr=False, compare=False)


class _Range:
    """A span while it is open (the on path only)."""

    def __init__(self, recorder: "Recorder", name: str, step: bool):
        self.recorder, self.name, self.step = recorder, name, step

    def __enter__(self):
        at = host_ns()
        self.function = _autograd_profiler.record_function(self.name)
        self.function.__enter__()
        self.record = self.recorder._open(self.name, self.step, at)
        return self.record

    def __exit__(self, *exc):
        self.recorder._close(self.record, self.step)
        self.function.__exit__(*exc)
        self.record.host_end_ns = host_ns()
        return False


class Marks:
    """The ranges of one CUDA graph: ``(name, index of the enclosing range
    or None, start event, end event)`` in the order they opened, the events
    external timing events recorded inside the graph."""

    def __init__(self):
        self.ranges: list[tuple] = []
        self.last = None       # the event the capture recorded last
        self.pending = None    # (anchor, [(span, start, end)]) of a traced replay not yet read
        self._open: list[int] = []


class _Mark:
    """A span opened while its thread captures under :func:`marking`."""

    def __init__(self, marks: Marks, name: str):
        self.marks, self.name = marks, name

    def __enter__(self):
        marks = self.marks
        start, end = (torch.cuda.Event(enable_timing=True, external=True) for _ in range(2))
        start.record()
        self.index = len(marks.ranges)
        marks.ranges.append((self.name, marks._open[-1] if marks._open else None, start, end))
        marks._open.append(self.index)
        return None

    def __exit__(self, *exc):
        end = self.marks.ranges[self.index][3]
        end.record()
        self.marks.last = end
        self.marks._open.pop()
        return False


class Recorder:
    """The program's spans: :func:`span`, :func:`spans` and :func:`clear`
    use the process's one recorder."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()   # .stack: (index, span) of open spans; .steps: open steps
        self._spans: list[Span] = []
        self._steps = 0
        self._anchor = None               # (event, host ns) once a span has used CUDA
        self._anchor_stream = None
        self._armed = 0                   # open step spans over all threads
        self._stepping = None             # the open spans of the thread that armed the counter
        self._restore = None              # restores the warnings and the sync mode
        self._replays: list[Marks] = []   # graphs with a traced replay not yet read

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
            self._local.steps = 0
        return stack

    def _open(self, name: str, step: bool, at_ns: int) -> Span:
        stack = self._stack()
        cuda = torch.cuda.is_initialized()
        with self._lock:
            if cuda and self._anchor is None:
                self._place_anchor()
            if step:
                self._steps += 1
            index = len(self._spans)
            parent, outer = stack[-1] if stack else (None, None)
            if parent is not None and (parent >= index or self._spans[parent] is not outer):
                parent = outer = None  # opened before the last clear()
            record = Span(name=name, parent=parent,
                          step=self._steps if step else (outer.step if outer else None),
                          thread=threading.get_ident(), host_start_ns=at_ns)
            self._spans.append(record)
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            record._events = (start, end)
        stack.append((index, record))
        if step:
            self._local.steps += 1
            self._arm(stack)
        return record

    def _close(self, record: Span, step: bool) -> None:
        if step:
            self._local.steps -= 1
            self._unarm()
        if record._events is not None:
            record._events[1].record()
        self._stack().pop()

    def _place_anchor(self) -> None:
        # The event runs on the idle stream as soon as the record call has
        # handed it over, at the call's end. A profiling session's first CUDA
        # calls can take milliseconds, so the stamp is kept only from a call
        # that took under 50 us (or the last of four).
        if self._anchor_stream is None:
            self._anchor_stream = torch.cuda.Stream()
        for _ in range(4):
            event = torch.cuda.Event(enable_timing=True)
            before = host_ns()
            event.record(self._anchor_stream)
            after = host_ns()
            if after - before < 50_000:
                break
        self._anchor = (event, after)

    def _replayed(self, marks: Marks) -> list[Span]:
        """Spans for the ranges of a replay just issued, in the innermost
        open span of this thread; their device intervals are read later."""
        stack = self._stack()
        with self._lock:
            if self._anchor is None:
                self._place_anchor()
            base = len(self._spans)
            parent, outer = stack[-1] if stack else (None, None)
            if parent is not None and (parent >= base or self._spans[parent] is not outer):
                parent = outer = None  # opened before the last clear()
            pending = []
            for name, inner, start, end in marks.ranges:
                record = Span(name=name, parent=parent if inner is None else base + inner,
                              step=outer.step if outer else None,
                              thread=threading.get_ident(), host_start_ns=None)
                self._spans.append(record)
                pending.append((record, start, end))
            marks.pending = (self._anchor, pending)
            if not any(m is marks for m in self._replays):
                self._replays.append(marks)
        return [record for record, _, _ in pending]

    def _settle(self, marks: Marks) -> None:
        """Read the device intervals of ``marks``' last traced replay (this
        waits for that replay), before a new replay records over them."""
        with self._lock:
            taken, marks.pending = marks.pending, None
        if taken is None:
            return
        (event, at), pending = taken
        marks.last.synchronize()
        for record, start, end in pending:
            record.device_start_ns = at + round(event.elapsed_time(start) * 1e6)
            record.device_end_ns = at + round(event.elapsed_time(end) * 1e6)

    # ---- the sync counter ----

    def _arm(self, stack: list) -> None:
        with self._lock:
            self._armed += 1
            if self._armed > 1:
                return
            self._stepping = stack
            caught = warnings.catch_warnings()
            caught.__enter__()
            warnings.filterwarnings("always", message=_SYNC_MESSAGE, category=UserWarning)
            shown = warnings.showwarning
            warnings.showwarning = lambda *a, **k: self._warned(shown, *a, **k)
            mode = torch.cuda.get_sync_debug_mode() if torch.cuda.is_available() else None
            if mode == 0:
                torch.cuda.set_sync_debug_mode("warn")

            def restore():
                if mode == 0:
                    torch.cuda.set_sync_debug_mode(0)
                caught.__exit__(None, None, None)

            self._restore = restore

    def _unarm(self) -> None:
        with self._lock:
            self._armed -= 1
            if self._armed == 0:
                self._restore()
                self._restore = self._stepping = None

    def _warned(self, shown, message, category, *args, **kwargs) -> None:
        if not (issubclass(category, UserWarning) and str(message).startswith(_SYNC_MESSAGE)):
            shown(message, category, *args, **kwargs)
            return
        # Counted: a sync of a thread inside a step, and one of autograd's
        # device thread, which runs the backward (a custom Function's in
        # Python) that the step's thread waits on. Any other thread's warning
        # exists only because the mode is armed, and is dropped.
        if getattr(self._local, "steps", 0) > 0:
            stack = self._local.stack
        elif torch._C._current_graph_task_id() != -1:
            stack = self._stepping
        else:
            return
        if stack:
            stack[-1][1].syncs += 1

    # ---- reading ----

    def spans(self) -> list[Span]:
        """Every span recorded since the last :meth:`clear`, in the order
        they opened; closed spans that used CUDA get their device interval
        (this waits for the device)."""
        with self._lock:
            out, anchor = list(self._spans), self._anchor
            replays, self._replays = self._replays, []
        for marks in replays:
            self._settle(marks)
        pending = [s for s in out if s._events is not None and s.host_end_ns is not None]
        if pending and anchor is not None:
            torch.cuda.synchronize()
            event, at = anchor
            for s in pending:
                start, end = s._events
                s.device_start_ns = at + round(event.elapsed_time(start) * 1e6)
                s.device_end_ns = at + round(event.elapsed_time(end) * 1e6)
                s._events = None
        return out

    def clear(self) -> None:
        with self._lock:
            self._spans = []
            self._steps = 0
            self._anchor = None
            for marks in self._replays:
                marks.pending = None
            self._replays = []


_RECORDER = Recorder()


def span(name: str, step: bool = False):
    """A context manager: the range ``name`` of the program, recorded while
    a ``torch.profiler`` session records, else a shared no-op. ``step``:
    the range is a train step (a new step id; its thread's syncs counted)."""
    if _MARKING:
        marks = getattr(_LOCAL, "marks", None)
        if marks is not None:
            return _Mark(marks, name)
    if not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    if torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing():
        return _NOOP
    return _Range(_RECORDER, name, step)


_MARKING = 0                   # threads inside marking(), read first by span()
_LOCAL = threading.local()     # .marks: what this thread's capture records into


@contextlib.contextmanager
def marking(marks: Marks):
    """For the ``with`` block, the spans this thread opens record their
    ranges into ``marks``: open it around a CUDA graph's capture."""
    global _MARKING
    with _RECORDER._lock:
        _MARKING += 1
    _LOCAL.marks = marks
    try:
        yield marks
    finally:
        _LOCAL.marks = None
        with _RECORDER._lock:
            _MARKING -= 1


def replay(graph, marks: Marks) -> list[Span]:
    """Replay ``graph``, captured under :func:`marking` into ``marks``; while
    tracing is on, its ranges become spans of this thread's innermost open
    span, which are returned (else none). The last traced replay of the
    same graph is read first (waiting for it, where it still runs), as this
    one records over its events."""
    _RECORDER._settle(marks)
    graph.replay()
    if _autograd_profiler._is_profiler_enabled and marks.ranges and marks.last is not None:
        return _RECORDER._replayed(marks)
    return []


def spans() -> list[Span]:
    """The spans recorded since the last :func:`clear` (see :meth:`Recorder.spans`)."""
    return _RECORDER.spans()


def clear() -> None:
    """Forget every recorded span and the anchor."""
    _RECORDER.clear()


@contextlib.contextmanager
def trace(logdir: str = "./log/torch-trace"):
    """Profile the host and, where one is present, the card for the length
    of the ``with`` block and write the trace under ``logdir`` (a
    ``*.pt.trace.json`` file per call, TensorBoard's layout); yields
    ``logdir``. The spans of an earlier session are forgotten on entry, so
    :func:`spans` afterwards reads this block's."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    clear()
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield logdir
