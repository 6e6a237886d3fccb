"""What a run collects for its metrics: host spans around calls into the
program, the batch shape of every forward, the steps of the window, and in a
traced run the profiler's device timeline.

Spans are taken from outside, around the harness's own calls into the
program, so nothing inside the program changes. Times are
``time.perf_counter()`` seconds.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import json
import os
import re
import time

from benchmark.harness import counts

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Trace:
    """The device's timeline over the traced window."""

    window_s: float
    busy_s: float                        # union of the intervals with an operation on the device
    kernels: dict                        # name -> [count, seconds]
    idle_gaps: list                      # [(label, seconds)], longest first
    first_at_s: float = 0.0              # the first device event after the window's start


class Probe:
    def __init__(self):
        self.spans = collections.defaultdict(list)     # name -> [(t0, t1, info)]
        self.forwards = []                             # [(t0, Shape)]
        self.window = (0.0, 0.0)                       # perf_counter at the window's ends
        self.steps = 0
        self.docs = 0
        self.setup_s = 0.0
        self.memory_peak_bytes = 0
        self.trace: Trace | None = None
        self.model = None                              # counts.Model of the cell
        self.chips = 1

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @contextlib.contextmanager
    def span(self, name: str, info=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name].append((t0, time.perf_counter(), info))

    def in_window(self, name: str):
        lo, hi = self.window
        return [s for s in self.spans.get(name, ()) if lo <= s[0] < hi]


# ---- the profiler's timeline ----

def kernel_patterns(model) -> dict:
    """``{kind: regex}`` of the kernels each roofline reads: the trunk's
    (``benchmark/kernels.json``) and the text encoder's (its ``KERNELS``);
    ``model`` a ``counts.Model``."""
    with open(os.path.join(HERE, "kernels.json")) as f:
        trunk = json.load(f)["patterns"]
    own = counts.encoder_of(model.text_encoder).KERNELS
    patterns = counts.merged(trunk, {k: pattern for k, (_, _, pattern) in own.items()})
    return {k: re.compile(v) for k, v in patterns.items()}


def _device_events(prof):
    """``[(start_ns, end_ns, name)]`` of everything the device ran."""
    out = []
    try:
        events = prof.profiler.kineto_results.events()
        for e in events:
            if str(e.device_type()).endswith("CUDA"):
                start = e.start_ns()
                out.append((start, start + e.duration_ns(), e.name()))
    except AttributeError:
        for e in prof.events():
            if str(e.device_type).endswith("CUDA"):
                out.append((int(e.time_range.start * 1e3), int(e.time_range.end * 1e3), e.name))
    out.sort()
    return out


def read_trace(prof, probe: Probe, host_at_start_ns: int, perf_at_start: float,
               top: int = 10) -> Trace:
    """The busy time (the union of the device's intervals), each kernel's
    count and seconds, and the longest idle gaps, each named by the host
    span that was open at its middle. Device times are on the profiler's
    clock, which counts nanoseconds of ``time.time_ns()``;
    ``host_at_start_ns`` / ``perf_at_start`` map it onto the spans' clock."""
    events = _device_events(prof)
    kernels = collections.defaultdict(lambda: [0, 0.0])
    busy_ns = 0
    gaps = []
    cur_start = cur_end = None
    for start, end, name in events:
        k = kernels[name]
        k[0] += 1
        k[1] += (end - start) / 1e9
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy_ns += cur_end - cur_start
                gaps.append((start - cur_end, cur_end))
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy_ns += cur_end - cur_start
    gaps.sort(reverse=True)
    opened = sorted((t0, t1, name) for name, spans in probe.spans.items()
                    for t0, t1, _ in spans)
    starts = [s[0] for s in opened]

    def label(at_ns: int, length_ns: int) -> str:
        t = perf_at_start + (at_ns + length_ns / 2 - host_at_start_ns) / 1e9
        inner = None
        for t0, t1, name in opened[max(0, bisect.bisect_right(starts, t) - 64):
                                   bisect.bisect_right(starts, t)]:
            if t0 <= t < t1 and (inner is None or t0 >= inner[0]):
                inner = (t0, name)
        return "host in " + inner[1] if inner else "host outside every span"

    idle = [(label(at, length), length / 1e9) for length, at in gaps[:top]]
    first = (events[0][0] - host_at_start_ns) / 1e9 if events else 0.0
    return Trace(window_s=probe.window_s, busy_s=busy_ns / 1e9, kernels=dict(kernels),
                 idle_gaps=idle, first_at_s=first)


@contextlib.contextmanager
def traced(probe: Probe, on: bool):
    """Profile the device over the block when ``on``; the summary lands in
    ``probe.trace``."""
    if not on:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        host_ns, perf = time.time_ns(), time.perf_counter()
        yield
        torch.cuda.synchronize()
    probe.trace = read_trace(prof, probe, host_ns, perf)


def breakdown(trace: Trace, top: int = 10) -> dict:
    ops = sorted(trace.kernels.items(), key=lambda kv: -kv[1][1])[:top]
    return {"device_ops": [[name, secs] for name, (_, secs) in ops],
            "idle_gaps": [[name, secs] for name, secs in trace.idle_gaps[:top]]}
