"""The program's own ranges (``vibertgrid_tpu_torch/utils/profiling.py``),
recorded while the traced window's profiler runs: means over the window's
train steps, or over the loader's batches. Nothing to read where the
program records no ranges (a tree without the recorder) or recorded none,
or, for a device interval, where the ranges ran without CUDA."""


def recorded():
    try:
        from vibertgrid_tpu_torch.utils import profiling
    except ImportError:
        return None
    spans = getattr(profiling, "spans", None)
    return (spans() or None) if spans is not None else None


def _ms(span, device: bool):
    start, end = ((span.device_start_ns, span.device_end_ns) if device
                  else (span.host_start_ns, span.host_end_ns))
    return None if start is None or end is None else (end - start) / 1e6


def _steps(spans) -> set:
    return {s.step for s in spans if s.name == "train_step" and s.host_end_ns is not None}


def per_step(name: str, device: bool = False):
    """Mean milliseconds a train step of the ranges ``name`` in it (host or
    device intervals, summed within the step)."""
    spans = recorded()
    steps = _steps(spans or ())
    ms = [_ms(s, device) for s in spans or () if s.name == name and s.step in steps]
    if not steps or not ms or None in ms:
        return None
    return sum(ms) / len(steps)


def per_batch(name: str, device: bool = False):
    """Mean milliseconds of the closed ranges ``name`` (one a batch)."""
    ms = [_ms(s, device) for s in recorded() or () if s.name == name and s.host_end_ns is not None]
    if not ms or None in ms:
        return None
    return sum(ms) / len(ms)


def syncs_per_step():
    """Mean synchronising calls a train step, counted in every range of it."""
    spans = recorded()
    steps = _steps(spans or ())
    if not steps:
        return None
    return sum(s.syncs for s in spans if s.step in steps) / len(steps)
