"""Device milliseconds a train step: the time in which an operation ran on
the card (the profiler's trace) over the window's steps."""


def read(probe):
    if probe.trace is None or not probe.steps:
        return None
    return 1e3 * probe.trace.busy_s / probe.steps
