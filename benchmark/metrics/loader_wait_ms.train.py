"""Mean host milliseconds the step loop waited in ``next()`` on the
``prefetch_to_device`` iterator, over the window's steps."""


def read(probe):
    waits = probe.in_window("loader_wait")
    return 1e3 * sum(t1 - t0 for t0, t1, _ in waits) / len(waits) if waits else None
