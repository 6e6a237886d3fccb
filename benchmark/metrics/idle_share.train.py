"""Percent of the traced window in which nothing ran on the card (one card:
the cell trains on one)."""


def read(probe):
    t = probe.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
