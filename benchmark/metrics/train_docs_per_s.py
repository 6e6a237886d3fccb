"""Documents whose train step completed in the window, over the window: the
window runs from a synchronised start to the synchronised end of the last
step it issued."""


def read(probe):
    if not probe.steps or probe.window_s <= 0:
        return None
    return probe.docs / probe.window_s
