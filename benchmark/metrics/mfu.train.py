"""Model FLOPs of the window's train steps (three forwards each, from each
step's batch shape; ``benchmark/harness/counts.py``) over the window, as a
percent of the cell's cards' bf16 peak."""

from benchmark.harness import counts


def read(probe):
    if not probe.forwards or probe.window_s <= 0:
        return None
    flops = sum(counts.step_flops(probe.model, s) for _, s in probe.forwards)
    return 100.0 * flops / probe.window_s / (counts.peaks()["bf16_flops_per_s"] * probe.chips)
