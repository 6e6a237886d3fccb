"""The share of a kernel's roofline: the sum of its calls' bounds
(``counts.bound_s`` of each call's operations and bytes) over the sum of the
measured time of the kernels whose names match its pattern (the trunk's
``benchmark/kernels.json`` and ``counts.CALLS``, or the text encoder's
``KERNELS``). Nothing to read where no such kernel ran."""

import dataclasses

from benchmark.harness import counts, probe as probe_mod


def share(probe, kind: str, train: bool):
    t = probe.trace
    if t is None or not probe.forwards:
        return None
    pattern = probe_mod.kernel_patterns(probe.model)[kind]
    measured = sum(secs for name, (_, secs) in t.kernels.items() if pattern.search(name))
    if measured <= 0:
        return None
    fn, per_forward = counts.calls(probe.model)[kind]
    bound = 0.0
    for _, shape in probe.forwards:
        if train:
            shape = dataclasses.replace(shape, train=True)
        bound += per_forward(probe.model) * counts.bound_s(*fn(probe.model, shape))
    return 100.0 * bound / measured
