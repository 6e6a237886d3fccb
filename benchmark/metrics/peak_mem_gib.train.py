"""GiB at the device allocator's peak (``torch.cuda.max_memory_allocated``)
over set-up and the window, on the fullest card."""


def read(probe):
    return probe.memory_peak_bytes / 2**30 if probe.memory_peak_bytes else None
