"""Seconds from the process's start to the measured window: imports,
building the program and its kernels, the weights, the warm-up."""


def read(probe):
    return probe.setup_s
