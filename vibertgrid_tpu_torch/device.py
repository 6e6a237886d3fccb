"""Device selection: the port runs on the card unless the caller asks for
the CPU, and never falls back to the CPU on its own."""

from __future__ import annotations

import torch

_vector_math_settled = False


def settle_vector_math() -> None:
    """Make the host's vector math functions take one code path from the
    first call on.

    torch's CPU ``exp``, ``log``, ``erf``, ``tanh`` and ``sqrt`` (MKL's vector
    math on x86 builds) initialise a shared state at their first call. When
    that call runs on two threads after a BLAS product, one thread can
    compute its half with the other code path, one ulp apart: the first
    ``exp`` of a process differed from the second in 5-16% of processes on
    an 8-core host, and a four-rank CPU train step then lost its bit
    repeatability. One call on a single element (serial) settles the state
    for every function, once a process."""
    global _vector_math_settled
    if not _vector_math_settled:
        torch.exp(torch.zeros(1))
        _vector_math_settled = True


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain versions on the host"
        )
    if dev.type == "cpu":
        settle_vector_math()
    return dev
