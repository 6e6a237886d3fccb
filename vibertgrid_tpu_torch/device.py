"""Device selection: the port runs on the card unless the caller asks for
the CPU, and never falls back to the CPU on its own."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain versions on the host"
        )
    return dev
