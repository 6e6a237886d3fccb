"""Diagnostics and misc utilities."""

from vibertgrid_tpu_torch.utils.logging import MetricsLogger, TerminalLogger, setup_seed  # noqa: F401
