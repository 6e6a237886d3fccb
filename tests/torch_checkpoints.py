"""The port's tests leave no checkpoints behind.

A checkpoint of the tiny config is 150-250 MB (the parameters and both
optimizers' state), and pytest keeps the temporary directories of its last
three runs, so the files go once their tests have read them back:
:func:`drop_checkpoints` in a module fixture's teardown, and
:func:`checkpoints_dropped` as a test module's autouse fixture for the
files a test writes under its own ``tmp_path``.
"""

from __future__ import annotations

from pathlib import Path

import pytest

SUFFIXES = (".pt", ".pth")


def drop_checkpoints(root) -> None:
    """Delete every ``.pt`` / ``.pth`` file under ``root``."""
    for path in Path(root).rglob("*"):
        if path.suffix in SUFFIXES and path.is_file():
            path.unlink()


@pytest.fixture
def checkpoints_dropped(tmp_path):
    yield
    drop_checkpoints(tmp_path)
