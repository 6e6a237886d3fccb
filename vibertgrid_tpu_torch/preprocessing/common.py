"""Shared CSV emission helpers for the preprocessing CLIs."""

from __future__ import annotations

import csv
import os

COLUMNS = ["left", "top", "right", "bot", "text", "data_class", "pos_neg"]


def write_label_csv(path: str, rows: list[dict], extra_cols: list[str] = ()):
    """Write rows in the reference's CSV format (leading unnamed index column
    like pandas ``to_csv``)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    cols = COLUMNS + list(extra_cols)
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f)
        writer.writerow([""] + cols)
        for i, row in enumerate(rows):
            writer.writerow([i] + [row.get(c, "") for c in cols])


def image_shape(path: str) -> tuple[int, int]:
    from PIL import Image

    with Image.open(path) as img:
        w, h = img.size
    return h, w
