"""FUNSD label generation.

Port of ViBERTgrid-PyTorch's ``pipeline/funsd_data_preprocessing.py``: parse the
FUNSD JSON annotations into per-image CSVs at word level (:12-47) or segment
level (:50-88), for both training_data/ and testing_data/.

Divergences from the reference, by design:
- ``pos_neg`` compares the *string* label against 0 there (:21, :65), so
  every row got 1; we emit 2 for 'other' and 1 otherwise (the documented
  semantics — the column is unused downstream either way).
- the odd ``text = Literal["N/A"]`` lines (:28, :62-64) — an accidental
  typing-construct assignment — become keeping the literal text.

    python -m vibertgrid_tpu_torch.preprocessing.funsd --root FUNSD/ --mode seg
"""

from __future__ import annotations

import argparse
import json
import os

from vibertgrid_tpu_torch.preprocessing.common import write_label_csv

FUNSD_CLASS_INDEX = {"other": 0, "question": 1, "answer": 2, "header": 3}


def _rows_word(annotation: dict) -> list[dict]:
    rows = []
    for seg in annotation["form"]:
        label = seg["label"]
        cls = FUNSD_CLASS_INDEX[label]
        pos_neg = 2 if cls == 0 else 1
        for word in seg["words"]:
            text = word["text"]
            if len(text) == 0:
                continue
            x0, y0, x1, y1 = word["box"]
            rows.append(
                dict(left=x0, top=y0, right=x1, bot=y1, text=text,
                     data_class=cls, pos_neg=pos_neg)
            )
    return rows


def _rows_seg(annotation: dict) -> list[dict]:
    rows = []
    for seg in annotation["form"]:
        text = seg["text"]
        if len(text) == 0:
            continue
        cls = FUNSD_CLASS_INDEX[seg["label"]]
        pos_neg = 2 if cls == 0 else 1
        x0, y0, x1, y1 = seg["box"]
        rows.append(
            dict(left=x0, top=y0, right=x1, bot=y1, text=text,
                 data_class=cls, pos_neg=pos_neg)
        )
    return rows


_MODES = {"word": _rows_word, "seg": _rows_seg}


def run_annotation_parser(root: str, mode: str):
    assert mode in _MODES, f"mode must be one of {list(_MODES)}"
    for subset in ("training_data", "testing_data"):
        ann_dir = os.path.join(root, subset, "annotations")
        out_dir = os.path.join(root, subset, "_label_csv")
        os.makedirs(out_dir, exist_ok=True)
        for fname in sorted(os.listdir(ann_dir)):
            if not fname.endswith(".json"):
                continue
            with open(os.path.join(ann_dir, fname), "rb") as f:
                annotation = json.load(f)
            rows = _MODES[mode](annotation)
            write_label_csv(
                os.path.join(out_dir, fname.replace(".json", ".csv")), rows
            )


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", required=True)
    parser.add_argument("--mode", default="seg", choices=["word", "seg"])
    args = parser.parse_args(argv)
    run_annotation_parser(args.root, args.mode)


if __name__ == "__main__":
    main()
