"""EPHOIE label generation.

Port of ViBERTgrid-PyTorch's ``pipeline/ephoie_data_preprocessing.py``: the EPHOIE
annotations are per-image json dicts of segments with a quad ``box``, the
``string``, a per-char ``tag`` list and a KEY/VALUE ``class``. Emitters:

- ``char``: one CSV row per character, the segment box split into equal-width
  char boxes (:321-392).
- ``char_BIO``: same, with classes converted to B/I tag indices
  (``c*2-1`` on class change, ``c*2`` on continuation — :234-318).
- ``ltp``: LTP word segmentation over each segment (:152-231); requires the
  optional ``ltp`` package.

``generate_json`` copies the txt labels to ``_label_json`` (the EPHOIE txt
files already contain JSON — :63-91).

    python -m vibertgrid_tpu_torch.preprocessing.ephoie --root EPHOIE/ --mode char
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

from vibertgrid_tpu_torch.preprocessing.common import write_label_csv

TAG_TO_IDX = {
    "O": 0,
    "B-grade": 1, "I-grade": 2,
    "B-subject": 3, "I-subject": 4,
    "B-school": 5, "I-school": 6,
    "B-testtime": 7, "I-testtime": 8,
    "B-class": 9, "I-class": 10,
    "B-name": 11, "I-name": 12,
    "B-testno": 13, "I-testno": 14,
    "B-score": 15, "I-score": 16,
    "B-seatno": 17, "I-seatno": 18,
    "B-studentno": 19, "I-studentno": 20,
    "B-testadmissionno": 21, "I-testadmissionno": 22,
}
IDX_TO_TAG = {v: k for k, v in TAG_TO_IDX.items()}


def generate_json(root_dir_txt_label: str, root_dir_json_label: str) -> None:
    os.makedirs(root_dir_json_label, exist_ok=True)
    for fname in os.listdir(root_dir_txt_label):
        shutil.copy(
            os.path.join(root_dir_txt_label, fname),
            os.path.join(root_dir_json_label, fname.replace("txt", "json")),
        )


def _segment_geometry(segment: dict):
    xs = segment["box"][::2]
    ys = segment["box"][1::2]
    left, top = int(min(xs)), int(min(ys))
    right, bot = int(max(xs)), int(max(ys))
    n = len(segment["string"])
    char_width = (right - left + n - 1) // n
    return left, top, right, bot, char_width, n


def _char_class(segment: dict, idx: int, discard_key: bool) -> int:
    if discard_key and segment["class"] == "KEY":
        return 0
    return int(segment["tag"][idx])


def parse_char(annotation: dict, discard_key: bool = False) -> list[dict]:
    rows = []
    for segment in annotation.values():
        left, top, right, bot, cw, n = _segment_geometry(segment)
        cur = left
        for i in range(n):
            cls = _char_class(segment, i, discard_key)
            rows.append(
                dict(left=cur, top=top, right=cur + cw, bot=bot,
                     text=str(segment["string"][i]), data_class=cls,
                     pos_neg=2 if cls == 0 else 1)
            )
            cur += cw
    return rows


def parse_char_bio(annotation: dict, discard_key: bool = False) -> list[dict]:
    rows = []
    prev = -1
    for segment in annotation.values():
        left, top, right, bot, cw, n = _segment_geometry(segment)
        cur = left
        for i in range(n):
            cls = _char_class(segment, i, discard_key)
            if cls != 0:
                cvt = cls * 2 - 1 if cls != prev else cls * 2
            else:
                cvt = 0
            prev = cls
            rows.append(
                dict(left=cur, top=top, right=cur + cw, bot=bot,
                     text=str(segment["string"][i]), data_class=cvt,
                     pos_neg=2 if cls == 0 else 1,
                     class_str=IDX_TO_TAG[cvt])
            )
            cur += cw
    return rows


def parse_ltp(annotation: dict, discard_key: bool = False) -> list[dict]:
    """LTP word-level rows (ref :152-231); needs the optional ltp package."""
    from ltp import LTP  # hard requirement for this mode, like the reference

    ltp = LTP()
    rows = []
    for segment in annotation.values():
        left, top, right, bot, cw, n = _segment_geometry(segment)
        words = ltp.seg([segment["string"]])[0][0]
        start = 0
        cur = left
        for word in words:
            wlen = len(word)
            cls = _char_class(segment, start, discard_key)
            w_right = cur + cw * wlen
            rows.append(
                dict(left=cur, top=top, right=w_right, bot=bot, text=word,
                     data_class=cls, pos_neg=2 if cls == 0 else 1)
            )
            cur = w_right
            start += wlen
    return rows


_MODES = {"char": parse_char, "char_BIO": parse_char_bio, "ltp": parse_ltp}


def data_preprocessing_pipeline(
    root_dir_image: str,
    root_dir_json_label: str,
    root_dir_csv_label: str,
    mode: str,
    discard_key: bool = False,
):
    assert mode in _MODES, f"mode must be in {list(_MODES)}"
    os.makedirs(root_dir_csv_label, exist_ok=True)
    extra = ["class_str"] if mode == "char_BIO" else []
    for fname in sorted(os.listdir(root_dir_image)):
        with open(
            os.path.join(root_dir_json_label, fname.replace("jpg", "json")), "rb"
        ) as f:
            annotation = json.load(f)
        rows = _MODES[mode](annotation, discard_key)
        write_label_csv(
            os.path.join(root_dir_csv_label, fname.replace("jpg", "csv")),
            rows,
            extra_cols=extra,
        )


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", required=True)
    parser.add_argument("--mode", default="char", choices=list(_MODES))
    parser.add_argument("--discard_key", action="store_true")
    args = parser.parse_args(argv)
    image_root = os.path.join(args.root, "image")
    txt_root = os.path.join(args.root, "label")
    json_root = os.path.join(args.root, "_label_json")
    csv_root = os.path.join(args.root, "_label_csv")
    if not os.path.exists(json_root):
        generate_json(txt_root, json_root)
    data_preprocessing_pipeline(image_root, json_root, csv_root, args.mode,
                                args.discard_key)


if __name__ == "__main__":
    main()
