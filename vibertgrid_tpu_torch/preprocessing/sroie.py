"""SROIE label generation.

Port of ViBERTgrid-PyTorch's ``pipeline/sroie_data_preprocessing.py``: per-image
bbox txt files (``x0,y0,x1,y1,x2,y2,x3,y3,text``) + key-info json → CSV
labels, recovering per-box classes by cosine similarity of CountVectorizer
vectors against the key strings plus date/total regex matching (:94-296);
optional word splitting by estimated character width (:166-199).

The reference's hand-rolled ``cosine_simularity`` (:20-46) is mathematically
nonstandard (it sums raw counts rather than squares for the norms and only
accumulates ``norm_b`` on the first outer iteration). Because label parity
requires the same matching decisions, ``cosine_mode='reference'`` (default)
reproduces that arithmetic exactly; ``cosine_mode='true'`` computes the real
cosine. The readme (``readme.md:36-38``) notes this auto-matching only
reaches ~60 F1 — relabeled coordinates are preferred when available.

    python -m vibertgrid_tpu_torch.preprocessing.sroie --data_root raw/ --save_root out/
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re

from vibertgrid_tpu_torch.eval.entities import _DATE_RE
from vibertgrid_tpu_torch.preprocessing.common import image_shape, write_label_csv

SROIE_CLASSES = ["company", "date", "address", "total"]


def _date_findall(text: str):
    return [m[0] for m in _DATE_RE.findall(text)]


def reference_cosine(a_vec: dict, b_vec: dict) -> float:
    """Bug-compatible similarity (sroie_data_preprocessing.py:20-46):
    norms are plain count sums; denominator sqrt(na*nb)+1e-8."""
    norm_a = sum(a_vec.values())
    norm_b = sum(b_vec.values())
    dot = sum(v * b_vec.get(k, 0) for k, v in a_vec.items())
    return dot / (math.sqrt(norm_a * norm_b) + 1e-8)


def true_cosine(a_vec: dict, b_vec: dict) -> float:
    na = math.sqrt(sum(v * v for v in a_vec.values()))
    nb = math.sqrt(sum(v * v for v in b_vec.values()))
    dot = sum(v * b_vec.get(k, 0) for k, v in a_vec.items())
    return dot / (na * nb + 1e-8)


_TOKEN_RE = re.compile(r"(?u)\b\w\w+\b")  # sklearn CountVectorizer default


def count_vector(text: str) -> dict:
    vec: dict = {}
    for tok in _TOKEN_RE.findall(text.lower()):
        vec[tok] = vec.get(tok, 0) + 1
    return vec


def ground_truth_extraction(
    dir_img: str,
    dir_bbox: str,
    dir_key: str,
    data_classes=SROIE_CLASSES,
    cosine_sim_treshold: float = 0.4,
    spilt_word: bool = False,
    cosine_mode: str = "reference",
):
    """→ (rows, image_shape); rows are CSV dicts."""
    img_shape = image_shape(dir_img)
    cosine = reference_cosine if cosine_mode == "reference" else true_cosine

    rows: list[dict] = []
    with open(dir_bbox, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.split(",", maxsplit=8)
            if len(parts) < 8:
                continue  # discard invalid lines (ref :155-156)
            left, top = int(parts[0]), int(parts[1])
            right, bot = int(parts[4]), int(parts[5])
            text = "".join(parts[8:]).replace("\n", "")

            if spilt_word:
                # estimated char width word split (ref :166-199)
                words = text.split(" ")
                char_len = (right - left) / max(len(text), 1)
                edge = left
                for word in words:
                    rows.append(
                        dict(
                            left=edge,
                            top=top,
                            right=int(edge + len(word) * char_len),
                            bot=bot,
                            text=word,
                            data_class=0,
                            pos_neg=2,
                        )
                    )
                    edge += int((len(word) + 1) * char_len)
            else:
                rows.append(
                    dict(
                        left=left, top=top, right=right, bot=bot,
                        text=text, data_class=0, pos_neg=2,
                    )
                )

    with open(dir_key, "r", encoding="utf-8") as f:
        key_info = json.load(f)
    for dc in data_classes:
        key_info[dc] = key_info.get(dc, "UNKNOWN").upper()

    key_vecs = {dc: count_vector(key_info[dc]) for dc in data_classes}
    total_match = re.search(r"([-+]?[0-9]*\.?[0-9]+)", key_info["total"])

    for row in rows:
        vec = count_vector(str(row["text"]))
        # company / address by cosine similarity (ref :228-248)
        if cosine(key_vecs["company"], vec) > cosine_sim_treshold:
            row["data_class"], row["pos_neg"] = 1, 1
        if cosine(key_vecs["address"], vec) > cosine_sim_treshold:
            row["data_class"], row["pos_neg"] = 3, 1
        # date by regex exact match (ref :250-286)
        for date in _date_findall(str(row["text"])):
            if date == key_info["date"]:
                row["data_class"], row["pos_neg"] = 2, 1
        # total by float equality (ref :288-294)
        if total_match:
            for fl in re.findall(r"([-+]?[0-9]*\.?[0-9]+)", str(row["text"])):
                if float(total_match.group(0)) == float(fl):
                    row["data_class"], row["pos_neg"] = 4, 1
    return rows, img_shape


def data_parser(
    dir_data_root: str,
    dir_processed: str,
    spilt_word: bool = True,
    cosine_sim_treshold: float = 0.4,
    cosine_mode: str = "reference",
):
    """Process every image under ``root/img`` with ``root/box`` + ``root/key``
    (ref :353-402); writes CSVs to ``dir_processed/ocr_result``."""
    dir_img = os.path.join(dir_data_root, "img")
    dir_bbox = os.path.join(dir_data_root, "box")
    dir_key = os.path.join(dir_data_root, "key")
    out = os.path.join(dir_processed, "ocr_result")
    os.makedirs(out, exist_ok=True)
    for fname in sorted(os.listdir(dir_img)):
        rows, _ = ground_truth_extraction(
            os.path.join(dir_img, fname),
            os.path.join(dir_bbox, fname.replace("jpg", "txt")),
            os.path.join(dir_key, fname.replace("jpg", "txt")),
            spilt_word=spilt_word,
            cosine_sim_treshold=cosine_sim_treshold,
            cosine_mode=cosine_mode,
        )
        write_label_csv(os.path.join(out, fname.replace("jpg", "csv")), rows)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_root", required=True)
    parser.add_argument("--save_root", required=True)
    parser.add_argument("--spilt_word", action="store_true")
    parser.add_argument("--cosine_mode", default="reference",
                        choices=["reference", "true"])
    args = parser.parse_args(argv)
    data_parser(args.data_root, args.save_root, spilt_word=args.spilt_word,
                cosine_mode=args.cosine_mode)


if __name__ == "__main__":
    main()
