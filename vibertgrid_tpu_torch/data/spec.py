"""Declarative per-dataset specifications (a copy of
``vibertgrid_tpu/data/spec.py``).

The reference duplicates train/eval/deploy scripts per dataset differing only
in class lists, tag maps, loader paths and eval constraints (SURVEY.md §1).
These spec objects carry exactly those differences:

- SROIE (``data/SROIE_dataset.py``, ``train_SROIE.py:24-48``): 5 classes,
  lowercased English text, keys in ``key/*.json``, strcmp entity eval.
- EPHOIE (``data/EPHOIE_dataset.py:17-30``): 12 Chinese classes, filename
  lists in train.txt/test.txt, labels in ``_label_csv/``, keys in
  ``kvpair/*.txt``, chn joining.
- FUNSD (``data/FUNSD_dataset.py:18``, ``train_FUNSD.py:122-125``): 4
  classes, seqeval macro BIO evaluation only.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Sequence


def _bio_tags(class_list: Sequence[str]) -> dict:
    tags = {"O": 0}
    for c in class_list[1:]:
        tags[f"B-{c}"] = len(tags)
        tags[f"I-{c}"] = len(tags)
    return tags


def _b_tags(class_list: Sequence[str]) -> dict:
    tags = {"O": 0}
    for c in class_list[1:]:
        tags[f"B-{c}"] = len(tags)
    return tags


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    class_list: tuple[str, ...]
    language: str = "eng"            # joining rule in entity eval
    lowercase: bool = True           # SROIE tokenizes text.lower()
    image_dir: str = "image"
    image_ext: str = ".jpg"
    label_dir: str = "label"
    key_dir: str | None = "key"      # None → no key dicts (FUNSD)
    filelist_from_txt: bool = False  # EPHOIE: train.txt / test.txt
    default_eval_mode: str = "seq_and_str"
    seqeval_average: str = "micro"
    image_mean: tuple[float, ...] = (0.9248, 0.9224, 0.9215)
    image_std: tuple[float, ...] = (0.1532, 0.1545, 0.1536)
    key_loader: Callable | None = None

    @property
    def num_classes(self) -> int:
        return len(self.class_list)

    def tag_to_idx(self, mode: str = "B") -> dict:
        return _b_tags(self.class_list) if mode == "B" else _bio_tags(self.class_list)


def _sroie_keys(root: str, filename: str) -> dict:
    path = os.path.join(root, "key", filename + ".json")
    with open(path, "r") as f:
        d = json.load(f)
    d["filename"] = filename
    return d


def _ephoie_keys(root: str, filename: str) -> dict:
    path = os.path.join(root, "kvpair", filename + ".txt")
    with open(path, "rb") as f:
        d = json.load(f)
    full = {c: "" for c in EPHOIE_SPEC.class_list}
    full.update(d)
    full["filename"] = filename
    return full


SROIE_SPEC = DatasetSpec(
    name="sroie",
    class_list=("others", "company", "date", "address", "total"),
    language="eng",
    lowercase=True,
    key_loader=_sroie_keys,
)

EPHOIE_SPEC = DatasetSpec(
    name="ephoie",
    class_list=(
        "其他", "年级", "科目", "学校", "考试时间", "班级",
        "姓名", "考号", "分数", "座号", "学号", "准考证号",
    ),
    language="chn",
    lowercase=False,
    label_dir="_label_csv",
    key_dir="kvpair",
    filelist_from_txt=True,
    image_mean=(0.9876, 0.9881, 0.9884),
    image_std=(0.0804, 0.0762, 0.0746),
    key_loader=_ephoie_keys,
)

FUNSD_SPEC = DatasetSpec(
    name="funsd",
    class_list=("others", "question", "answer", "header"),
    language="eng",
    lowercase=True,
    image_ext=".png",
    label_dir="_label_csv",
    image_dir="images",
    key_dir=None,
    default_eval_mode="seqeval",
    seqeval_average="macro",
    image_mean=(0.948, 0.948, 0.948),
    image_std=(0.184, 0.184, 0.184),
)

_SPECS = {s.name: s for s in (SROIE_SPEC, EPHOIE_SPEC, FUNSD_SPEC)}


def get_spec(name: str) -> DatasetSpec:
    return _SPECS[name.lower()]
