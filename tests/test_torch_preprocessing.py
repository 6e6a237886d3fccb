"""The port's preprocessing CLIs against the JAX package's, on the CPU: each
``main`` runs on its own copy of the small raw trees of
``tests/test_preprocessing.py`` (SROIE receipts with boxes and keys, EPHOIE
annotations, FUNSD forms, a split), and the files they write are equal byte
for byte."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from vibertgrid_tpu.preprocessing import ephoie as jephoie
from vibertgrid_tpu.preprocessing import funsd as jfunsd
from vibertgrid_tpu.preprocessing import split as jsplit
from vibertgrid_tpu.preprocessing import sroie as jsroie
from vibertgrid_tpu_torch.preprocessing import ephoie, funsd, split, sroie


def _write_jpg(path, h=40, w=30):
    from PIL import Image

    Image.fromarray(np.full((h, w, 3), 240).astype(np.uint8)).save(path)


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def _run_both(tmp_path, make_tree, port_main, jax_main, args):
    """Build the tree twice, run each package's ``main`` on its copy with
    ``args`` (``{root}`` stands for the copy), return both trees' files."""
    out = []
    for name, main in (("port", port_main), ("jax", jax_main)):
        root = tmp_path / name
        make_tree(root)
        main([a.format(root=root) for a in args])
        out.append(_files(root))
    return out


def _sroie_tree(root: Path):
    for d in ("img", "box", "key"):
        (root / "raw" / d).mkdir(parents=True)
    docs = {
        "x": ("1,1,50,1,50,10,1,10,ACME TRADING SDN BHD\n"
              "1,12,50,12,50,20,1,20,25/03/2019\n"
              "1,22,50,22,50,30,1,30,TOTAL 72.10\n\n",
              {"company": "ACME TRADING SDN BHD", "date": "25/03/2019",
               "address": "42 EXAMPLE STREET", "total": "72.10"}),
        "y": ("0,0,100,0,100,10,0,10,AB CDEF\n"
              "0,12,90,12,90,22,0,22,42 EXAMPLE STREET KL\n"
              "0,24,90,24,90,34,0,34,DATE 01-02-2020 12:00\n",
              {"company": "Z", "date": "01-02-2020", "address": "42 EXAMPLE STREET",
               "total": ""}),
    }
    for name, (boxes, key) in docs.items():
        _write_jpg(str(root / "raw" / "img" / f"{name}.jpg"))
        (root / "raw" / "box" / f"{name}.txt").write_text(boxes)
        (root / "raw" / "key" / f"{name}.txt").write_text(json.dumps(key))


@pytest.mark.parametrize("extra", [[], ["--spilt_word"], ["--cosine_mode", "true"]])
def test_sroie_cli_matches_jax(tmp_path, extra):
    got, want = _run_both(tmp_path, _sroie_tree, sroie.main, jsroie.main,
                          ["--data_root", "{root}/raw", "--save_root", "{root}/out", *extra])
    assert got == want
    assert sum(k.startswith("out/ocr_result/") for k in got) == 2


def _ephoie_tree(root: Path):
    (root / "image").mkdir(parents=True)
    (root / "label").mkdir(parents=True)
    annotations = {
        "a": {"0": {"box": [0, 0, 30, 0, 30, 10, 0, 10], "string": "数学考试",
                    "class": "VALUE", "tag": [2, 2, 0, 0]},
              "1": {"box": [0, 12, 40, 12, 40, 22, 0, 22], "string": "姓名张三",
                    "class": "KEY", "tag": [5, 5, 6, 6]}},
        "b": {"0": {"box": [5, 5, 25, 5, 25, 15, 5, 15], "string": "七年级",
                    "class": "VALUE", "tag": [1, 1, 1]}},
    }
    for name, ann in annotations.items():
        _write_jpg(str(root / "image" / f"{name}.jpg"))
        (root / "label" / f"{name}.txt").write_text(json.dumps(ann, ensure_ascii=False))


@pytest.mark.parametrize("mode", ["char", "char_BIO"])
@pytest.mark.parametrize("discard_key", [False, True])
def test_ephoie_cli_matches_jax(tmp_path, mode, discard_key):
    args = ["--root", "{root}", "--mode", mode] + (["--discard_key"] if discard_key else [])
    got, want = _run_both(tmp_path, _ephoie_tree, ephoie.main, jephoie.main, args)
    assert got == want
    assert sum(k.startswith("_label_csv/") for k in got) == 2


def _funsd_tree(root: Path):
    ann = {"form": [
        {"text": "Name:", "label": "question", "box": [1, 2, 30, 12],
         "words": [{"text": "Name:", "box": [1, 2, 30, 12]}]},
        {"text": "John Smith", "label": "answer", "box": [35, 2, 90, 12],
         "words": [{"text": "John", "box": [35, 2, 60, 12]},
                   {"text": "Smith", "box": [62, 2, 90, 12]}]},
        {"text": "FORM", "label": "header", "box": [1, 20, 40, 30],
         "words": [{"text": "FORM", "box": [1, 20, 40, 30]}]},
        {"text": "", "label": "other", "box": [0, 0, 5, 5], "words": []},
    ]}
    for subset in ("training_data", "testing_data"):
        d = root / subset / "annotations"
        d.mkdir(parents=True)
        (d / "doc.json").write_text(json.dumps(ann))


@pytest.mark.parametrize("mode", ["word", "seg"])
def test_funsd_cli_matches_jax(tmp_path, mode):
    got, want = _run_both(tmp_path, _funsd_tree, funsd.main, jfunsd.main,
                          ["--root", "{root}", "--mode", mode])
    assert got == want
    assert "training_data/_label_csv/doc.csv" in got


def _split_tree(root: Path):
    for d in ("image", "label", "key"):
        (root / "train" / d).mkdir(parents=True)
    for i in range(10):
        (root / "train" / "image" / f"doc{i}.jpg").write_text(f"x{i}")
        (root / "train" / "label" / f"doc{i}.csv").write_text(f"y{i}")
        (root / "train" / "key" / f"doc{i}.json").write_text(f"z{i}")


def test_split_cli_matches_jax(tmp_path):
    got, want = _run_both(tmp_path, _split_tree, split.main, jsplit.main,
                          ["--root", "{root}", "--ratio", "0.3", "--seed", "4"])
    assert got == want
    assert sum(k.startswith("validate/image/") for k in got) == 3
    for name, main in (("port", split.main), ("jax", jsplit.main)):
        main(["--root", str(tmp_path / name), "--undo"])
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    shutil.rmtree(tmp_path / "jax")
    _split_tree(tmp_path / "jax")
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
