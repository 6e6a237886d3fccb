"""Train/validate split utilities.

Port of ViBERTgrid-PyTorch's ``utils/data_train_val_spilt.py`` (move a random 30%
of train files into validate/) and ``utils/data_de_spilt.py`` (move them
back and delete validate/), generalized: any sibling label dirs that exist
(image/label/key/class/ocr_result/pos_neg) move together.

    python -m vibertgrid_tpu_torch.preprocessing.split --root data/ --ratio 0.3
    python -m vibertgrid_tpu_torch.preprocessing.split --root data/ --undo
"""

from __future__ import annotations

import argparse
import os
import random
import shutil

_SIBLING_DIRS = {
    "image": None,  # same extension
    "label": ".csv",
    "key": ".json",
    "class": ".npy",
    "ocr_result": ".csv",
    "pos_neg": ".npy",
}


def _companions(root_split: str, fname: str):
    base, _ = os.path.splitext(fname)
    for d, ext in _SIBLING_DIRS.items():
        src_dir = os.path.join(root_split, d)
        if not os.path.isdir(src_dir):
            continue
        name = fname if ext is None else base + ext
        path = os.path.join(src_dir, name)
        if os.path.exists(path):
            yield d, name


def split(root: str, validate_ratio: float = 0.3, seed: int | None = None):
    train_img = os.path.join(root, "train", "image")
    files = sorted(os.listdir(train_img))
    rng = random.Random(seed)
    chosen = rng.sample(range(len(files)), int(len(files) * validate_ratio))
    for idx in chosen:
        fname = files[idx]
        for d, name in list(_companions(os.path.join(root, "train"), fname)):
            dst_dir = os.path.join(root, "validate", d)
            os.makedirs(dst_dir, exist_ok=True)
            shutil.move(
                os.path.join(root, "train", d, name), os.path.join(dst_dir, name)
            )


def de_split(root: str):
    val_img = os.path.join(root, "validate", "image")
    if not os.path.isdir(val_img):
        return
    for fname in sorted(os.listdir(val_img)):
        for d, name in list(_companions(os.path.join(root, "validate"), fname)):
            dst_dir = os.path.join(root, "train", d)
            os.makedirs(dst_dir, exist_ok=True)
            shutil.move(
                os.path.join(root, "validate", d, name), os.path.join(dst_dir, name)
            )
    shutil.rmtree(os.path.join(root, "validate"))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", required=True)
    parser.add_argument("--ratio", type=float, default=0.3)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--undo", action="store_true")
    args = parser.parse_args(argv)
    if args.undo:
        de_split(args.root)
    else:
        split(args.root, args.ratio, args.seed)


if __name__ == "__main__":
    main()
