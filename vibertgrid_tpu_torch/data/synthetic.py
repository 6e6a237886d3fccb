"""Synthetic KIE dataset + offline-built tokenizer for tests and benchmarks
(a copy of ``vibertgrid_tpu/data/synthetic.py``).

Nothing is downloaded (no HF hub) and no real SROIE/EPHOIE/FUNSD data is
needed: end-to-end tests generate a miniature dataset in
the reference's on-disk format (``image/*.jpg-style arrays``, ``label/*.csv``
with ``left,top,right,bot,text,data_class,pos_neg``, ``key/*.json`` —
``readme.md:31``, ``pipeline/funsd_data_preprocessing.py:16-18``) plus a
WordPiece vocab so ``transformers.BertTokenizer`` runs fully offline.

Documents are learnable by construction: each class-c entity is one
contiguous run of segments whose text contains class-specific keywords, drawn
as filled boxes whose intensity encodes the class.
"""

from __future__ import annotations

import json
import os

import numpy as np

CLASS_WORDS = {
    0: ["lorem", "ipsum", "dolor", "sit", "amet"],
    1: ["company", "corp", "limited"],
    2: ["date", "march", "april"],
    3: ["address", "street", "avenue"],
    4: ["total", "amount", "sum"],
}

VOCAB = (
    ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    + sorted({w for ws in CLASS_WORDS.values() for w in ws})
    + [str(i) for i in range(10)]
)


def write_vocab(path: str) -> str:
    vocab_file = os.path.join(path, "vocab.txt")
    with open(vocab_file, "w") as f:
        f.write("\n".join(VOCAB) + "\n")
    return vocab_file


def make_test_tokenizer(root: str):
    """Offline BertTokenizer over the synthetic vocab."""
    from transformers import BertTokenizer

    return BertTokenizer(write_vocab(root), do_lower_case=True)


def write_roberta_tokenizer(path: str) -> str:
    """Write an offline byte-level-BPE RoBERTa tokenizer dir under ``path``.

    Character-level vocab (no merges): every synthetic word tokenizes into
    single-char pieces, which is fine for framing/driver tests — what matters
    is the RoBERTa special-token layout (``<s>``=0, ``<pad>``=1, ``</s>``=2),
    the ids the reference's RobertaTokenizer would produce
    (``train_SROIE.py:147-150``). Returns the directory path.
    """
    d = os.path.join(path, "roberta_tok")
    os.makedirs(d, exist_ok=True)
    chars = (
        ["Ġ"]  # byte-level space marker
        + [chr(c) for c in range(ord("a"), ord("z") + 1)]
        + [str(i) for i in range(10)]
        + [".", ",", "-"]
    )
    vocab = {
        t: i
        for i, t in enumerate(["<s>", "<pad>", "</s>", "<unk>", "<mask>"] + chars)
    }
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    return d


def make_synthetic_root(
    path: str,
    n_train: int = 8,
    n_test: int = 4,
    n_classes: int = 5,
    seed: int = 0,
    words_range: tuple = (1, 3),
    segs_range: tuple = (1, 3),
    tag_scheme: str = "B",
) -> str:
    """Create train/ and test/ splits under ``path``; returns ``path``.

    ``words_range``/``segs_range``: per-segment word count and per-class
    segment count draws (``rng.integers`` bounds). The defaults give short
    single-window corpora; e.g. ``words_range=(40, 60), segs_range=(8, 12)``
    produces multi-thousand-token documents that exercise the unbounded
    sliding-window path (≥4 510-token windows) end to end — the reference
    semantics at ``model/BERTgrid_generator.py:81-146``.

    ``tag_scheme``: what the CSV ``data_class`` column encodes. ``"B"``
    (default) writes plain class ids — the SROIE layout, where class id ==
    B-tag id. ``"BIO"`` writes BIO *tag ids* per ``spec._bio_tags`` ordering
    (B-c = 2c-1, I-c = 2c; first segment of each entity run gets B-, the
    rest I-). This mirrors the reference's contract: BIO conversion happens
    at PREPROCESSING time and the dataset reads ``data_class`` raw as tag
    ids (``pipeline/ephoie_data_preprocessing.py:234-399`` writes tag ids;
    ``data/EPHOIE_dataset.py:141`` consumes them verbatim). Feeding a
    ``"B"``-scheme root to a ``tag_mode="BIO"`` model silently relabels
    classes into the wrong half of the tag table (class 2 reads as
    I-company, 3 as B-date, 4 as I-date) — consistent between GT and
    predictions, hence still learnable, but the per-type report then
    structurally caps at 2 visible entity types.
    """
    assert tag_scheme in ("B", "BIO"), tag_scheme
    rng = np.random.default_rng(seed)
    class_names = ["others", "company", "date", "address", "total"][:n_classes]

    for split, n_docs, is_train in (("train", n_train, True), ("test", n_test, False)):
        sroot = os.path.join(path, split)
        for d in ("image", "label", "key"):
            os.makedirs(os.path.join(sroot, d), exist_ok=True)
        for di in range(n_docs):
            name = f"doc{di:03d}"
            h = int(rng.integers(200, 320))
            w = int(rng.integers(160, 240))
            img = np.full((h, w, 3), 0.95, np.float32)
            img += rng.normal(0, 0.01, img.shape).astype(np.float32)

            rows = []
            key_dict = {c: "" for c in class_names}
            y = 10
            # one contiguous run per class, classes in random order
            for cls in rng.permutation(n_classes):
                n_seg = int(rng.integers(*segs_range))
                texts = []
                x = int(rng.integers(5, 30))
                for seg_i in range(n_seg):
                    words = [
                        str(rng.choice(CLASS_WORDS[int(cls)]))
                        for _ in range(int(rng.integers(*words_range)))
                    ]
                    text = " ".join(words)
                    texts.append(text)
                    if y > h - 16:  # wrap: keep every box inside the image
                        y = 10
                    bw = min(6 * len(text) + 8, w - x - 2)
                    bh = 14
                    x0, y0 = x, y
                    x1, y1 = min(x + bw, w - 1), min(y + bh, h - 1)
                    shade = 0.15 + 0.15 * int(cls)
                    img[y0:y1, x0:x1] = shade
                    if tag_scheme == "BIO" and cls > 0:
                        # first segment of the run is B-, the rest I-
                        label = 2 * int(cls) - (1 if seg_i == 0 else 0)
                    else:
                        label = int(cls)
                    rows.append((x0, y0, x1, y1, text, label, int(cls)))
                    x = x1 + 6
                    if x > w - 30:
                        x = int(rng.integers(5, 20))
                        y += 20
                if cls != 0:
                    key_dict[class_names[int(cls)]] = " ".join(texts)
                y += 22
                if y > h - 24:
                    y = int(rng.integers(10, 24))

            np.save(os.path.join(sroot, "image", name + ".npy"), img)
            with open(os.path.join(sroot, "label", name + ".csv"), "w") as f:
                f.write("left,top,right,bot,text,data_class,pos_neg\n")
                for x0, y0, x1, y1, text, label, cls in rows:
                    # pos_neg keys off the CLASS, not the tag id
                    pn = 1 if cls > 0 else 2
                    f.write(f"{x0},{y0},{x1},{y1},{text},{label},{pn}\n")
            with open(os.path.join(sroot, "key", name + ".json"), "w") as f:
                json.dump(key_dict, f)
    write_vocab(path)
    return path


def synthetic_spec():
    """A DatasetSpec for the synthetic data (SROIE layout, .npy images)."""
    import dataclasses

    from vibertgrid_tpu_torch.data.spec import SROIE_SPEC

    return dataclasses.replace(SROIE_SPEC, name="synthetic", image_ext=".npy")
