"""The port's dataset reader and loaders against the JAX package's, on the CPU.

- ``KIEDataset``: every sample field by field, with a fast and with a slow
  tokenizer;
- ``data_loader``: train order and arrays for two epochs' seeds, ints exact,
  images within the collator's rtol 1e-4 / atol 1e-5; two workers against a
  serial load; each shard of two; the evaluation order;
- ``bucketed_eval_loader``: the batches' signatures, padding and zeroed
  ``n_segments``;
- ``compute_mean_std`` within 1e-6;
- ``prefetch_to_device`` on the CPU: the items in order as tensors, an
  exception of the loader raised in the consumer, no live thread after an
  early break.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from vibertgrid_tpu.data import dataset as jdataset
from vibertgrid_tpu.data import transform as jtransform
from vibertgrid_tpu.data.synthetic import make_synthetic_root, synthetic_spec
from vibertgrid_tpu.train.driver import build_tokenizer as jax_build_tokenizer
from vibertgrid_tpu_torch.data import dataset as tdataset
from vibertgrid_tpu_torch.data import transform as ttransform
from vibertgrid_tpu_torch.data.synthetic import synthetic_spec as port_spec
from vibertgrid_tpu_torch.train.driver import build_tokenizer

RESIZE_TOL = dict(rtol=1e-4, atol=1e-5)
INTS = ("tokens", "token_mask", "seg_ids", "boxes", "box_mask", "seg_classes")
TRANSFORM = ([0.9] * 3, [0.15] * 3, [256, 320], 256, 400)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("synth"))
    make_synthetic_root(path, n_train=7, n_test=5, seed=4, segs_range=(1, 4))
    return path


def _tokenizers(root, fast):
    hyp = {"tokenizer_path": f"{root}/vocab.txt", "bert_version": "bert-base-uncased",
           "fast_tokenizer": fast}
    return jax_build_tokenizer(hyp), build_tokenizer(hyp)


@pytest.fixture(scope="module")
def datasets(root):
    """``{split: (jax KIEDataset, port KIEDataset)}`` with fast tokenizers."""
    jtok, ptok = _tokenizers(root, True)
    return {split: (jdataset.KIEDataset(f"{root}/{split}", synthetic_spec(), jtok, train=train),
                    tdataset.KIEDataset(f"{root}/{split}", port_spec(), ptok, train=train))
            for split, train in (("train", True), ("test", False))}


def _collators(emit_uint8=False):
    return (jdataset.Collator(jtransform.ImageTransform(*TRANSFORM), emit_uint8=emit_uint8),
            tdataset.Collator(ttransform.ImageTransform(*TRANSFORM), emit_uint8=emit_uint8))


def _assert_same_sample(got, want):
    for f in ("tokens", "seg_ids", "boxes", "seg_classes"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(got.image, want.image)
    assert got.texts == want.texts and got.key_dict == want.key_dict


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("split", ["train", "test"])
def test_kie_dataset_matches_jax(root, fast, split):
    jtok, ptok = _tokenizers(root, fast)
    assert bool(getattr(ptok, "is_fast", False)) == fast
    want = jdataset.KIEDataset(f"{root}/{split}", synthetic_spec(), jtok, train=split == "train")
    got = tdataset.KIEDataset(f"{root}/{split}", port_spec(), ptok, train=split == "train")
    assert got.filenames == want.filenames and len(got) == len(want)
    for i in range(len(want)):
        _assert_same_sample(got[i], want[i])


def _assert_same_batches(got, want, images="close"):
    """Ints and aux exact; images within the resize tolerance, bit-equal
    (``"exact"``), or for the uint8 wire within 1."""
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for (gb, ga), (wb, wa) in zip(got, want):
        for name in INTS:
            a, b = np.asarray(getattr(gb, name)), np.asarray(getattr(wb, name))
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert gb.images.dtype == wb.images.dtype and gb.images.shape == wb.images.shape
        if images == "exact":
            np.testing.assert_array_equal(gb.images, wb.images)
        elif images == "uint8":
            assert np.abs(gb.images.astype(np.int32) - wb.images.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(gb.images, wb.images, **RESIZE_TOL)
        assert dataclasses.asdict(ga) == dataclasses.asdict(wa)


@pytest.mark.parametrize("seed", [0, 1])
def test_train_loader_matches_jax(datasets, seed):
    jds, pds = datasets["train"]
    jcol, pcol = _collators()
    _assert_same_batches(tdataset.data_loader(pds, pcol, 2, train=True, seed=seed),
                         jdataset.data_loader(jds, jcol, 2, train=True, seed=seed))


def test_train_loader_workers_equal_serial(datasets):
    _, pds = datasets["train"]
    _, pcol = _collators()
    _assert_same_batches(tdataset.data_loader(pds, pcol, 3, train=True, seed=2, num_workers=2),
                         tdataset.data_loader(pds, pcol, 3, train=True, seed=2),
                         images="exact")


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_loader_matches_jax(datasets, rank):
    jds, pds = datasets["train"]
    jcol, pcol = _collators()
    got = tdataset.data_loader(pds, pcol, 1, train=True, seed=3, shard=(rank, 2))
    want = jdataset.data_loader(jds, jcol, 1, train=True, seed=3, shard=(rank, 2))
    _assert_same_batches(got, want)


def test_eval_loader_matches_jax(datasets):
    jds, pds = datasets["test"]
    jcol, pcol = _collators(emit_uint8=True)
    got = list(tdataset.data_loader(pds, pcol, 2, train=False))
    assert [len(a.n_segments) for _, a in got] == [2, 2, 1]
    _assert_same_batches(got, jdataset.data_loader(jds, jcol, 2, train=False), images="uint8")


@pytest.mark.parametrize("batch_size, repeats", [(2, 0), (4, 1)])
def test_bucketed_eval_loader_matches_jax(datasets, batch_size, repeats):
    jds, pds = datasets["test"]
    jcol, pcol = _collators()
    got = list(tdataset.bucketed_eval_loader(pds, pcol, batch_size, num_workers=2))
    want = list(jdataset.bucketed_eval_loader(jds, jcol, batch_size))
    _assert_same_batches(got, want)
    # the repeats that pad a group to a power of two are zeroed, the rest not
    n_docs = sum(sum(1 for n in aux.n_segments if n) for _, aux in got)
    assert n_docs == len(pds)
    for batch, aux in got:
        n = len(aux.n_segments)
        assert n & (n - 1) == 0 and n <= batch_size
        assert batch.tokens.shape[0] == n
    signatures = [tuple(b.images.shape[1:3]) + (b.boxes.shape[1], b.tokens.shape[1] // 510)
                  for b, _ in got]
    assert signatures == sorted(signatures)
    # groups of 3 and 2 documents: at batch size 4 the 3 take one repeat
    assert sum(aux.n_segments.count(0) for _, aux in got) == repeats


def test_compute_mean_std_matches_jax(datasets):
    jds, pds = datasets["train"]
    got = tdataset.compute_mean_std(pds, num_workers=2)
    want = jdataset.compute_mean_std(jds)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "prefetch_to_device" and t.is_alive()]


def test_prefetch_to_device_on_cpu(datasets):
    _, pds = datasets["train"]
    _, pcol = _collators()
    want = list(tdataset.data_loader(pds, pcol, 2, train=True, seed=0))
    got = list(tdataset.prefetch_to_device(
        tdataset.data_loader(pds, pcol, 2, train=True, seed=0), "cpu", size=1))
    assert len(got) == len(want)
    for (gb, ga), (wb, wa) in zip(got, want):
        for f in dataclasses.fields(gb):
            t = getattr(gb, f.name)
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), getattr(wb, f.name))
        assert dataclasses.asdict(ga) == dataclasses.asdict(wa)

    def failing():
        yield want[0]
        raise RuntimeError("loader failed")

    it = tdataset.prefetch_to_device(failing(), "cpu")
    next(it)
    with pytest.raises(RuntimeError, match="loader failed"):
        next(it)

    produced = []

    def endless():
        while True:
            produced.append(1)
            yield want[0]

    for i, _ in enumerate(tdataset.prefetch_to_device(endless(), "cpu", size=2)):
        if i == 2:
            break
    deadline = time.monotonic() + 10
    while _prefetch_threads() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _prefetch_threads(), "the prefetch thread outlived an early break"
    assert len(produced) <= 3 + 2 + 1  # consumed, queued, one in hand


def test_prefetch_to_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        next(tdataset.prefetch_to_device(iter([])))
