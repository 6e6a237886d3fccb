"""The port's data and eval layers against the JAX package's, on the CPU.

- ``get_spec``: every dataset's class list, tag maps and statistics equal;
- ``ImageTransform``: the port's resize (its C++ host op) against the JAX
  one (the JAX package's host op) within rtol 1e-4, atol 1e-5
  (``tests/test_data_eval.py``'s tolerance); boxes and output shapes exact;
  the torch plain version bit-equal to the JAX host op;
- ``bucket_hw`` and ``bucket_count`` equal over a sweep;
- ``Collator`` on ``make_synthetic_root`` samples, fp32 and uint8: tokens,
  seg_ids, boxes and masks exact, images at the resize tolerance, the uint8
  canvas within 1 (a pixel whose resized value lands on a rounding boundary
  can round the other way when the last float bit differs; against the
  native op none differs on this data, the resize taking its taps in the
  native op's order); ``EvalAux`` and ``signature`` equal;
- ``join_entities`` and both result filters equal on seeded inputs;
- the deployment dict in ``chip_smoke.py`` equals the port's YAML copy.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from vibertgrid_tpu.data import spec as jspec
from vibertgrid_tpu.data import transform as jtransform
from vibertgrid_tpu.data.dataset import Collator as JaxCollator
from vibertgrid_tpu.data.dataset import KIEDataset
from vibertgrid_tpu.data.synthetic import make_synthetic_root, make_test_tokenizer, synthetic_spec
from vibertgrid_tpu.eval import entities as jentities
from vibertgrid_tpu_torch.data import dataset as tdataset
from vibertgrid_tpu_torch.data import spec as tspec
from vibertgrid_tpu_torch.data import transform as ttransform
from vibertgrid_tpu_torch.eval import entities as tentities

ROOT = Path(__file__).resolve().parents[1]
RESIZE_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["sroie", "ephoie", "funsd"])
def test_get_spec_matches_jax(name):
    got, want = tspec.get_spec(name), jspec.get_spec(name)
    fields = lambda s: {k: v for k, v in dataclasses.asdict(s).items() if k != "key_loader"}
    assert fields(got) == fields(want)
    assert got.num_classes == want.num_classes
    for mode in ("B", "BIO"):
        assert got.tag_to_idx(mode) == want.tag_to_idx(mode)
    assert (got.key_loader is None) == (want.key_loader is None)
    assert tspec.get_spec(name.upper()).name == name


def _stats():
    return [0.9248, 0.9224, 0.9215], [0.1532, 0.1545, 0.1536]


@pytest.mark.parametrize("hw", [(230, 170), (1100, 850), (64, 900), (512, 384)])
@pytest.mark.parametrize("train", [False, True])
def test_image_transform_matches_jax(hw, train):
    rng = np.random.default_rng(hw[0] + hw[1])
    image = rng.random((*hw, 3)).astype(np.float32)
    boxes = np.stack([rng.integers(0, hw[1], 6), rng.integers(0, hw[0], 6),
                      rng.integers(0, hw[1], 6), rng.integers(0, hw[0], 6)], 1).astype(np.int32)
    args = (*_stats(), [320, 416, 512, 608, 704], 512, 800)
    ours, theirs = ttransform.ImageTransform(*args), jtransform.ImageTransform(*args)
    got = ours(image, boxes, train, np.random.default_rng(1) if train else None)
    want = theirs(image, boxes, train, np.random.default_rng(1) if train else None)
    assert got[2] == want[2] and got[0].shape == want[0].shape
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], **RESIZE_TOL)
    assert ours.test_output_shape(*hw) == theirs.test_output_shape(*hw)


def test_bilinear_resize_matches_jax_numpy():
    image = np.random.default_rng(2).standard_normal((37, 23, 3)).astype(np.float32)
    for out_hw in ((64, 48), (37, 23), (11, 7)):
        np.testing.assert_allclose(ttransform.bilinear_resize(image, *out_hw),
                                   jtransform.bilinear_resize(image, *out_hw), **RESIZE_TOL)


@pytest.mark.parametrize("hw, out_hw", [((1100, 850), (662, 512)), ((1250, 800), (800, 512)),
                                        ((2000, 1400), (731, 512)), ((230, 170), (692, 512)),
                                        ((64, 900), (56, 800)), ((37, 23), (37, 23))])
def test_resize_is_the_native_ops_bits(hw, out_hw):
    """The port's resize and normalization give the JAX package's C++ host op's
    bits: downsizing by more than 2 (rows no output row reads), upsizing, one
    axis down and one up, the same size."""
    from vibertgrid_tpu.data import native

    assert native.native_available()
    rng = np.random.default_rng(hw[0] * hw[1])
    image = rng.random((*hw, 3)).astype(np.float32)
    mean, std = (np.asarray(v, np.float32) for v in _stats())
    got = np.full((*out_hw, 3), 7.0, np.float32)
    want = np.zeros_like(got)
    ttransform.resize_normalize_into(image, got, *out_hw, mean, std)
    native.bilinear_resize_norm_into(image, want, *out_hw, mean, std)
    np.testing.assert_array_equal(got, want)


def test_buckets_match_jax():
    for h in range(1, 900, 37):
        for w in range(1, 900, 53):
            for m in (32, 64):
                assert ttransform.bucket_hw(h, w, m) == jtransform.bucket_hw(h, w, m)
    for ladder in (tdataset.SEG_BUCKETS, tdataset.WIN_BUCKETS, (3, 5)):
        for n in range(0, 1200, 7):
            assert ttransform.bucket_count(n, ladder) == jtransform.bucket_count(n, ladder)


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    """JAX samples of a synthetic root, with a long corpus (2 windows), and
    the same samples as the port's ``Sample``."""
    root = str(tmp_path_factory.mktemp("synth"))
    make_synthetic_root(root, n_train=4, n_test=2, words_range=(20, 30), segs_range=(5, 8))
    tokenizer = make_test_tokenizer(root)
    ds = KIEDataset(root + "/test", synthetic_spec(), tokenizer, train=False)
    jax_samples = [ds[i] for i in range(len(ds))]
    extra = KIEDataset(root + "/train", synthetic_spec(), tokenizer, train=True)
    jax_samples += [extra[i] for i in range(2)]
    port = [tdataset.Sample(**dataclasses.asdict(s)) for s in jax_samples]
    return jax_samples, port


@pytest.mark.parametrize("emit_uint8", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_collator_matches_jax(samples, emit_uint8, train):
    jax_samples, port_samples = samples
    assert max(len(s.tokens) for s in port_samples) > tdataset.WINDOW
    args = (*_stats(), [320, 416, 512], 384, 640)
    ours = tdataset.Collator(ttransform.ImageTransform(*args), emit_uint8=emit_uint8)
    theirs = JaxCollator(jtransform.ImageTransform(*args), emit_uint8=emit_uint8)
    rng = lambda: np.random.default_rng(5) if train else None
    got, got_aux = ours(port_samples, train, rng())
    with ThreadPoolExecutor(2) as pool:
        pooled, _ = ours(port_samples, train, rng(), pool=pool)
    want, want_aux = theirs(jax_samples, train, rng())
    for name in ("tokens", "token_mask", "seg_ids", "boxes", "box_mask", "seg_classes"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.images.dtype == want.images.dtype and got.images.shape == want.images.shape
    np.testing.assert_array_equal(got.images, pooled.images)
    if emit_uint8:
        diff = np.abs(got.images.astype(np.int32) - want.images.astype(np.int32))
        assert diff.max() <= 1, f"{int((diff > 0).sum())} pixels differ, by up to {diff.max()}"
    else:
        np.testing.assert_allclose(got.images, want.images, **RESIZE_TOL)
    assert dataclasses.asdict(got_aux) == dataclasses.asdict(want_aux)
    for p, j in zip(port_samples, jax_samples):
        assert ours.signature(p) == theirs.signature(j)


def test_collator_max_windows_raises():
    sample = tdataset.Sample(
        image=np.ones((64, 64, 3), np.float32), tokens=np.ones(1100, np.int32),
        seg_ids=np.zeros(1100, np.int32), boxes=np.zeros((1, 4), np.int32),
        seg_classes=np.zeros(1, np.int32), texts=["x"])
    collator = tdataset.Collator(ttransform.ImageTransform(*_stats(), [64], 64, 128),
                                 max_windows=2)
    with pytest.raises(ValueError, match="max_windows"):
        collator([sample], train=False)


@pytest.mark.parametrize("language", ["eng", "chn"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_join_entities_matches_jax(language, seed):
    rng = np.random.default_rng(seed)
    n, c = 40, 5
    logits = rng.standard_normal((n, c)) * 2
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    words = ["total", "12-", "date", "街", "号", "acme", "sdn-", "bhd"]
    texts = [str(rng.choice(words)) for _ in range(n)]
    for thresh in (0.0, 0.4):
        assert (tentities.join_entities(probs, texts, c, language, thresh)
                == jentities.join_entities(probs, texts, c, language, thresh))


def test_result_filters_match_jax():
    sroie = ["12/03/2019 10:20", "tax 3.00", "99.90", "2019-03-12", "acme sdn bhd", "",
             "march 5 2021", "1.2.3", "total"]
    for text in sroie:
        for ci in range(5):
            assert (tentities.sroie_result_filter(text, ci)
                    == jentities.sroie_result_filter(text, ci)), (text, ci)
    ephoie = ["年级：初二", "科目语文", "学校：某某中学", "姓名张三", "考号12345", "数学", "分数:98"]
    for text in ephoie:
        for ci in range(12):
            assert (tentities.ephoie_result_filter(text, ci)
                    == jentities.ephoie_result_filter(text, ci)), (text, ci)


def test_result_filter_tables_match_jax():
    from vibertgrid_tpu.eval.harness import RESULT_FILTERS as JAX_FILTERS
    from vibertgrid_tpu_torch.eval.harness import RESULT_FILTERS

    assert set(RESULT_FILTERS) == set(JAX_FILTERS)
    for name, fn in RESULT_FILTERS.items():
        assert (fn is None) == (JAX_FILTERS[name] is None)
        if fn is not None:
            assert fn.__name__ == JAX_FILTERS[name].__name__


def test_synthetic_root_matches_jax(tmp_path):
    from vibertgrid_tpu_torch.data import synthetic as tsynthetic

    a, b = tmp_path / "jax", tmp_path / "port"
    make_synthetic_root(str(a), n_train=1, n_test=1, seed=3)
    tsynthetic.make_synthetic_root(str(b), n_train=1, n_test=1, seed=3)
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    for rel in files:
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel
    assert tsynthetic.synthetic_spec().name == "synthetic"


def test_chip_smoke_deployment_dict_is_the_yaml():
    import yaml

    import chip_smoke

    with open(ROOT / "vibertgrid_tpu_torch" / "configs" / "deployment_sroie.yaml") as f:
        port = yaml.safe_load(f)
    assert chip_smoke.DEPLOYMENT_HYP == port
    with open(ROOT / "vibertgrid_tpu" / "configs" / "deployment_sroie.yaml") as f:
        jax_cfg = yaml.safe_load(f)
    # the same deployment; the port's file also names a reference checkpoint
    assert port == dict(jax_cfg, reference_weights="")


def test_chip_smoke_vocab_tokenizer_matches_bert(tmp_path):
    """The serving phase's tokenizer for a machine without transformers gives
    BertTokenizer's ids on the synthetic vocabulary's words."""
    import chip_smoke
    from vibertgrid_tpu_torch.data.synthetic import VOCAB

    bert = make_test_tokenizer(str(tmp_path))
    plain = chip_smoke._VocabTokenizer(VOCAB)
    for text in ("Company corp", "total 12 5", "march avenue 7 sum", "unknownword 3"):
        pieces = plain.tokenize(text)
        assert plain.convert_tokens_to_ids(pieces) == bert.convert_tokens_to_ids(bert.tokenize(text))
    assert (plain.cls_token_id, plain.sep_token_id) == (bert.cls_token_id, bert.sep_token_id)

