"""The port's evaluation layer against the JAX package's, on the CPU.

- ``seqeval_lite`` and ``criteria``: equal results on seeded tag sequences
  and score arrays;
- ``strcmp_compare``: equal on empty and filled ground truths;
- ``validate`` fed one stub ``eval_step`` that returns the same fixed outputs
  to both harnesses: equal metrics dicts in the three eval modes, with CRF
  decoded ids, and on the uint8 wire (the sizes it is handed equal);
- the slice as a whole on one set of weights: the JAX tiny model (initialised
  with the losses) through ``convert.from_flax`` into the port's; the JAX
  ``validate`` of its ``make_eval_step`` and the port's ``validate`` of the
  port's over the test split's ``bucketed_eval_loader`` batches: equal
  ``primary_F1``, ``F1``, ``token_F1``, ``token_accuracy`` and
  ``per_type_F1``, the loss within 1e-4 relative (fp32 on both sides; the
  auxiliary loss's pixel sample drawn from the JAX eval step's seeds);
- ``evaluate`` on a port checkpoint of those weights: the port ``validate``'s
  results and a JSON report; on the uint8 wire at ``eval_batch_size: 2``
  within 0.05 of the fp32 batch-size-1 F1 (``tests/test_model.py``'s bound).

The JAX eval step compiles for two batch signatures; no train step compiles.
"""

import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_model import _perturb
from tests.test_train_driver import tiny_hyp
from vibertgrid_tpu.data.dataset import bucketed_eval_loader as jax_bucketed_eval_loader
from vibertgrid_tpu.data.spec import SROIE_SPEC
from vibertgrid_tpu.data.synthetic import CLASS_WORDS, make_synthetic_root, synthetic_spec
from vibertgrid_tpu.eval import criteria as jcriteria
from vibertgrid_tpu.eval import harness as jharness
from vibertgrid_tpu.eval import seqeval_lite as jseqeval
from vibertgrid_tpu.train.driver import build_all as jax_build_all
from vibertgrid_tpu.train.driver import build_tokenizer as jax_build_tokenizer
from vibertgrid_tpu.train.state import TrainState as JaxTrainState
from vibertgrid_tpu.train.state import make_eval_step as jax_make_eval_step
from vibertgrid_tpu_torch.convert import from_flax
from vibertgrid_tpu_torch.data.dataset import (
    EvalAux,
    KIEDataset,
    bucketed_eval_loader,
    prefetch_to_device,
)
from vibertgrid_tpu_torch.data.spec import SROIE_SPEC as PORT_SROIE_SPEC
from vibertgrid_tpu_torch.data.synthetic import synthetic_spec as port_spec
from vibertgrid_tpu_torch.eval import criteria, harness, seqeval_lite
from vibertgrid_tpu_torch.eval.cli import evaluate
from vibertgrid_tpu_torch.train.checkpoint import CheckpointManager
from vibertgrid_tpu_torch.train.driver import build_all, build_tokenizer
from vibertgrid_tpu_torch.train.optim import make_optimizer
from vibertgrid_tpu_torch.train.seeds import ReplaySeeds
from vibertgrid_tpu_torch.train.state import TrainState, make_eval_step

LOSS_RTOL = 1e-4
EQUAL_KEYS = ("primary_F1", "F1", "token_F1", "token_accuracy", "per_type_F1")
TAGS = ["O", "B-company", "I-company", "B-date", "I-date", "B-total", "I-total"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs six workers on the machine's cores; torch's default of
    a thread a core in each makes their CPU kernels wait on each other, so
    this module's forwards take two."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tag_seqs(seed, n=12):
    rng = np.random.default_rng(seed)
    return [[str(t) for t in rng.choice(TAGS, int(rng.integers(0, 9)))] for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seqeval_lite_matches_jax(seed):
    truth, pred = _tag_seqs(seed), _tag_seqs(seed + 100)
    pred[:4] = truth[:4]  # some entities right
    for seq in truth + pred:
        assert seqeval_lite.get_entities(seq) == jseqeval.get_entities(seq)
    for average in ("micro", "macro", "weighted"):
        assert seqeval_lite.bio_f1(truth, pred, average) == jseqeval.bio_f1(truth, pred, average)
    assert seqeval_lite.per_type_f1(truth, pred) == jseqeval.per_type_f1(truth, pred)
    assert (seqeval_lite.classification_report(truth, pred)
            == jseqeval.classification_report(truth, pred))


@pytest.mark.parametrize("seed", [0, 1])
def test_criteria_match_jax(seed):
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(4):
        n = int(rng.integers(1, 12))
        scores = rng.dirichlet(np.ones(5), n).astype(np.float32)
        scores[: n // 2] = np.eye(5, dtype=np.float32)[rng.integers(0, 5, n // 2)]  # exact 1.0s
        pairs.append((scores, rng.integers(0, 5, n)))
    assert criteria.token_F1_criteria(pairs) == jcriteria.token_F1_criteria(pairs)
    for scores, gt in pairs:
        for pred in (scores, scores.argmax(-1)):
            assert (criteria.token_classification_criteria(gt, pred)
                    == jcriteria.token_classification_criteria(gt, pred))
    maps = rng.random((2, 3, 16, 16)).astype(np.float32), rng.random((2, 3, 16, 16))
    coor = np.array([[[0, 0, 1, 1], [2, 2, 6, 5]], [[3, 3, 4, 4], [0, 0, 0, 0]]])
    assert (criteria.semantic_segmentation_classification_criteria(*maps, coor)
            == jcriteria.semantic_segmentation_classification_criteria(*maps, coor))


@pytest.mark.parametrize("spec_name", ["synthetic", "sroie"])
def test_strcmp_compare_matches_jax(spec_name):
    spec = SROIE_SPEC
    filt = jharness.RESULT_FILTERS[spec_name]
    assert (harness.RESULT_FILTERS[spec_name] is None) == (filt is None)
    port_filt = harness.RESULT_FILTERS[spec_name]
    preds = [["", "ACME CORP", "25/03/2019 paid", "", "72.10"],
             ["", "", "", "", ""],
             ["", "acme", "not a date", "1 main st", "RM 3.00"]]
    keys = [{"company": "ACME CORP", "date": "25/03/2019", "address": "", "total": "72.10"},
            {"company": "", "date": "", "address": "", "total": ""},
            {}]
    for pred in preds:
        for key in keys:
            got = harness.strcmp_compare(pred, key, spec.class_list, port_filt)
            assert got == jharness.strcmp_compare(pred, key, spec.class_list, filt)


def _stub_run(seed, crf=False, uint8=False, n_batches=3, b=2, s=8, c=5):
    """Fixed outputs and auxes for a stub eval step, as numpy."""
    rng = np.random.default_rng(seed)
    words = [w for ws in CLASS_WORDS.values() for w in ws]
    runs = []
    for k in range(n_batches):
        n_segments = [int(rng.integers(0, s + 1)) for _ in range(b)]
        n_segments[0] = max(n_segments[0], 3)
        gt = rng.integers(0, c, (b, s)).astype(np.int32)
        logits = rng.normal(0, 1, (b, s, c)) + 3 * np.eye(c)[gt] * (rng.random((b, s, 1)) < 0.7)
        probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        pred = probs.argmax(-1).astype(np.int64) if crf else probs.astype(np.float32)
        texts = [[" ".join(rng.choice(words, 2)) for _ in range(n)] for n in n_segments]
        key_dicts = []
        for i in range(b):
            key = {cls: " ".join(t for t, g in zip(texts[i], gt[i]) if g == ci)
                   for ci, cls in enumerate(SROIE_SPEC.class_list) if ci}
            key["filename"] = f"doc{k}_{i}"
            key_dicts.append(key)
        sizes = [(int(rng.integers(60, 128)), int(rng.integers(60, 128))) for _ in range(b)]
        aux = EvalAux(texts=texts, key_dicts=key_dicts, n_segments=n_segments, image_sizes=sizes)
        images = np.zeros((b, 128, 128, 3), np.uint8 if uint8 else np.float32)
        losses = rng.random(3).astype(np.float32) + 1
        runs.append((images, aux, dict(total_loss=losses[0], loss_c=losses[1], loss_aux=losses[2],
                                       pred_label=pred, gt_label=gt)))
    return runs


def _stub_validate(validate, runs, as_array, spec, **kw):
    """``validate`` over ``runs`` with a stub step returning each run's
    outputs through ``as_array``; returns the metrics and the sizes seen."""
    seen = []
    outs = iter([out for _, _, out in runs])

    def step(state, batch, sizes=None):
        if sizes is not None:
            seen.append(np.asarray(sizes).tolist())
        return SimpleNamespace(**{k: as_array(v) for k, v in next(outs).items()})

    loader = [(SimpleNamespace(images=as_array(images)), aux) for images, aux, _ in runs]
    return validate(step, None, loader, spec, verbose=False, **kw), seen


@pytest.mark.parametrize("eval_mode, variant", [
    (mode, variant) for mode in ("seqeval", "strcmp", "seq_and_str")
    for variant in ("scores", "uint8")] + [("seqeval", "crf")])  # CRF tags: seqeval only
def test_validate_matches_jax_on_a_stub(eval_mode, variant):
    runs = _stub_run(3, crf=variant == "crf", uint8=variant == "uint8")
    spec, port = (SROIE_SPEC, PORT_SROIE_SPEC)
    kw = dict(eval_mode=eval_mode, tag_to_idx=spec.tag_to_idx("B"))
    want, want_sizes = _stub_validate(jharness.validate, runs, np.asarray, spec, **kw)
    got, got_sizes = _stub_validate(harness.validate, runs, torch.as_tensor, port, **kw)
    assert got == want
    assert got_sizes == want_sizes == ([[list(hw) for hw in aux.image_sizes] for _, aux, _ in runs]
                                       if variant == "uint8" else [])
    assert got["primary_F1"] > 0


# ---- the slice on one set of weights ----

@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """A synthetic root whose 4 test documents make two batches of two
    signatures (3 documents and a repeat, and 1), the tiny config, and the
    JAX model's variables, initialised with the losses, perturbed as
    ``tests/test_torch_model.py`` perturbs them and the category head's last
    layer shrunk, so that the scores are O(1) and the segments' classes
    differ."""
    root = str(tmp_path_factory.mktemp("synth"))
    make_synthetic_root(root, n_train=1, n_test=4, seed=2, segs_range=(1, 4))
    hyp = tiny_hyp(root)
    hyp.update(eval_mode="seq_and_str", eval_batch_size=4)
    tokenizer = jax_build_tokenizer(hyp)
    _, _, model, _, collator, _ = jax_build_all(hyp, "sroie", tokenizer, synthetic_spec())
    test_ds = KIEDataset(f"{root}/test", port_spec(), build_tokenizer(hyp), train=False)
    from vibertgrid_tpu.data.dataset import KIEDataset as JaxKIEDataset

    jax_test = JaxKIEDataset(f"{root}/test", synthetic_spec(), tokenizer, train=False)
    batches = list(jax_bucketed_eval_loader(jax_test, collator, batch_size=4))
    assert [aux.n_segments.count(0) for _, aux in batches] in ([1, 0], [0, 1])
    variables = jax.jit(lambda b: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, b,
        train=False, compute_loss=True, key=jax.random.PRNGKey(2)))(batches[0][0])
    variables = _perturb(variables)
    out = variables["params"]["field_type_head"]["category_net"]["out"]
    out["kernel"] = out["kernel"] * 0.01
    return SimpleNamespace(root=root, hyp=hyp, model=model, variables=variables,
                           batches=batches, test_ds=test_ds)


def _port_state(hyp):
    _, _, model, _, _, _ = build_all(hyp, "sroie", build_tokenizer(hyp), port_spec(), device="cpu")
    optimizer = make_optimizer(hyp, 1, 1, model.named_parameters())
    return TrainState(model=model, optimizer=optimizer)


@pytest.fixture(scope="module")
def port_results(converted):
    state = _port_state(converted.hyp)
    state.model.load_state_dict(from_flax(converted.variables), strict=True)
    collator = build_all(converted.hyp, "sroie", None, port_spec(), device="cpu")[4]
    loader = bucketed_eval_loader(converted.test_ds, collator, batch_size=4)
    results = harness.validate(make_eval_step(), state, prefetch_to_device(loader, "cpu"),
                               port_spec(), eval_mode="seq_and_str",
                               tag_to_idx=port_spec().tag_to_idx("B"))
    return state, results


def _jax_eval_loss_seeds():
    """The seeds of the sampled losses in the JAX eval step: its key,
    ``PRNGKey(0)``, split into the segmentation head's and the field-type
    head's, each split in two (``models/vibertgrid.py``, ``seg_head.py``,
    ``heads.py``), as ``derive_seed`` reads them."""
    from vibertgrid_tpu.ops.dropout import derive_seed

    k_seg, k_head = jax.random.split(jax.random.PRNGKey(0))
    return [int(derive_seed(k)) for k in (*jax.random.split(k_seg), *jax.random.split(k_head))]


def test_validate_matches_jax_on_converted_weights(converted, port_results):
    jstate = JaxTrainState(params=converted.variables["params"],
                           batch_stats=converted.variables["batch_stats"], opt_state=(), step=0)
    kw = dict(eval_mode="seq_and_str", tag_to_idx=synthetic_spec().tag_to_idx("B"))
    want = jharness.validate(jax_make_eval_step(converted.model), jstate, converted.batches,
                             synthetic_spec(), **kw)
    state, got = port_results
    for key in EQUAL_KEYS:
        assert got[key] == want[key], key
    assert got["per_sample"] == want["per_sample"]
    assert len({p for doc in got["per_sample"].values() for p in doc["pred"][1:] if p}) >= 2, \
        "fewer than two fields filled: little compared"
    # The auxiliary loss keeps a random sample of pixels, drawn in eval mode
    # from fixed seeds that differ between the packages (the port's are 0).
    # With the JAX eval step's seeds the port's loss is the JAX loss.
    np.testing.assert_allclose(got["loss_c"], want["loss_c"], rtol=LOSS_RTOL)
    seeds = _jax_eval_loss_seeds()

    @torch.no_grad()
    def jax_seeded_step(state, batch):
        return state.model(batch, train=False, compute_loss=True, seeds=ReplaySeeds(seeds))

    collator = build_all(converted.hyp, "sroie", None, port_spec(), device="cpu")[4]
    loader = bucketed_eval_loader(converted.test_ds, collator, batch_size=4)
    seeded = harness.validate(jax_seeded_step, state, prefetch_to_device(loader, "cpu"),
                              port_spec(), **kw)
    for key in EQUAL_KEYS:
        assert seeded[key] == want[key], key
    for key in ("loss", "loss_c", "loss_aux"):
        np.testing.assert_allclose(seeded[key], want[key], rtol=LOSS_RTOL, err_msg=key)


def test_evaluate_on_a_port_checkpoint(converted, port_results, tmp_path):
    state, want = port_results
    path = CheckpointManager(str(tmp_path / "w")).save(state, tag="converted")
    hyp = dict(converted.hyp, weights=path, result_dir=str(tmp_path / "result"))
    got = evaluate(hyp, "sroie", spec=port_spec(), device="cpu")
    for key in EQUAL_KEYS:
        assert got[key] == want[key], key
    assert got["per_sample"] == want["per_sample"] and got["loss"] == want["loss"]
    with open(tmp_path / "result" / "converted.json") as f:
        report = json.load(f)
    assert report["per_sample"] == json.loads(json.dumps(want["per_sample"]))

    fp32_bs1 = evaluate(dict(hyp, eval_batch_size=1), "sroie", spec=port_spec(), device="cpu")
    uint8_bs2 = evaluate(dict(hyp, eval_batch_size=2, eval_uint8_upload=True), "sroie",
                         spec=port_spec(), device="cpu")
    assert fp32_bs1["primary_F1"] == want["primary_F1"]
    assert abs(uint8_bs2["primary_F1"] - fp32_bs1["primary_F1"]) <= 0.05


def test_evaluate_needs_weights_and_defaults_to_cuda(converted):
    with pytest.raises(ValueError, match="weights"):
        evaluate(dict(converted.hyp, weights=""), "sroie", spec=port_spec(), device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        evaluate(converted.hyp, "sroie", spec=port_spec())


def test_inference_once_and_visualize(converted, port_results, tmp_path):
    from vibertgrid_tpu_torch.data.dataset import data_loader
    from vibertgrid_tpu_torch.utils.visualize import dump_parameter_names

    state, _ = port_results
    collator = build_all(converted.hyp, "sroie", None, port_spec(), device="cpu")[4]
    batch, aux = next(prefetch_to_device(
        data_loader(converted.test_ds, collator, 1, train=False), "cpu"))
    out = tmp_path / "boxes.jpg"
    result = harness.inference_once(make_eval_step(), state, batch, aux, port_spec(), draw=True,
                                    save_path=str(out))
    assert len(result) == 4 and out.exists()
    names = tmp_path / "names.txt"
    dump_parameter_names(state.model.named_parameters(), str(names))
    lines = names.read_text().splitlines()
    assert len(lines) == len(list(state.model.parameters()))
    assert lines[0].startswith("bert_model.") or "." in lines[0]
