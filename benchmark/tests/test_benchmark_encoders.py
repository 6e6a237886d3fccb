"""The text encoder as a configuration's own files: a test-only encoder put
under ``benchmark.reference.encoders`` and ``benchmark.harness.encoders``
drives the tiny CPU cell to a correct result line and the readers' counts;
a configuration without its encoder's keys or files fails before set-up;
RoBERTa's counts, framing and collate at another window length."""

import contextlib
import dataclasses
import functools
import io
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from benchmark.harness import cli, counts, probe as probe_mod, train as harness_train
from benchmark.harness.encoders import roberta as roberta_counts
from benchmark.reference import collate, model as ref_model
from benchmark.reference.encoders import roberta as roberta_ref
from benchmark.tests.test_benchmark_harness import CELL, SEED, TINY

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = f"benchmark/configs/{cli._load('workloads', CELL)['config']}.json"


def _counting(module, calls: dict, names) -> types.ModuleType:
    """A copy of ``module`` whose functions ``names`` count their calls."""
    copy = types.ModuleType(module.__name__.rsplit(".", 1)[0] + ".counting")
    copy.__dict__.update({k: v for k, v in vars(module).items() if not k.startswith("__")})

    def counted(name, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return wrapper

    for name in names:
        setattr(copy, name, counted(name, getattr(module, name)))
    if hasattr(module, "KERNELS"):
        copy.KERNELS = {k: (counted(k, fn), n, pattern)
                        for k, (fn, n, pattern) in module.KERNELS.items()}
    return copy


def _run(overrides, seed=SEED):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.run(["--workload", CELL, "--seed", str(seed), "--seconds", "2"], device="cpu",
                     overrides=overrides)
    lines = out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]) if rc == 0 else None, err.getvalue()


def test_an_encoder_of_its_own_files_drives_the_cell(monkeypatch):
    ref_calls, count_calls, probes = {}, {}, []
    monkeypatch.setitem(sys.modules, "benchmark.reference.encoders.counting",
                        _counting(roberta_ref, ref_calls, ("frame", "encode")))
    monkeypatch.setitem(sys.modules, "benchmark.harness.encoders.counting",
                        _counting(roberta_counts, count_calls, ("sizes", "forward_flops")))

    class Keeping(probe_mod.Probe):
        def __init__(self):
            super().__init__()
            probes.append(self)

    monkeypatch.setattr(probe_mod, "Probe", Keeping)
    overrides = dict(TINY, model=dict(TINY["model"], text_encoder="counting"))
    rc, result, err = _run(overrides)
    assert rc == 0, err[-3000:]
    assert result["correct"] is True, result["compared"]
    # the reference followed the three checked steps through the module
    assert ref_calls == {"frame": harness_train.CHECKED_STEPS, "encode": harness_train.CHECKED_STEPS}
    assert count_calls == {"sizes": 1}

    probe = probes[0]
    assert probe.model.text_encoder == "counting" and probe.forwards
    assert cli.reader("mfu.train")(probe) > 0
    assert count_calls["forward_flops"] == len(probe.forwards)
    probe.trace = probe_mod.Trace(window_s=probe.window_s, busy_s=probe.window_s,
                                  kernels={"attention_bwd_dq_kernel<64>": [1, 1.0]}, idle_gaps=[])
    assert cli.reader("roofline.attention_bwd.train")(probe) > 0
    assert count_calls["attention_bwd"] == len(probe.forwards)
    assert cli.reader("roofline.ffn_saved.train")(probe) is None  # no such kernel ran


@pytest.fixture
def no_setup(monkeypatch):
    def setup(ctx):
        raise AssertionError("set-up started")

    monkeypatch.setattr(harness_train, "run", setup)


@pytest.mark.parametrize("key", ["text_encoder", "window_tokens"])
def test_a_configuration_without_the_key_fails_before_setup(key, no_setup, monkeypatch):
    load = cli._load

    def without(kind, name):
        loaded = load(kind, name)
        if kind == "configs":
            del loaded["model"][key]
        return loaded

    monkeypatch.setattr(cli, "_load", without)
    with pytest.raises(SystemExit, match=f"{CONFIG}: model.{key} is missing"):
        _run(TINY)


@pytest.mark.parametrize("present, missing", [
    ((), "benchmark/reference/encoders/nowhere.py"),
    (("reference",), "benchmark/harness/encoders/nowhere.py"),
])
def test_an_encoder_without_its_file_fails_before_setup(present, missing, no_setup, monkeypatch):
    for part in present:
        monkeypatch.setitem(sys.modules, f"benchmark.{part}.encoders.nowhere",
                            types.ModuleType(f"benchmark.{part}.encoders.nowhere"))
    overrides = dict(TINY, model=dict(TINY["model"], text_encoder="nowhere"))
    with pytest.raises(SystemExit, match=f"no text encoder 'nowhere': {missing} is missing"):
        _run(overrides)


# ---- RoBERTa at a window of 254 tokens (256 positions framed)

W = 254
SMALL = {"text_encoder": "roberta", "window_tokens": W, "hidden_size": 64,
         "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 128,
         "resnet_blocks": [2, 2, 2, 2], "num_classes": 5, "classifier_mode": "full"}


@pytest.mark.parametrize("train", [False, True])
def test_counts_at_another_window(train):
    m = counts.Model.of({"model": SMALL})
    x = counts.Shape(b=2, h=128, w=192, tokens=3 * W, window=W, s=32, train=train)
    seqs, n = 6, 6 * 256  # two documents of three windows, 256 positions each
    d, f, layers, heads = 64, 128, 2, 4
    assert counts.encoder_flops(m, x) == layers * (8 * n * d * d + 4 * seqs * 256 * 256 * d
                                                   + 4 * n * d * f)
    calls = counts.calls(m)
    assert calls["attention"][0](m, x) == (
        4 * seqs * 256 * 256 * d, 8 * n * d + 4 * n + (4 * heads * n if train else 0))
    assert calls["attention_bwd"][0](m, x) == (
        10 * seqs * 256 * 256 * d, 16 * n * d + 4 * heads * n + 8 * n)
    assert calls["ffn_saved"][0](m, x) == (
        4 * n * d * f, 4 * n * d + 4 * d * f + 4 * (f + 3 * d) + 2 * n * f + 2 * n * d + 4 * n)
    assert {k: per(m) for k, (_, per) in calls.items()} == {
        "attention": 2, "attention_bwd": 2, "ffn": 2, "ffn_saved": 2, "scatter": 1}
    assert counts.forward_flops(m, x) == (counts.encoder_flops(m, x) + counts.backbone_flops(m, x)
                                          + counts.head_flops(m, x))


def test_framing_and_encoding_at_another_window():
    lengths = (300, 100)
    tokens = torch.zeros((2, 2 * W), dtype=torch.int64)
    mask = torch.zeros_like(tokens)
    for i, n in enumerate(lengths):
        tokens[i, :n] = torch.arange(3, 3 + n) + 1000 * i
        mask[i, :n] = 1
    cfg = {"model": SMALL, "cls_sep": (0, 2)}
    framed = roberta_ref.frame(tokens, mask, cfg)
    ids, amask = framed["ids"], framed["mask"]
    assert ids.shape == amask.shape == (4, W + 2) and framed["documents"] == 2
    assert (ids[:, 0] == 0).all() and (amask[:, 0] == 1).all()
    # the batch's longest document has 300 tokens: </s> after the whole first
    # window, and after its 46 tokens in the second
    for row, (doc, win) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
        at = 1 + min(max(300 - win * W, 0), W)
        assert ids[row, at] == 2 and amask[row, at] == 1
        assert torch.equal(ids[row, 1:W + 1][:at - 1], tokens[doc, win * W:win * W + at - 1])
        assert int(amask[row].sum()) == 2 + int(mask[doc, win * W:(win + 1) * W].sum())

    g = torch.Generator().manual_seed(0)
    d = SMALL["hidden_size"]
    P = {"bert_model.word_embeddings.weight": torch.randn(3000, d, generator=g),
         "bert_model.position_embeddings.weight": torch.randn(W + 4, d, generator=g),
         "bert_model.token_type_embeddings.weight": torch.randn(1, d, generator=g),
         "bert_model.embeddings_ln.weight": torch.ones(d),
         "bert_model.embeddings_ln.bias": torch.zeros(d)}
    states = roberta_ref.encode(P, framed, ref_model.step_seeds(SEED, 0), cfg)
    assert states.shape == (2, 2 * W, d)


def test_collate_pads_to_whole_windows_of_the_configuration():
    hyp = {"image_min_size": [64], "image_max_size": 96, "image_mean": [0.5] * 3,
           "image_std": [0.25] * 3}
    rng = np.random.default_rng(0)

    def doc(n_tokens):
        image = rng.random((80, 60, 3), dtype=np.float32)
        return (image, np.arange(n_tokens, dtype=np.int32) + 3, np.zeros(n_tokens, np.int32),
                np.array([[1, 1, 20, 10]]), np.array([1]))

    # ceil(tokens / 254) windows, taken up to the window ladder (1, 2, 3, 4, 6, ...)
    for longest, windows in ((200, 1), (300, 2), (600, 3), (1100, 6)):
        out = collate.batch([doc(50), doc(longest)], hyp, W, np.random.default_rng(1))
        assert out["tokens"].shape == out["token_mask"].shape == (2, windows * W)
        assert out["token_mask"][1].sum() == longest


def test_the_configurations_name_their_encoder_and_window():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        configs = json.load(f)["configs"]
    for c in configs:
        with open(os.path.join(ROOT, c["file"])) as f:
            model = json.load(f)["model"]
        cli.check_encoder({"model": model}, c["file"])
        assert dataclasses.is_dataclass(counts.Model.of({"model": model}).encoder)


def test_a_kernel_kind_defined_twice_is_an_error(monkeypatch, tmp_path):
    twice = types.ModuleType("benchmark.harness.encoders.twice")
    twice.sizes, twice.KERNELS = roberta_counts.sizes, dict(
        roberta_counts.KERNELS, scatter=(counts.scatter, lambda m: 1, "bertgrid_scatter"))
    monkeypatch.setitem(sys.modules, twice.__name__, twice)
    m = counts.Model.of({"model": dict(SMALL, text_encoder="twice")})
    with pytest.raises(ValueError, match=r"\['scatter'\]"):
        counts.calls(m)
    (tmp_path / "kernels.json").write_text(json.dumps({"patterns": {"attention": "x"}}))
    monkeypatch.setattr(probe_mod, "HERE", str(tmp_path))
    with pytest.raises(ValueError, match=r"\['attention'\]"):
        probe_mod.kernel_patterns(counts.Model.of({"model": SMALL}))
