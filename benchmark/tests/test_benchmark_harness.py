"""The cell through the harness on the CPU at a tiny size (the kernels' plain
versions, fp32, a 2 s window): the result line, the traffic generator, the
reference against the program, and ``correct`` false under each fault the
cell can have."""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest

from benchmark.harness import cli, traffic

CELL = "train-roberta-r18d-b16"
LIMITS = json.load(open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                     "workloads", CELL + ".json")))["limits"]
# the cell's numbers, with limits for fp32 on both sides (the card's are for bf16)
FP32_LIMITS = {name: 0 if limit == 0 else 5e-3 for name, limit in LIMITS.items()}
TINY = {
    "hyp": {"bert_version": "tiny-roberta-test", "backbone": "resnet_18_D_fpn", "amp": False,
            "image_min_size": [128, 160], "test_image_min_size": 128, "image_max_size": 224,
            "num_hard_positive_main_1": 2, "num_hard_negative_main_1": 2,
            "num_hard_positive_main_2": 4, "num_hard_negative_main_2": 4,
            "loss_aux_sample_list": [16, 32, 16], "num_hard_positive_aux": 16,
            "num_hard_negative_aux": 16},
    "model": {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
              "intermediate_size": 128, "vocab_size": 512, "resnet_blocks": [2, 2, 2, 2]},
    "mix": {"pages": [{"name": "receipt", "hw": [320, 140], "share": 0.5},
                      {"name": "a4", "hw": [220, 170], "share": 0.5}],
            "segments": {"fixed": 16}, "max_tokens": 510, "token_ids": [3, 512],
            "image_pool": 2},
    "cell": {"train": {"batch": 4, "distinct_batches": 4, "niter_per_ep": 39,
                       "cls_sep": [0, 2]}, "limits": FP32_LIMITS},
}
SEED = 2**33 + 12345  # above 32 bits, as the driver's are


def _run(faults=None, seed=SEED):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.run(["--workload", CELL, "--seed", str(seed), "--seconds", "2"], device="cpu",
                     overrides=TINY, faults=faults)
    lines = out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]) if rc == 0 else None, err.getvalue()


@pytest.fixture(scope="module")
def sound():
    return _run()


def test_a_sound_run_prints_a_correct_result_line(sound):
    rc, result, err = sound
    assert rc == 0, err[-3000:]
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert result["correct"] is True, result["compared"]
    e2e, _ = cli.benchmark_entries(CELL)
    assert set(result["metrics"]) == {m["name"] for m in e2e} >= {"setup_s"}
    assert list(result)[-1] == "compared"
    assert err.strip().splitlines()[-1].startswith("compared ")


def test_the_reference_follows_the_program_in_fp32(sound):
    """On the CPU the program runs its kernels' plain versions in fp32: the
    reference, written apart from it, has to agree to fp32's rounding."""
    _, result, _ = sound
    notes = result["notes"]
    for got, want in zip(notes["losses"], notes["reference_losses"]):
        assert got == pytest.approx(want, rel=1e-4)
    assert result["compared"]["batch_mismatch"]["value"] == 0
    compared = {k: v["value"] for k, v in result["compared"].items()}
    assert compared["first_scores_gap"] < 1e-4
    assert compared["median_gradient_gap"] < 1e-3
    assert compared["median_first_change_gap"] < 1e-3
    # the program keeps its optimizer's state in bf16: its gradient, worked
    # out from that state, carries bf16's rounding
    assert compared["median_gradient_difference"] < 5e-3


def test_traffic_repeats_under_a_seed_and_differs_across_seeds():
    mix = dict(traffic.load_mix("b16-pages128"), segments={"median": 90, "sigma": 0.45,
                                                           "min": 40, "max": 200})
    a, b = traffic.documents(mix, SEED, 64), traffic.documents(mix, SEED, 64)
    c = traffic.documents(mix, SEED + 1, 64)
    assert all(np.array_equal(np.concatenate(x.ids), np.concatenate(y.ids)) for x, y in zip(a, b))
    assert all(np.array_equal(x.boxes, y.boxes) for x, y in zip(a, b))
    assert any(not np.array_equal(x.boxes, y.boxes) for x, y in zip(a, c))
    # the same work in another order: the multiset of sizes
    assert sorted(len(d.classes) for d in a) == sorted(len(d.classes) for d in c)
    for x, y in zip(traffic.page_images(mix, SEED), traffic.page_images(mix, SEED)):
        assert all(np.array_equal(p, q) for p, q in zip(x, y))


def _train_fault(kind):
    """A fault planted in the program's train step (``fault(stage, state,
    step)`` returns the step the harness drives)."""
    def fault(stage, state, step):
        if kind == "unchanged":  # the update leaves the parameters as they were
            state.optimizer.step = lambda *args, **kwargs: None
            return step
        if kind == "half_loss":  # the forward sees every document, the loss half of them
            model = state.model
            field, seg = model.field_type_head.forward, model.semantic_segmentation_head.forward

            def field_half(fuse, classes=None, valid=None, *, compute_loss=False, seeds=None):
                if compute_loss:
                    valid = valid.clone()
                    valid[valid.shape[0] // 2:] = False
                return field(fuse, classes, valid, compute_loss=compute_loss, seeds=seeds)

            def seg_half(p_fuse, classes, boxes, box_mask, *, train=False, seeds=None):
                n = p_fuse.shape[0] // 2
                return seg(p_fuse[:n], classes[:n], boxes[:n], box_mask[:n], train=train,
                           seeds=seeds)

            model.field_type_head.forward = field_half
            model.semantic_segmentation_head.forward = seg_half
            return step

        def half(state, batch, seeds):  # half of the batch left out
            n = batch.images.shape[0] // 2
            cut = type(batch)(**{f.name: getattr(batch, f.name)[:n]
                                 for f in dataclasses.fields(batch)})
            return step(state, cut, seeds)

        return half
    return fault


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "half_loss"])
def test_a_broken_train_step_is_not_correct(kind):
    rc, result, err = _run(_train_fault(kind))
    assert rc == 0, err[-3000:]
    assert result["correct"] is False, result["compared"]


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert cli.run(["--workload", CELL, "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
