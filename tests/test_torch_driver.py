"""The port's training driver on the CPU, modelled on ``tests/test_train_driver.py``
(the tiny config: ``tiny-bert-test``, ``resnet_18_fpn``, 256 px, synthetic
roots); the JAX driver is not run, so no JAX train step compiles.

- ``train(..., device="cpu")``: finite losses, checkpoints kept by F1, a
  resumed run whose epoch and step count carry on;
- two epochs straight give bit-equal parameters, statistics and optimizer
  state to one epoch, a checkpoint and a resumed epoch (each step's seeds are
  a function of the run's seed and the step);
- the CRF head with BIO tags trains and validates with seqeval; with strcmp
  it raises;
- ``main`` on ``configs/synthetic_smoke.yaml`` with ``-d synthetic``;
- the keys of the distributed layer in one process: ``zero1`` trains as
  without it, the others raise;
- the full head on the fused attention epilogue takes two steps.

The learnability run of ``tests/test_learnability.py`` (24 epochs) takes
minutes on a CPU; ``chip_smoke.py``'s driver phase runs it on the card, and
the last test holds its config to the learnability test's.
"""

import os

import numpy as np
import pytest
import torch

from tests.test_train_driver import tiny_hyp
from vibertgrid_tpu_torch.data.synthetic import make_synthetic_root, synthetic_spec
from vibertgrid_tpu_torch.train import driver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs six workers on the machine's cores; torch's default of
    a thread a core in each makes their CPU kernels wait on each other, so
    this module's training runs take two."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _hyp(tmp_path, root, **kw):
    hyp = tiny_hyp(root)
    hyp.update(save_top=str(tmp_path / "w"), save_log=str(tmp_path / "l"), **kw)
    return hyp


def _losses(results):
    return [x for epoch in results["timings"]["train"] for x in epoch["losses"]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_synthetic_root(str(tmp_path_factory.mktemp("synth")), n_train=4, n_test=2, seed=0)


@pytest.fixture(scope="module")
def runs(root, tmp_path_factory):
    """Two epochs of two steps straight; the first epoch alone (a
    ``max_steps`` stop); the second resumed from the first's checkpoint."""
    tmp = tmp_path_factory.mktemp("runs")
    spec = synthetic_spec()
    straight = driver.train(_hyp(tmp / "a", root), "sroie", spec=spec, device="cpu")
    first = driver.train(_hyp(tmp / "b", root), "sroie", spec=spec, max_steps=2, device="cpu")
    saved = sorted(os.listdir(tmp / "b" / "w"))
    resumed = driver.train(_hyp(tmp / "c", root, weights=str(tmp / "b" / "w" / saved[0])),
                           "sroie", spec=spec, device="cpu")
    return dict(straight=straight, first=first, resumed=resumed, saved=saved,
                straight_saved=sorted(os.listdir(tmp / "a" / "w")))


def test_train_saves_by_f1_and_resumes(runs):
    results = runs["straight"]
    losses = _losses(results)
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert np.isfinite(results["primary_F1"]) and np.isfinite(results["loss"])
    assert results["final_state"].step == 4
    assert [e["epoch"] for e in results["timings"]["train"]] == [0, 1]
    assert len(results["timings"]["validate"]) == 3  # initial, and after each epoch
    saved = runs["straight_saved"]
    assert saved[0].startswith("epoch0_")
    # a later checkpoint only where its F1 beat every earlier one's
    f1s = [float(e.rsplit("_", 1)[-1]) for e in saved]
    assert f1s == sorted(f1s) and len(set(f1s)) == len(f1s)

    # a max_steps stop validates and saves; the resumed run carries on
    assert runs["saved"] == [e for e in runs["saved"] if e.startswith("epoch0_")] != []
    assert len(runs["first"]["timings"]["validate"]) == 2
    resumed = runs["resumed"]
    assert [e["epoch"] for e in resumed["timings"]["train"]] == [1]
    assert resumed["final_state"].step == resumed["final_state"].optimizer.count == 4
    assert np.isfinite(_losses(resumed)).all() and np.isfinite(resumed["primary_F1"])


def test_resume_is_bit_equal_to_a_straight_run(runs):
    assert _losses(runs["first"]) + _losses(runs["resumed"]) == _losses(runs["straight"])
    a, b = runs["straight"]["final_state"], runs["resumed"]["final_state"]
    assert a.step == b.step == 4
    for (name, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), name
    named_a = dict(a.model.named_parameters())
    named_b = dict(b.model.named_parameters())
    for name, p in named_a.items():
        for slot, value in a.optimizer.state[p].items():
            assert torch.equal(value, b.optimizer.state[named_b[name]][slot]), (name, slot)


def test_crf_bio_trains_with_seqeval_and_refuses_strcmp(tmp_path):
    root = make_synthetic_root(str(tmp_path / "data"), n_train=4, n_test=2, seed=3,
                               tag_scheme="BIO")
    hyp = _hyp(tmp_path, root, classifier_mode="crf", tag_mode="BIO", eval_mode="seqeval",
               end_epoch=1)
    results = driver.train(hyp, "sroie", spec=synthetic_spec(), max_steps=2, device="cpu")
    assert np.isfinite(_losses(results)).all() and len(_losses(results)) == 2
    assert np.isfinite(results["primary_F1"]) and "token_F1" in results and "F1" not in results
    with pytest.raises(ValueError, match="seqeval"):
        driver.train(dict(hyp, eval_mode="strcmp"), "sroie", spec=synthetic_spec(),
                     max_steps=1, device="cpu")


def test_main_on_the_smoke_config(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    config = os.path.join(ROOT, "vibertgrid_tpu_torch", "configs", "synthetic_smoke.yaml")
    if torch.cuda.is_available():
        pytest.skip("main runs on the card where there is one")
    with pytest.raises(RuntimeError, match="cuda"):
        driver.main(["-c", config, "-d", "synthetic", "--max-steps", "2"])
    monkeypatch.setattr(driver, "resolve_device", lambda device: torch.device("cpu"))
    results = driver.main(["-c", config, "-d", "synthetic", "--max-steps", "2"])
    assert (tmp_path / "synthetic_data" / "train").is_dir()
    assert results["final_state"].step == 2 and np.isfinite(_losses(results)).all()
    assert any(e.startswith("epoch0_") for e in os.listdir(tmp_path / "weights_smoke"))


@pytest.mark.parametrize("key, value", [("zero1", True), ("mesh_data", 2), ("mesh_model", 2),
                                        ("WORLD_SIZE", "2")])
def test_distributed_keys_raise(root, tmp_path, monkeypatch, key, value, runs):
    """In one process: ``zero1`` trains as without it (the JAX driver's
    ZeRO-1 on a data axis of 1); a data axis of 2 raises, tensor parallelism
    raises ``NotImplementedError`` (not ported); ``WORLD_SIZE=2`` with no
    rendezvous raises instead of training alone. Two processes train in
    ``tests/test_torch_parallel.py``."""
    hyp = _hyp(tmp_path, root)
    if key == "WORLD_SIZE":
        monkeypatch.setenv(key, value)
    else:
        hyp[key] = value
    if key == "zero1":
        results = driver.train(hyp, "sroie", spec=synthetic_spec(), max_steps=2, device="cpu")
        assert _losses(results) == _losses(runs["first"])
        assert not results["final_state"].optimizer.shards
        return
    raises = {"mesh_data": (ValueError, "mesh_data=2"),
              "mesh_model": (NotImplementedError, "tensor parallelism"),
              "WORLD_SIZE": (RuntimeError, "rendezvous")}[key]
    with pytest.raises(raises[0], match=raises[1]):
        driver.train(hyp, "sroie", spec=synthetic_spec(), device="cpu")


def test_full_head_on_the_fused_epilogue_takes_two_steps(root, tmp_path):
    from vibertgrid_tpu_torch.models.bert import EncoderLayer

    hyp = _hyp(tmp_path, root, classifier_mode="full", attn_epilogue="fused", end_epoch=1)
    _, cfg, model, *_ = driver.build_all(hyp, "sroie", spec=synthetic_spec(), device="cpu")
    assert cfg.resolved_text_config().attn_epilogue == "fused"
    assert all(layer.config.attn_epilogue == "fused" for layer in model.modules()
               if isinstance(layer, EncoderLayer))
    results = driver.train(hyp, "sroie", spec=synthetic_spec(), max_steps=2, device="cpu")
    assert len(_losses(results)) == 2 and np.isfinite(_losses(results)).all()
    assert np.isfinite(results["primary_F1"])


def test_chip_smoke_learnability_config_is_the_tests(root):
    """The driver phase of ``chip_smoke.py`` runs ``tests/test_learnability.py``'s
    config and thresholds."""
    import chip_smoke

    want = tiny_hyp(root)
    want.update(end_epoch=24, batch_size=4, eval_mode="seqeval", mesh_data=1, mesh_model=1)
    want["optimizer_cnn_hyp"].update(learning_rate=5e-3, warm_up_epoches=3)
    want["optimizer_bert_hyp"].update(learning_rate=5e-4, warm_up_epoches=3)
    for key in ("data_root", "tokenizer_path"):
        del want[key]
    assert chip_smoke.LEARN_HYP == want
    assert (chip_smoke.LEARN_F1, chip_smoke.LEARN_TYPES) == (0.5, 2)
