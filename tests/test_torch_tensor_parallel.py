"""Tensor parallelism of the port (``mesh_model > 1``) on the CPU, at the tiny
width (``TextEncoderConfig.tiny``: 4 heads, so 2 a rank; ``resnet_18_fpn``).

- placement: ``parallel/sharding.py::split_axis`` against the JAX package's
  ``_spec_for`` on every leaf of the tiny JAX tree, through ``from_flax``'s
  names, and ``param_shardings`` on the port's model;
- kernel 1's twin on each model shard's heads, the dropout seed folded with
  ``data_index·model + model_index``: the masks (read out bit for bit) and
  the outputs against JAX ``flash_attention_sharded`` in interpret mode on a
  ``(1, 2)`` and a ``(2, 2)`` virtual CPU mesh;
- two gloo processes with ``model = 2`` (``tests/torch_parallel_worker.py``):
  the evaluation forward against one process and against the JAX forward
  on the converted weights;
- four gloo processes, ``data = 2 x model = 2``, hidden dropout on and
  attention dropout 0: a step and a clipped one against one process on
  the concatenated batch (losses, the whole gradients, the clip factors,
  the parameters after the first), the four ranks' parameters bit-equal;
  then a one-process checkpoint resumed under tensor parallelism and ZeRO-1
  for a step, whose checkpoint resumes in one process bit for bit;
- two four-rank runs of two steps and a clipped one, and two one-process
  runs of the same: each side gives the same bits in both runs, every
  tensor of the state after the third update;
- ``driver.main`` with ``mesh_model: 2`` on two ranks for an epoch.

The tolerances are ``tests/test_torch_parallel.py``'s: the same fp32
arithmetic, with the encoder's products split over two ranks and their
partial sums added after.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_parallel import REPO, _close_grads, _close_params, _same, _start, _wait
from tests.torch_checkpoints import checkpoints_dropped, drop_checkpoints  # noqa: F401

# each test's checkpoints go once it has read them back
pytestmark = pytest.mark.usefixtures("checkpoints_dropped")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- placement


def _jax_tiny_variables(**kw):
    from __graft_entry__ import _make_batch
    from vibertgrid_tpu.models.vibertgrid import ModelConfig as JaxConfig
    from vibertgrid_tpu.models.vibertgrid import ViBERTgridNet as JaxNet

    net = JaxNet(JaxConfig(attention_impl="xla", ffn_impl="xla", **kw))
    batch = _make_batch(b=2, h=64, w=96, t=510, s=8, vocab=512, seed=7)
    init = lambda: net.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                            batch, train=False, compute_loss=True, key=jax.random.PRNGKey(2))
    return net, batch, init


TINY = dict(num_classes=5, bert_version="tiny-bert-test", backbone="resnet_18_fpn",
            classifier_mode="simp")


def test_split_axes_follow_the_jax_rules():
    """Every leaf of the tiny JAX tree: ``_spec_for``'s ``model`` axis, on
    flax's ``[in, out]`` kernel, is ``split_axis``'s on the port's
    ``[out, in]`` weight of the same name, and the model's
    ``param_shardings`` under ``model = 2`` agrees."""
    from vibertgrid_tpu.parallel.sharding import _spec_for
    from vibertgrid_tpu_torch.convert import _leaf
    from vibertgrid_tpu_torch.models.vibertgrid import ModelConfig, ViBERTgridNet
    from vibertgrid_tpu_torch.parallel.mesh import Layout
    from vibertgrid_tpu_torch.parallel.sharding import param_shardings, split_axis

    _, _, init = _jax_tiny_variables(**TINY)
    shapes = jax.eval_shape(init)["params"]
    model = ViBERTgridNet(ModelConfig(**TINY), device="cpu")
    port = dict(model.named_parameters())
    by_param = param_shardings(model, Layout(data=1, model=2))
    split = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [k.key for k in path]
        spec = tuple(_spec_for(path, leaf))
        want = None
        if "model" in spec:
            axis = spec.index("model")
            want = 1 - axis if leaf.ndim == 2 else axis  # [in, out] -> [out, in]
        prefix = [f"layer.{k[6:]}" if k.startswith("layer_") else k for k in keys[:-1]]
        name = ".".join(prefix + [_leaf(keys[-1], np.zeros(leaf.shape, np.float32))[0]])
        assert name in port, name
        assert split_axis(name, port[name].ndim) == want, (name, spec)
        assert by_param[port[name]] == want, name
        split += want is not None
    # per layer: q, k, v weights and biases, the out weight, the up-projection's
    # weight and bias, the down-projection's weight
    assert split == 10 * 2
    assert all(ax is None for ax in param_shardings(model, Layout()).values())


# ------------------------------------------------------------------ kernel 1


@pytest.mark.parametrize("dp", [1, 2])
def test_attention_on_each_model_shard_folds_the_seed_as_jax(dp):
    """Kernel 1's twin on the ``(d, m)`` shard's rows and heads, inside a
    train step's context, against JAX ``flash_attention_sharded`` on a
    ``(dp, 2)`` mesh in interpret mode. With q = k = 0 every probability is
    1/n over n valid keys (16, or 8 in the padded row) and v's key j is 2^j,
    so each output is ``2/n·Σ 2^j`` over the kept keys, exact in any order:
    the masks compare bit for bit. Then random inputs within fp32 summation
    noise."""
    from vibertgrid_tpu.ops.flash_attention import flash_attention_sharded
    from vibertgrid_tpu.parallel.mesh import make_mesh as jax_mesh
    from vibertgrid_tpu_torch.ops.flash_attention import flash_attention
    from vibertgrid_tpu_torch.parallel.collectives import global_batch
    from vibertgrid_tpu_torch.parallel.mesh import Layout

    b, t, heads, dh, mp, rate, seed = 2 * dp, 16, 4, 8, 2, 0.5, 20240607
    m = heads * dh
    rng = np.random.default_rng(3)
    bias = np.zeros((b, t), np.float32)
    bias[0, 8:] = -1e9  # padded keys in the first row (8 valid: probabilities 1/8)
    keys = np.broadcast_to(2.0 ** np.arange(t, dtype=np.float32)[None, :, None], (b, t, m))
    cases = {"masks": (np.zeros((b, t, m), np.float32),) * 2 + (np.ascontiguousarray(keys),),
             "random": tuple(rng.standard_normal((b, t, m)).astype(np.float32)
                             for _ in range(3))}
    mesh = jax_mesh(data=dp, model=mp)
    for case, (q, k, v) in cases.items():
        want = np.asarray(flash_attention_sharded(
            *(jnp.asarray(x) for x in (q, k, v, bias)), jnp.int32(seed), dh ** -0.5, heads,
            rate, True, mesh=mesh))
        got = np.empty_like(want)
        for d in range(dp):
            for mi in range(mp):
                rows = slice(d * b // dp, (d + 1) * b // dp)
                cols = slice(mi * m // mp, (mi + 1) * m // mp)
                with global_batch(True, Layout(dp, mp, d, mi)), torch.no_grad():
                    got[rows, :, cols] = flash_attention(
                        *(torch.from_numpy(np.ascontiguousarray(x[rows, :, cols]))
                          for x in (q, k, v)),
                        torch.from_numpy(bias[rows]), dh ** -0.5, heads // mp,
                        rate=rate, seed=seed).numpy()
        if case == "masks":
            np.testing.assert_array_equal(got, want)
            kept = got[1:, :, ::dh] * 8  # Σ 2^j over the kept keys: a row's mask as bits
            assert 0 < np.mean([bin(int(x)).count("1") for x in kept.ravel()]) < t
        else:
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    # the shards' streams differ: without the fold shard (0, 1) would draw (0, 0)'s
    assert not np.array_equal(got[:, :, :m // mp], got[:, :, m // mp:])


# ------------------------------------------------------------------ forward


@pytest.fixture(scope="module")
def forward_case():
    """The tiny JAX model's converted weights, its forward, and the port's
    in one process on the same weights."""
    from tests.test_torch_model import _perturb
    from vibertgrid_tpu_torch.convert import from_flax
    from vibertgrid_tpu_torch.entry import make_batch
    from vibertgrid_tpu_torch.models.vibertgrid import ModelConfig, ViBERTgridNet

    net, batch, init = _jax_tiny_variables(**TINY)
    variables = _perturb(init())
    out = variables["params"]["field_type_head"]["category_net"]["out"]
    out["kernel"] = out["kernel"] * 0.01  # O(1) logits, as tests/test_torch_model.py
    jax_pred = np.asarray(net.apply(variables, batch, train=False, compute_loss=False,
                                    key=jax.random.PRNGKey(0)).pred_label)
    state = from_flax(variables)
    shape = dict(b=2, h=64, w=96, t=510, s=8, vocab=512, seed=7)
    model = ViBERTgridNet(ModelConfig(**TINY), device="cpu").eval()
    model.load_state_dict(state)
    with torch.no_grad():
        one = model(make_batch(**shape, device="cpu")).pred_label.numpy()
    return dict(state=state, model_kw=TINY, shape=shape), jax_pred, one


def test_two_model_ranks_forward_as_one_process_and_jax(forward_case, tmp_path):
    inp, jax_pred, one = forward_case
    got = _wait(_start("tp_forward", inp, tmp_path, 2))
    assert [g["index"] for g in got] == [(0, 0), (0, 1)]
    shapes = got[0]["shapes"]
    assert shapes["bert_model.layer.0.attention.query.weight"] == (32, 64)
    assert shapes["bert_model.layer.1.output.weight"] == (64, 64)  # [D, F/2]
    assert shapes["bert_model.layer.0.attention.out.bias"] == (64,)
    for g in got:
        pred = g["pred"].numpy()
        # the out-projection's and the FFN's sums split in two halves
        np.testing.assert_allclose(pred, one, atol=1e-5, rtol=0)
        np.testing.assert_allclose(pred, jax_pred, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got[0]["pred"].numpy(), got[1]["pred"].numpy())


# -------------------------------------------------------------------- train


HIDDEN_DROPOUT = 0.1


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """Four ranks (``data = 2 x model = 2``) and, meanwhile, one process on
    the concatenated batch: a step and a clipped one; then three plain
    steps, the first saved as the checkpoint the ranks resume."""
    from tests.test_torch_train import MODEL_KW, SHAPE, TRAIN_HYP
    from tests.torch_parallel_worker import run_tp_steps, tp_config
    from vibertgrid_tpu_torch.entry import train_entry
    from vibertgrid_tpu_torch.train.checkpoint import CheckpointManager
    from vibertgrid_tpu_torch.train.seeds import step_seeds
    from vibertgrid_tpu_torch.train.state import make_train_step

    tmp = tmp_path_factory.mktemp("tp_train")
    inp = dict(model_kw=MODEL_KW, hyp=TRAIN_HYP, shape=dict(SHAPE, b=4), seed=5, min_size=128,
               hidden_dropout=HIDDEN_DROPOUT, ckpt_dir=str(tmp / "ckpt"))
    cfg = tp_config(inp, None, HIDDEN_DROPOUT)
    state, _, batch = train_entry("cpu", config=cfg, hyp=inp["hyp"], shape=inp["shape"])
    ckpt = CheckpointManager(inp["ckpt_dir"])
    # the one-process state after one step, which the ranks resume
    make_train_step()(state, batch, step_seeds(inp["seed"], 0))
    ckpt.save(state, "one")
    run = _start("tp_train", inp, tmp, 4)

    single = {}
    state, _, _ = train_entry("cpu", config=cfg, hyp=inp["hyp"], shape=inp["shape"])
    single["plain"] = run_tp_steps(state, batch, inp["seed"], 1, None, clip_steps=1)
    state, _, _ = train_entry("cpu", config=cfg, hyp=inp["hyp"], shape=inp["shape"])
    ckpt.restore("one", state)
    single["resumed"] = run_tp_steps(state, batch, inp["seed"], 1, None)  # step 2
    single["third"] = run_tp_steps(state, batch, inp["seed"], 1, None)  # step 3
    yield _wait(run, timeout=400), single, inp
    drop_checkpoints(tmp)


def test_four_ranks_step_as_one_process(train_runs):
    """One step, then one whose clip fires: the losses, the first step's
    gradients and parameters, and both clip factors against one process;
    the four ranks' models after both steps bit-equal. (The parameters after
    the second update are not compared with one process: BatchNorm's
    statistics then follow AdamW's ±lr moves of elements whose gradients sit
    at the rounding level, which the encoder's split sums perturb.)"""
    got, single, _ = train_runs
    want = single["plain"]
    assert [g["layout"] for g in got] == [(2, 2, d, m) for d in range(2) for m in range(2)]
    for g in (r["plain"] for r in got):
        np.testing.assert_allclose(g["losses"], want["losses"], rtol=2e-5)
        _close_grads(g["grads"], want["grads"])
        _close_params(g["params"], want["params"], steps=1)
        # the clip's norm: the split gradients once, the replicated ones once
        np.testing.assert_allclose(g["scales"], want["scales"], rtol=1e-3)
    assert want["scales"][1] < 1e-2 and want["scales"][0] == 1.0
    # every rank holds the same model: a model group's replicated parameters
    # bit for bit, and the same slices on the two data shards
    assert all(_same(got[0]["plain"]["final"], g["plain"]["final"]) for g in got[1:])
    assert all(g["plain"]["scales"] == got[0]["plain"]["scales"] for g in got)


def test_a_one_process_checkpoint_resumes_under_tp_and_zero1(train_runs):
    got, single, _ = train_runs
    want = single["resumed"]
    for g in (r["zero1"] for r in got):
        assert g["step"] == 2 and g["split"] > 0
        np.testing.assert_allclose(g["losses"], want["losses"], rtol=2e-5)
        _close_params(g["final"], want["final"], steps=1)
    assert all(_same(got[0]["zero1"]["final"], g["zero1"]["final"]) for g in got[1:])


def test_a_tp_checkpoint_resumes_in_one_process(train_runs):
    from tests.torch_parallel_worker import kept, run_tp_steps, tp_config
    from vibertgrid_tpu_torch.entry import train_entry
    from vibertgrid_tpu_torch.train.checkpoint import restore_checkpoint

    got, single, inp = train_runs
    state, _, batch = train_entry("cpu", config=tp_config(inp, None, HIDDEN_DROPOUT),
                                  hyp=inp["hyp"], shape=inp["shape"])
    restore_checkpoint(os.path.join(inp["ckpt_dir"], "tp"), state)
    assert state.step == 2 and state.optimizer.count == 2 and not state.optimizer.shards
    # the whole tensors the ranks held, bit for bit, and the one-process run's
    assert _same(kept(state.model.state_dict()), got[0]["zero1"]["final"])
    _close_params(kept(state.model.state_dict()), single["resumed"]["final"], steps=1)
    third = run_tp_steps(state, batch, inp["seed"], 1, None)
    np.testing.assert_allclose(third["losses"], single["third"]["losses"], rtol=2e-5)


@pytest.fixture(scope="module")
def repeat_runs(tmp_path_factory):
    """Two runs of ``tests/torch_parallel_worker.py::tp_three_steps`` on
    four ranks (``data = 2 x model = 2``), one after the other, and
    meanwhile two in this process on the concatenated batch."""
    from tests.test_torch_train import MODEL_KW, SHAPE, TRAIN_HYP
    from tests.torch_parallel_worker import tp_three_steps

    inp = dict(model_kw=MODEL_KW, hyp=TRAIN_HYP, shape=dict(SHAPE, b=4), seed=5,
               hidden_dropout=HIDDEN_DROPOUT)
    ranks, single = [], []
    for k in range(2):
        run = _start("tp_repeat", inp, tmp_path_factory.mktemp(f"tp_repeat{k}"), 4)
        single.append(tp_three_steps(inp))
        ranks.append(_wait(run, timeout=400))
    return ranks, single


def test_four_ranks_repeat_their_third_step_bit_for_bit(repeat_runs):
    """The step is deterministic under tensor parallelism: a second run of
    the four ranks gives each rank's losses and every tensor of its state
    after the third update bit for bit, and the four ranks hold one model."""
    ranks, _ = repeat_runs
    first, second = ranks
    for a, b in zip(first, second):
        assert a["losses"] == b["losses"]
        assert a["digests"] == b["digests"]
    assert all(g["digests"] == first[0]["digests"] for g in first[1:])


def test_one_process_repeats_its_third_step_bit_for_bit(repeat_runs):
    """The reference the four ranks are held to is deterministic too, so a
    gap between them is the other summation order of the split sums, not
    noise (ROADMAP, "Properties")."""
    _, (a, b) = repeat_runs
    assert a["losses"] == b["losses"] and a["digests"] == b["digests"]
    assert len(a["digests"]) > 100


FIRST_CALL = """
import torch
from vibertgrid_tpu_torch.device import resolve_device
torch.set_num_threads(2)
resolve_device("cpu")
g = torch.Generator().manual_seed(0)
x = torch.rand(2, 2, 510, 510, generator=g) * 3 + 0.01
a = torch.randn(2, 2, 510, 16, generator=g)
torch.matmul(a, a.transpose(-1, -2))
print(torch.equal(torch.tanh(x), torch.tanh(x)))
"""


def test_vector_math_first_call_repeats_after_a_cpu_device_is_resolved():
    """The fault behind a four-rank run that missed the other bits
    (``device.py::settle_vector_math``): right after a BLAS product, the
    first two-thread call of ``exp``, ``log``, ``erf``, ``tanh`` or ``sqrt``
    in a process computed one thread's half with another code path in 5-16%
    of processes. Once the CPU device is resolved, the first ``tanh`` equals
    the second in each of 24 fresh processes."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    outs = []
    for _ in range(6):
        procs = [subprocess.Popen([sys.executable, "-c", FIRST_CALL], cwd=REPO, env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for _ in range(4)]
        outs += [p.communicate(timeout=120)[0].strip() for p in procs]
    assert outs == ["True"] * 24, outs


# ------------------------------------------------------------------- driver


def test_driver_main_trains_an_epoch_with_two_model_ranks(tmp_path):
    from tests.test_torch_parallel import _tiny_hyp
    from vibertgrid_tpu_torch.data.synthetic import make_synthetic_root

    root = make_synthetic_root(str(tmp_path / "synth"), n_train=8, n_test=3, seed=0)
    hyp = _tiny_hyp(root, tmp_path, end_epoch=1, mesh_model=2)
    config = tmp_path / "tiny.yaml"
    config.write_text(yaml.safe_dump(hyp))
    a, b = _wait(_start("tp_driver", dict(config=str(config)), tmp_path, 2))
    # one data shard of 8 documents, batch 2: 4 steps, the same on both ranks
    assert a["losses"] == b["losses"] and len(a["losses"]) == 4
    assert np.isfinite(a["losses"]).all() and a["steps"] == b["steps"] == 4
    assert a["f1"] == b["f1"] and a["loss"] == b["loss"]
    assert a["schedule_len"] == (8 // hyp["batch_size"] + 1) * hyp["end_epoch"]
    assert a["docs"] == [4 * hyp["batch_size"]]
    assert len(os.listdir(tmp_path / "w")) == 1
