"""Training in the port against the JAX package's: the schedule arrays, the
dual optimizer's updates, and the train step as a whole on a tiny
configuration, from one set of weights (CPU, fp32).

The JAX side runs its Pallas kernels in interpret mode
(``attention_impl="flash"``, ``ffn_impl="fused-saved"``); the port runs on the
CPU, so its kernel wrappers take their plain twins.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vibertgrid_tpu_torch.convert import from_flax, optimizer_state_from_optax

HYP = {
    "optimizer_cnn_hyp": dict(learning_rate=0.05, warm_up_epoches=0, momentum=0.9,
                              weight_decay=5e-3, min_weight_decay=5e-4),
    "optimizer_bert_hyp": dict(learning_rate=2e-3, warm_up_epoches=0, beta1=0.9, beta2=0.999,
                               epsilon=1e-8, weight_decay=0.05, min_weight_decay=0.01),
    "lr_steps": [1],  # the learning rates drop tenfold after one "epoch" of two iterations
}


# ----------------------------------------------------------------- schedules


@pytest.mark.parametrize("kw", [
    dict(epoches=3, niter_per_ep=7),
    dict(epoches=4, niter_per_ep=5, warmup_epoches=1, start_warmup_value=1e-6),
    dict(epoches=4, niter_per_ep=5, warmup_epoches=1, warmup_steps=3),
])
def test_cosine_scheduler_matches_jax(kw):
    from vibertgrid_tpu.train.schedules import cosine_scheduler as jax_fn
    from vibertgrid_tpu_torch.train.schedules import cosine_scheduler

    np.testing.assert_array_equal(cosine_scheduler(5e-4, 1e-5, **kw), jax_fn(5e-4, 1e-5, **kw))


@pytest.mark.parametrize("kw", [
    dict(steps=[15], num_epoches=20, niter_per_ep=9),
    dict(steps=[2, 4, 40], num_epoches=6, niter_per_ep=5),
    dict(steps=[2], num_epoches=5, niter_per_ep=4, warmup_epoches=1, start_warmup_value=1e-6),
])
def test_step_scheduler_matches_jax(kw):
    from vibertgrid_tpu.train.schedules import array_schedule
    from vibertgrid_tpu.train.schedules import step_scheduler as jax_fn
    from vibertgrid_tpu_torch.train.schedules import schedule_value, step_scheduler

    got, want = step_scheduler(0.005, gamma=0.1, **kw), jax_fn(0.005, gamma=0.1, **kw)
    np.testing.assert_array_equal(got, want)
    sched = array_schedule(want)
    for step in (0, 3, len(want) - 1, len(want) + 5):  # past the end: the last value
        assert schedule_value(got, step) == float(sched(jnp.int32(step)))


# ----------------------------------------------------------------- optimizer


def _param_tree(rng):
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return {
        "bert_model": {"layer_0": {"dense": {"kernel": f(4, 3), "bias": f(3)}},
                       "embed": {"embedding": f(6, 4)}},
        "backbone": {"conv": {"kernel": f(3, 3, 2, 4)}, "bn": {"scale": f(4), "bias": f(4)}},
        "head": {"out": {"kernel": f(4, 2), "bias": f(2)}},
    }


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_dual_optimizer_matches_optax(state_dtype):
    import optax

    from vibertgrid_tpu.train.optim import make_optimizer as jax_make
    from vibertgrid_tpu_torch.train.optim import make_optimizer, param_group_label

    hyp = dict(HYP, optimizer_state_dtype=state_dtype)
    rng = np.random.default_rng(20)
    params = _param_tree(rng)
    grads = [jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                                    params) for _ in range(4)]
    tx, want_sched = jax_make(hyp, num_epochs=3, niter_per_ep=2, return_schedules=True)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jparams)

    def jax_step(p, s, g):
        updates, s = tx.update(jax.tree_util.tree_map(jnp.asarray, g), s, p)
        return optax.apply_updates(p, updates), s

    # one update on the JAX side, then both continue from that state
    jparams, jstate = jax_step(jparams, jstate, grads[0])
    named = [(n, torch.nn.Parameter(t.clone())) for n, t in from_flax({"params": jparams}).items()]
    assert {param_group_label(n) for n, _ in named} == {"bert", "cnn"}
    opt, sched = make_optimizer(hyp, num_epochs=3, niter_per_ep=2, named_parameters=named,
                                return_schedules=True)
    for key in want_sched:
        np.testing.assert_array_equal(sched[key], want_sched[key])
    converted = optimizer_state_from_optax(jstate)
    assert converted["count"] == 1
    opt.load_named_state(named, converted["state"], converted["count"])
    slot = opt.state[dict(named)["backbone.conv.weight"]]["momentum"]
    assert slot.dtype == getattr(torch, state_dtype) and slot.abs().sum() > 0

    for g in grads[1:]:
        jparams, jstate = jax_step(jparams, jstate, g)
        tg = from_flax({"params": g})
        for n, p in named:
            p.grad = tg[n].clone()
        opt.step()
        want = from_flax({"params": jparams})
        for n, p in named:
            # fp32 arithmetic in the same order on both sides
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), atol=1e-6, rtol=1e-6,
                                       err_msg=n)
    assert opt.count == 4
    after = optimizer_state_from_optax(jstate)["state"]
    tol = 1e-6 if state_dtype == "float32" else 2 ** -8  # one bf16 ulp where a rounding flips
    for n, p in named:
        for slot, value in opt.state[p].items():
            np.testing.assert_allclose(value.float().numpy(), after[n][slot].numpy(),
                                       atol=tol * 1e-2, rtol=tol, err_msg=f"{n} {slot}")


def test_clip_scale_follows_the_reference_rule():
    from vibertgrid_tpu_torch.train.state import clip_scale

    grads = [torch.full((4,), 3.0), torch.full((3, 3), 1.0)]  # global norm sqrt(45)
    gnorm = 45 ** 0.5
    spike, calm = torch.tensor(11.0), torch.tensor(9.0)
    assert clip_scale(spike, grads, 10.0, 2.0).item() == pytest.approx(2.0 / gnorm)
    assert clip_scale(calm, grads, 10.0, 2.0).item() == 1.0     # the loss did not spike
    assert clip_scale(spike, grads, 10.0, 7.0).item() == 1.0    # the norm is small enough


# ------------------------------------------------------------ the train step

MODEL_KW = dict(
    num_classes=5, bert_version="tiny-bert-test", backbone="resnet_18_fpn",
    classifier_mode="simp", num_hard_positive_main_1=3, num_hard_negative_main_1=3,
    num_hard_positive_main_2=3, num_hard_negative_main_2=3,
    loss_aux_sample_list=[40, 60, 40], num_hard_positive_aux=50, num_hard_negative_aux=70,
)
SHAPE = dict(b=2, h=64, w=96, t=510, s=8, vocab=512, seed=7)
TRAIN_HYP = dict(HYP, optimizer_state_dtype="float32")
STEP_KEY = 5


def _loss_seeds(key, step):
    """The four loss seeds of one JAX train step, as the JAX package derives
    them from the step key (train/state.py, models/vibertgrid.py,
    models/seg_head.py, models/heads.py)."""
    from vibertgrid_tpu.ops.dropout import derive_seed

    k_loss, _ = jax.random.split(jax.random.fold_in(key, step))
    k_seg, k_head = jax.random.split(k_loss)
    keys = [*jax.random.split(k_seg), *jax.random.split(k_head)]
    return [int(derive_seed(k)) for k in keys]


@pytest.fixture(scope="module")
def train_pair():
    """Three JAX train steps (and the first step's gradients) and the port's
    state loaded from the same initial variables."""
    from __graft_entry__ import _make_batch
    from tests.test_torch_model import _perturb
    from vibertgrid_tpu.models.bert import TextEncoderConfig as JaxTextConfig
    from vibertgrid_tpu.models.vibertgrid import ModelConfig as JaxConfig
    from vibertgrid_tpu.models.vibertgrid import ViBERTgridNet as JaxNet
    from vibertgrid_tpu.train.optim import make_optimizer as jax_make
    from vibertgrid_tpu.train.state import TrainState as JaxState
    from vibertgrid_tpu.train.state import make_train_step as jax_make_step
    from vibertgrid_tpu_torch.entry import train_entry
    from vibertgrid_tpu_torch.models.bert import TextEncoderConfig
    from vibertgrid_tpu_torch.models.vibertgrid import ModelConfig

    # dropout off: flax's per-site keys cannot be replayed without JAX; the
    # dropout sites are held against JAX one by one in test_torch_train_ops.py
    no_drop = dict(hidden_dropout=0.0, attention_dropout=0.0)
    jcfg = JaxConfig(attention_impl="flash", ffn_impl="fused-saved",
                     text_config=dataclasses.replace(JaxTextConfig.tiny("bert"), **no_drop),
                     **MODEL_KW)
    jnet = JaxNet(jcfg)
    jbatch = _make_batch(**SHAPE)
    variables = _perturb(jnet.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jbatch, train=True, compute_loss=True, key=jax.random.PRNGKey(2)))
    tx = jax_make(TRAIN_HYP, num_epochs=2, niter_per_ep=100)
    jstate = JaxState(params=variables["params"], batch_stats=variables["batch_stats"],
                      opt_state=tx.init(variables["params"]), step=jnp.zeros((), jnp.int32))
    key = jax.random.PRNGKey(STEP_KEY)

    def first_step(params):
        k_loss, k_drop = jax.random.split(jax.random.fold_in(key, 0))
        out, mutated = jnet.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jbatch, train=True,
            compute_loss=True, key=k_loss, rngs={"dropout": k_drop}, mutable=["batch_stats"])
        return out.total_loss, (out.loss_c, out.loss_aux, mutated["batch_stats"])

    (total, (loss_c, loss_aux, stats)), grads = jax.jit(
        jax.value_and_grad(first_step, has_aux=True))(variables["params"])
    jax_step = jax_make_step(jnet, tx)
    losses = []
    for _ in range(3):
        jstate, loss = jax_step(jstate, jbatch, key)
        losses.append(float(loss))

    cfg = ModelConfig(text_config=dataclasses.replace(TextEncoderConfig.tiny("bert"), **no_drop),
                      **MODEL_KW)
    state, train_step, batch = train_entry("cpu", config=cfg, hyp=TRAIN_HYP, shape=SHAPE)
    state.model.load_state_dict(from_flax(variables), strict=True)
    jax_out = dict(total=float(total), loss_c=float(loss_c), loss_aux=float(loss_aux),
                   grads=from_flax({"params": grads}), stats=from_flax({"params": {},
                                                                       "batch_stats": stats}),
                   losses=losses, params=from_flax({"params": jstate.params}), key=key)
    return jax_out, state, train_step, batch


def test_train_step_matches_jax(train_pair):
    from vibertgrid_tpu_torch.train.seeds import ReplaySeeds

    want, state, train_step, batch = train_pair
    model = state.model

    # the first step's losses and gradients, without updating anything
    before = {k: v.clone() for k, v in model.state_dict().items()}
    out = model(batch, train=True, compute_loss=True, seeds=ReplaySeeds(_loss_seeds(want["key"], 0)))
    # fp32 through ~40 layers on both sides
    np.testing.assert_allclose(out.loss_c.item(), want["loss_c"], rtol=2e-5)
    np.testing.assert_allclose(out.loss_aux.item(), want["loss_aux"], rtol=2e-5)
    np.testing.assert_allclose(out.total_loss.item(), want["total"], rtol=2e-5)
    assert out.pred_mask.shape == (2, 64, 96, 3) and out.pred_ss.shape == (2, 64, 96, 5)
    out.total_loss.backward()
    named = dict(model.named_parameters())
    for name in ("bert_model.word_embeddings.weight", "bert_model.layer.0.attention.query.weight",
                 "bert_model.layer.1.intermediate.weight", "bert_model.layer.1.output_ln.bias",
                 "backbone.stem_conv.weight", "backbone.early_fusion.weight",
                 "backbone.stage3_block1.bn1.weight", "late_fusion.roi_embedding.bn1.bias",
                 "semantic_segmentation_head.encoder.conv1.weight",
                 "field_type_head.pos_neg_net.out.weight"):
        got, ref = named[name].grad.numpy(), want["grads"][name].numpy()
        # fp32 on both sides. The backward through ~40 layers with batch
        # statistics of two small images amplifies the last-bit differences
        # of the forward (sums in other orders): measured up to 2e-3 of the
        # gradient's largest entry, against errors of order 1 for a wrong rule
        np.testing.assert_allclose(got, ref, atol=5e-3 * np.abs(ref).max(), rtol=1e-3, err_msg=name)
    # the running statistics after one training forward
    stats = {k: v for k, v in model.state_dict().items() if "running_" in k}
    assert len(stats) == len(want["stats"]) > 40
    for name, value in stats.items():
        assert not torch.equal(value, before[name]), name
        np.testing.assert_allclose(value.numpy(), want["stats"][name].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=name)

    # three whole steps from the initial state: the loss the JAX step reports
    model.load_state_dict(before)
    losses = []
    for step in range(3):
        _, loss = train_step(state, batch, ReplaySeeds(_loss_seeds(want["key"], step)))
        losses.append(loss.item())
    assert state.step == 3 and state.optimizer.count == 3
    # each step starts from parameters that already differ in the last bits
    np.testing.assert_allclose(losses, want["losses"], rtol=2e-4)
    assert losses[0] == pytest.approx(want["total"], rel=2e-5)
    for name in ("backbone.stem_conv.weight", "field_type_head.category_net.out.bias"):  # SGD
        np.testing.assert_allclose(named[name].detach().numpy(), want["params"][name].numpy(),
                                   atol=2e-4, rtol=1e-3, err_msg=name)
    # AdamW divides by sqrt(nu): an element whose gradient is at the noise
    # level moves by ±lr whatever its size, so a few elements may differ by
    # a whole step (3 steps of 2e-3); all but 1% agree closely
    name = "bert_model.layer.0.attention.query.weight"
    diff = np.abs(named[name].detach().numpy() - want["params"][name].numpy())
    assert diff.max() <= 3 * 2e-3 * 1.1 and np.mean(diff > 2e-4) < 0.01


def test_train_state_deepcopy_steps_alike(train_pair):
    """A deep copy of the train state carries the whole optimizer (schedules,
    step count, moments) and takes the same step as the original."""
    import copy

    from vibertgrid_tpu_torch.train.seeds import SeedStream

    _, state, train_step, batch = train_pair
    twin = copy.deepcopy(state)
    assert twin.model is not state.model and twin.optimizer.count == state.optimizer.count
    assert twin.optimizer.schedules.keys() == state.optimizer.schedules.keys()
    _, a = train_step(state, batch, SeedStream(3))
    _, b = train_step(twin, batch, SeedStream(3))
    assert a.item() == b.item() and twin.optimizer.count == state.optimizer.count
    for (name, p), q in zip(state.model.named_parameters(), twin.model.parameters()):
        assert torch.equal(p, q), name


def test_eval_and_inference_steps(train_pair):
    from vibertgrid_tpu_torch.train.state import make_eval_step, make_inference_step

    _, state, _, batch = train_pair
    snapshot = {k: v.clone() for k, v in state.model.state_dict().items()}
    out = make_eval_step()(state, batch)
    assert torch.isfinite(out.total_loss) and not out.total_loss.requires_grad
    pred = make_inference_step()(state, batch)
    torch.testing.assert_close(pred, out.pred_label)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, snapshot[k]), k  # eval leaves the statistics alone

    # the uint8 wire: normalised on the way in, the padding back to 0
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    rng = np.random.default_rng(30)
    raw = torch.from_numpy(rng.integers(0, 256, (2, 64, 96, 3), dtype=np.uint8))
    sizes = torch.tensor([[64, 96], [40, 70]])
    want_images = (raw.float() / 255.0 - torch.tensor(mean)) / torch.tensor(std)
    want_images[1, 40:] = 0
    want_images[1, :, 70:] = 0
    got = make_eval_step((mean, std))(state, dataclasses.replace(batch, images=raw), sizes)
    ref = make_eval_step()(state, dataclasses.replace(batch, images=want_images))
    torch.testing.assert_close(got.pred_label, ref.pred_label)
    torch.testing.assert_close(got.total_loss, ref.total_loss)


# ---------------------------------------------------------------- profiling


def test_profiling_trace_writes_a_trace_file(tmp_path):
    import json

    from vibertgrid_tpu_torch.utils.profiling import trace

    x, w = torch.randn(8, 16), torch.randn(32, 16)
    with trace(str(tmp_path / "trace")) as logdir:
        torch.nn.functional.linear(x, w)
    files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any("linear" in e.get("name", "") or "addmm" in e.get("name", "") for e in events)

