"""The full-head and CRF-head models as a whole against the JAX package's, on
the encoder with the fused attention epilogue: inference forward, the losses
and gradients of one training forward, and one whole train step, from one set
of weights (CPU, fp32, tiny configuration).

The JAX side runs its Pallas kernels in interpret mode (``attention_impl=
"flash"``, ``ffn_impl="fused-saved"``, ``attn_epilogue="fused"``); the port
runs on the CPU, so its kernel wrappers take their plain twins.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.test_torch_train import MODEL_KW, SHAPE, STEP_KEY, TRAIN_HYP
from vibertgrid_tpu_torch.convert import from_flax

C = MODEL_KW["num_classes"]


def _loss_seeds(key, step, mode):
    """The loss seeds of one JAX train step in the order the port draws them:
    the two-stage segmentation head uses the first C of C + 1 keys, the full
    head C keys, the CRF head none."""
    from vibertgrid_tpu.ops.dropout import derive_seed

    k_loss, _ = jax.random.split(jax.random.fold_in(key, step))
    k_seg, k_head = jax.random.split(k_loss)
    keys = list(jax.random.split(k_seg, C + 1)[:C])
    if mode == "full":
        keys += list(jax.random.split(k_head, C))
    return [int(derive_seed(k)) for k in keys]


@pytest.fixture(scope="module", params=["full", "crf"])
def family_pair(request):
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

    mode = request.param
    # dropout off: flax's per-site keys cannot be replayed without JAX
    text = dict(hidden_dropout=0.0, attention_dropout=0.0, attn_epilogue="fused")
    kw = dict(MODEL_KW, classifier_mode=mode)
    jnet = JaxNet(JaxConfig(attention_impl="flash", ffn_impl="fused-saved",
                            text_config=dataclasses.replace(JaxTextConfig.tiny("bert"), **text),
                            **kw))
    jbatch = _make_batch(**SHAPE)
    # initialised with the loss and in training mode, so that the two-stage
    # segmentation head and the CRF's transitions exist
    variables = _perturb(jnet.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jbatch, train=True, compute_loss=True, key=jax.random.PRNGKey(2)))
    if mode == "crf":  # the perturbation moved the pins
        trans = variables["params"]["field_type_head"]["transitions"]
        trans[C, :] = -1e4
        trans[:, C + 1] = -1e4
    key = jax.random.PRNGKey(STEP_KEY)

    def first_step(params):
        k_loss, k_drop = jax.random.split(jax.random.fold_in(key, 0))
        out, mutated = jnet.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jbatch, train=True,
            compute_loss=True, key=k_loss, rngs={"dropout": k_drop}, mutable=["batch_stats"])
        return out.total_loss, (out.loss_c, out.loss_aux)

    (total, (loss_c, loss_aux)), grads = jax.jit(
        jax.value_and_grad(first_step, has_aux=True))(variables["params"])
    pred = jnet.apply(variables, jbatch, train=False, compute_loss=False).pred_label
    tx = jax_make(TRAIN_HYP, num_epochs=2, niter_per_ep=100)
    jstate = JaxState(params=variables["params"], batch_stats=variables["batch_stats"],
                      opt_state=tx.init(variables["params"]), step=jnp.zeros((), jnp.int32))
    jstate, step_loss = jax_make_step(jnet, tx)(jstate, jbatch, key)

    cfg = ModelConfig(text_config=dataclasses.replace(TextEncoderConfig.tiny("bert"), **text), **kw)
    state, train_step, batch = train_entry("cpu", config=cfg, hyp=TRAIN_HYP, shape=SHAPE)
    state.model.load_state_dict(from_flax(variables), strict=True)
    want = dict(total=float(total), loss_c=float(loss_c), loss_aux=float(loss_aux),
                grads=from_flax({"params": grads}), pred=np.asarray(pred),
                step_loss=float(step_loss), params=from_flax({"params": jstate.params}), key=key)
    return mode, want, state, train_step, batch


def test_family_inference_forward_matches_jax(family_pair):
    mode, want, state, _, batch = family_pair
    with torch.no_grad():
        pred = state.model(batch).pred_label.numpy()
    if mode == "crf":
        assert pred.shape == (2, 8) and pred.max() < C
        np.testing.assert_array_equal(pred, want["pred"])
    else:
        assert pred.shape == (2, 8, C)
        # fp32 end to end, ~40 layers summed in other orders
        np.testing.assert_allclose(pred, want["pred"], atol=1e-4, rtol=0)


def test_family_train_step_matches_jax(family_pair):
    from vibertgrid_tpu_torch.train.seeds import ReplaySeeds

    mode, want, state, train_step, batch = family_pair
    model = state.model
    before = {k: v.clone() for k, v in model.state_dict().items()}
    seeds = ReplaySeeds(_loss_seeds(want["key"], 0, mode))
    out = model(batch, train=True, compute_loss=True, seeds=seeds)
    with pytest.raises(IndexError):  # every seed given was drawn
        seeds.next()
    # fp32 through ~40 layers on both sides
    np.testing.assert_allclose(out.loss_c.item(), want["loss_c"], rtol=2e-5)
    np.testing.assert_allclose(out.loss_aux.item(), want["loss_aux"], rtol=2e-5)
    np.testing.assert_allclose(out.total_loss.item(), want["total"], rtol=2e-5)
    out.total_loss.backward()
    named = dict(model.named_parameters())
    assert not [n for n, p in named.items() if p.grad is None]
    head = ("field_type_head.transitions" if mode == "crf"
            else "field_type_head.pos_neg_net.out.weight")
    for name in ("bert_model.layer.0.attention.out.weight", "bert_model.layer.1.attention_ln.bias",
                 "bert_model.layer.1.intermediate.weight", "backbone.stem_conv.weight",
                 "backbone.early_fusion.weight", "late_fusion.fuse.weight",
                 "semantic_segmentation_head.binary_bank.weight",
                 "field_type_head.category_net.out.weight", head):
        got, ref = named[name].grad.numpy(), want["grads"][name].numpy()
        # see tests/test_torch_train.py: the backward amplifies the forward's
        # last-bit differences to ~2e-3 of the gradient's largest entry. (The
        # late fusion is held through its last layer: in the full model one
        # channel of roi_embedding's first conv has a ReLU input within
        # rounding of zero, which flips 0.4% of that gradient's entries to 3x
        # this limit between the two sides.)
        np.testing.assert_allclose(got, ref, atol=5e-3 * np.abs(ref).max(), rtol=1e-3, err_msg=name)

    # one whole step from the initial state: the loss and the SGD-side update
    model.load_state_dict(before)
    _, loss = train_step(state, batch, ReplaySeeds(_loss_seeds(want["key"], 0, mode)))
    assert loss.item() == pytest.approx(want["step_loss"], rel=2e-5)
    for name in ("backbone.stem_conv.weight", "field_type_head.category_net.out.bias", head):
        np.testing.assert_allclose(named[name].detach().numpy(), want["params"][name].numpy(),
                                   atol=2e-4, rtol=1e-3, err_msg=name)
        assert not torch.equal(named[name].detach(), before[name]), name
    if mode == "crf":  # no gradient reaches the pins; only the weight decay moves them
        trans = named[head].detach()
        assert bool((trans[C] < -9990).all()) and bool((trans[:, C + 1] < -9990).all())
