"""The port's modules against the JAX package's, on one set of weights.

Each test initialises the JAX module, perturbs every parameter (so biases
and norm parameters are not the trivial 0/1 of a fresh init) and randomises
the BatchNorm running statistics (so eval BN is not the identity), converts
the variables with ``vibertgrid_tpu_torch.convert.from_flax`` and feeds the
same numpy inputs to both. The JAX side runs its Pallas kernels in
interpret mode, as the JAX package's own tests do; the port runs on the
CPU, so its kernel wrappers take their plain twins. Comparisons are fp32.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vibertgrid_tpu_torch.convert import from_flax

RNG_SEED = 23


def _perturb(variables, seed=RNG_SEED):
    """Every param + N(0, 0.02²); running mean N(0, 0.1²), var U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def params(tree):
        return {
            k: params(v) if isinstance(v, dict)
            else np.asarray(v, np.float32) + rng.normal(0, 0.02, np.shape(v)).astype(np.float32)
            for k, v in tree.items()
        }

    def stats(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = stats(v)
            elif k == "mean":
                out[k] = rng.normal(0, 0.1, np.shape(v)).astype(np.float32)
            else:
                out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
        return out

    v = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    out = {"params": params(dict(v["params"]))}
    if "batch_stats" in v:
        out["batch_stats"] = stats(dict(v["batch_stats"]))
    return out


def _load(module, variables):
    module.load_state_dict(from_flax(variables), strict=True)
    return module.eval()


def _tokens(b, t, vocab, pad_id, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab - 1, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    mask[0, t // 2:] = 0  # padded keys in the first row
    ids[0, t // 2:] = pad_id
    return ids, mask


@pytest.mark.parametrize("flavor", ["bert", "roberta"])
def test_text_encoder_matches_jax(flavor):
    from vibertgrid_tpu.models.bert import TextEncoder as JaxEncoder
    from vibertgrid_tpu.models.bert import TextEncoderConfig as JaxCfg
    from vibertgrid_tpu_torch.models.bert import TextEncoder, TextEncoderConfig

    jcfg = dataclasses.replace(JaxCfg.tiny(flavor), attention_impl="flash", ffn_impl="fused")
    ids, mask = _tokens(2, 130, jcfg.vocab_size, jcfg.pad_token_id, seed=3)
    jm = JaxEncoder(jcfg)
    variables = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask)))
    want = np.asarray(jm.apply(variables, jnp.asarray(ids), jnp.asarray(mask)))

    tm = _load(TextEncoder(TextEncoderConfig.tiny(flavor), device="cpu"), variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    # fp32 through 2 layers of LayerNorm-ed activations: the two sides sum
    # in different orders, which moves the last bits (~1e-6).
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("backbone", ["resnet_18_fpn", "resnet_18_D_fpn"])
def test_resnet_fpn_matches_jax(backbone):
    from vibertgrid_tpu.models.resnet_fpn import BACKBONE_REGISTRY as JREG
    from vibertgrid_tpu.models.resnet_fpn import ResNetFPN as JaxFPN
    from vibertgrid_tpu_torch.models.resnet_fpn import BACKBONE_REGISTRY, ResNetFPN

    rng = np.random.default_rng(5)
    images = rng.standard_normal((2, 64, 96, 3)).astype(np.float32)
    grid = rng.standard_normal((2, 8, 12, 16)).astype(np.float32)
    jm = JaxFPN(**JREG[backbone])
    variables = _perturb(jm.init(jax.random.PRNGKey(1), jnp.asarray(images), jnp.asarray(grid)))
    want = np.asarray(jm.apply(variables, jnp.asarray(images), jnp.asarray(grid)))

    tm = _load(
        ResNetFPN(grid_channels=16, device="cpu", **BACKBONE_REGISTRY[backbone]), variables
    )
    with torch.no_grad():
        got = tm(torch.from_numpy(images), torch.from_numpy(grid)).numpy()
    assert got.shape == want.shape == (2, 16, 24, 256)
    # fp32 convolutions over ~20 layers, summed in another order: 1e-4
    # relative to activations of order 1-10.
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_model_config_from_yaml_matches_jax():
    import yaml

    from vibertgrid_tpu.models.vibertgrid import ModelConfig as JaxConfig
    from vibertgrid_tpu_torch.models.vibertgrid import ModelConfig

    with open("vibertgrid_tpu/configs/sroie_example.yaml") as f:
        hyp = yaml.safe_load(f)
    hyp = dict(hyp, amp=True)
    j, t = JaxConfig.from_yaml_dict(hyp), ModelConfig.from_yaml_dict(hyp)
    for field in dataclasses.fields(t):
        if field.name == "compute_dtype":
            assert t.compute_dtype == torch.bfloat16 and j.compute_dtype == jnp.bfloat16
        else:
            assert getattr(t, field.name) == getattr(j, field.name), field.name
    jt, tt = j.resolved_text_config(), t.resolved_text_config()
    assert dataclasses.asdict(jt) == dataclasses.asdict(tt)


def _full_forward_pair(grid_mode):
    from __graft_entry__ import _make_batch
    from vibertgrid_tpu.models.vibertgrid import ModelConfig as JaxConfig
    from vibertgrid_tpu.models.vibertgrid import ViBERTgridNet as JaxNet
    from vibertgrid_tpu_torch.entry import make_batch
    from vibertgrid_tpu_torch.models.vibertgrid import ModelConfig, ViBERTgridNet

    kw = dict(num_classes=5, bert_version="tiny-bert-test", backbone="resnet_18_fpn",
              classifier_mode="simp", grid_mode=grid_mode)
    jnet = JaxNet(JaxConfig(attention_impl="flash", ffn_impl="fused", **kw))
    shape = dict(b=2, h=64, w=96, t=510, s=8, vocab=512, seed=7)
    jbatch = _make_batch(**shape)
    variables = _perturb(
        jnet.init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
            # with the losses, so that the variables hold the auxiliary
            # segmentation head, which the port's model always has
            jbatch, train=False, compute_loss=True, key=jax.random.PRNGKey(2),
        )
    )
    # Eval BN with random statistics does not normalise, so the logits of a
    # random network are in the hundreds and the softmax saturates to 0/1,
    # which would hide any error. Shrinking the last layer keeps them O(1).
    out = variables["params"]["field_type_head"]["category_net"]["out"]
    out["kernel"] = out["kernel"] * 0.01
    want = np.asarray(
        jnet.apply(variables, jbatch, train=False, compute_loss=False,
                   key=jax.random.PRNGKey(0)).pred_label
    )
    tnet = _load(ViBERTgridNet(ModelConfig(**kw), device="cpu"), variables)
    with torch.no_grad():
        got = tnet(make_batch(**shape, device="cpu")).pred_label.numpy()
    return got, want


@pytest.mark.parametrize("grid_mode", ["mean", "first"])
def test_full_inference_forward_matches_jax(grid_mode):
    got, want = _full_forward_pair(grid_mode)
    assert got.shape == want.shape == (2, 8, 5)
    # fp32 end to end; probabilities after ~30 layers summed in other
    # orders agree to ~1e-6, far inside the 1e-4 budget.
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
