"""The fused attention epilogue and the encoder's kernel gates against the JAX
package's (CPU, fp32). (``fused_ffn``'s rematerialising backward is held in
``tests/test_torch_train_ops.py`` beside the saved-residual one.)

``fused_proj_ln`` on CPU tensors runs its plain twin, ``proj_ln_reference``;
the JAX ``fused_proj_ln`` runs its Pallas kernel in interpret mode, as the
JAX package's own tests run it. The port keeps W in ``nn.Linear`` layout
``[out, in]``, the JAX package ``[in, out]``.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vibertgrid_tpu_torch.convert import from_flax

EPS = 1e-12


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _case(n, d, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    ctx, res, dy = f(n, d), f(n, d), f(n, d)
    w = f(d, d) * np.float32(d ** -0.5)  # JAX layout [in, out]
    return ctx, res, w, 0.1 * f(d), 1 + 0.1 * f(d), 0.1 * f(d), dy


def _jax_out(ctx, res, w, b, g, bt, seed, rate):
    from vibertgrid_tpu.ops.fused_ffn import fused_proj_ln

    return fused_proj_ln(*(jnp.asarray(a) for a in (ctx, res, w, b, g, bt)), jnp.int32(seed),
                         EPS, rate, True)


@pytest.mark.parametrize("n", [24, 13])  # 13: no multiple of any row tile
@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_proj_ln_forward_matches_jax(n, rate):
    from vibertgrid_tpu.ops.fused_ffn import proj_ln_reference as jax_reference
    from vibertgrid_tpu_torch.ops.fused_ffn import fused_proj_ln, proj_ln_reference

    ctx, res, w, b, g, bt, _ = _case(n, 64, seed=40)
    seed = 77
    want = np.asarray(_jax_out(ctx, res, w, b, g, bt, seed, rate))
    want_plain = np.asarray(jax_reference(
        *(jnp.asarray(a) for a in (ctx, res, w, b, g, bt)), jnp.int32(seed), EPS, rate))
    args = [_t(a) for a in (ctx, res, w.T, b, g, bt)]
    twin = proj_ln_reference(*args, EPS, seed, rate).numpy()
    with torch.no_grad():
        got = fused_proj_ln(*args, EPS, rate=rate, seed=seed).numpy()
    np.testing.assert_array_equal(got, twin)  # a CPU tensor takes the twin
    # fp32 on both sides; sums of 64 products in another order
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, want_plain, atol=1e-5, rtol=1e-5)


def test_proj_ln_drops_the_positions_jax_drops():
    """A projection of all ones (W = 0, b = 1) on a zero residual leaves
    1/(1−rate) where kept and 0 where dropped; the LayerNorm (scale 1, bias 0)
    maps those to a positive and a negative value, so the sign shows the set."""
    from vibertgrid_tpu_torch.ops.dropout import hash_dropout
    from vibertgrid_tpu_torch.ops.fused_ffn import fused_proj_ln

    n, d, seed, rate = 21, 64, 77, 0.4
    zeros, ones = np.zeros((n, d), np.float32), np.ones(d, np.float32)
    case = (zeros, zeros, np.zeros((d, d), np.float32), ones, ones, np.zeros(d, np.float32))
    want = np.asarray(_jax_out(*case, seed, rate)) > 0
    got = fused_proj_ln(*(_t(a) for a in case), EPS, rate=rate, seed=seed).numpy() > 0
    assert 0.5 < got.mean() < 0.7
    np.testing.assert_array_equal(got, want)
    # and they are the positions the unfused epilogue's dropout drops
    np.testing.assert_array_equal(got, hash_dropout(torch.ones(n, d), seed, rate).numpy() > 0)


@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_proj_ln_gradients_match_jax(rate):
    from vibertgrid_tpu_torch.ops.fused_ffn import fused_proj_ln

    ctx, res, w, b, g, bt, dy = _case(16, 64, seed=41)
    seed = 5
    fn = lambda *a: jnp.sum(_jax_out(*a, seed, rate) * jnp.asarray(dy))
    want = jax.grad(fn, argnums=tuple(range(6)))(*(jnp.asarray(a) for a in (ctx, res, w, b, g, bt)))
    leaves = [_t(a).requires_grad_() for a in (ctx, res, w.T, b, g, bt)]
    got = torch.autograd.grad(fused_proj_ln(*leaves, EPS, rate=rate, seed=seed), leaves, _t(dy))
    for name, a, wnt in zip(("dctx", "dres", "dw", "db", "dg", "dbt"), got, want):
        wnt = np.asarray(wnt).T if name == "dw" else np.asarray(wnt)
        # fp32 both sides, sums of up to 64 products in another order
        np.testing.assert_allclose(a.numpy(), wnt, atol=2e-5, rtol=1e-5, err_msg=name)


def _encoder_inputs():
    rng = np.random.default_rng(43)
    ids = rng.integers(3, 500, (2, 40)).astype(np.int32)
    mask = np.ones((2, 40), np.int32)
    mask[:, 30:] = 0
    return ids, mask


@pytest.mark.parametrize("ffn_impl", ["fused", "fused-saved"])
def test_encoder_fused_epilogue_matches_jax(ffn_impl):
    """The JAX encoder with its fused epilogue and FFN kernels interpreted,
    evaluation forward and the gradient of a weighted sum, against the port's
    with the same gates from the same variables."""
    from tests.test_torch_model import _perturb
    from vibertgrid_tpu.models.bert import TextEncoder as JaxEncoder
    from vibertgrid_tpu.models.bert import TextEncoderConfig as JaxCfg
    from vibertgrid_tpu_torch.models.bert import TextEncoder, TextEncoderConfig

    gates = dict(ffn_impl=ffn_impl, attn_epilogue="fused")
    ids, mask = _encoder_inputs()
    jm = JaxEncoder(dataclasses.replace(JaxCfg.tiny(), attention_impl="flash", **gates))
    jids, jmask = jnp.asarray(ids), jnp.asarray(mask)
    variables = _perturb(jm.init(jax.random.PRNGKey(0), jids, jmask))
    weights = np.random.default_rng(44).standard_normal((2, 40, 64)).astype(np.float32)
    loss = lambda p: jnp.sum(jm.apply({"params": p}, jids, jmask) * jnp.asarray(weights))
    want = np.asarray(jm.apply(variables, jids, jmask))
    want_grads = from_flax({"params": jax.grad(loss)(variables["params"])})

    tm = TextEncoder(dataclasses.replace(TextEncoderConfig.tiny(), **gates), device="cpu")
    tm.load_state_dict(from_flax(variables), strict=True)
    out = tm(_t(ids), _t(mask))
    # fp32 through 2 layers of LayerNorm-ed activations summed in other orders
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-4, rtol=0)
    (out * _t(weights)).sum().backward()
    for name in ("layer.0.attention.out.weight", "layer.0.attention_ln.bias",
                 "layer.1.attention.query.weight", "layer.1.output.weight",
                 "word_embeddings.weight"):
        ref = want_grads[name].numpy()
        np.testing.assert_allclose(tm.get_parameter(name).grad.numpy(), ref,
                                   atol=1e-4 * np.abs(ref).max(), rtol=1e-3, err_msg=name)


def test_fused_and_unfused_epilogues_agree_under_dropout():
    """One state dict and one seed list through both epilogues of the port,
    dropout on: the same dropped positions, so the outputs agree to summation
    order (fp32); and both draw the same number of seeds."""
    from vibertgrid_tpu_torch.models.bert import TextEncoder, TextEncoderConfig
    from vibertgrid_tpu_torch.train.seeds import ReplaySeeds

    ids, mask = _encoder_inputs()
    plain = TextEncoder(TextEncoderConfig.tiny(), device="cpu")
    fused = TextEncoder(dataclasses.replace(TextEncoderConfig.tiny(), attn_epilogue="fused"),
                        device="cpu")
    fused.load_state_dict(plain.state_dict(), strict=True)
    seeds = [11, 12, 13, 14, 15, 16, 17]  # embedding + 2 x (attention, epilogue, FFN)
    outs = []
    for model in (plain, fused):
        stream = ReplaySeeds(seeds)
        with torch.no_grad():
            outs.append(model(_t(ids), _t(mask), deterministic=False, seeds=stream).numpy())
        with pytest.raises(IndexError):
            stream.next()
    with torch.no_grad():
        no_drop = plain(_t(ids), _t(mask)).numpy()
    assert np.abs(outs[0] - no_drop).max() > 0.1  # dropout did something
    # a position dropped on one side only would differ by the size of an activation
    np.testing.assert_allclose(outs[1], outs[0], atol=2e-5, rtol=0)
