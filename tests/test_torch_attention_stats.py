"""The row statistic the attention forward hands its backward, on the CPU.

The forward kernel writes ``lse = max + log(sum)`` of each row's biased
scores when a gradient will be taken, and the backward kernel rebuilds the
probabilities as ``exp(s − lse)``. These tests pin that arithmetic on the
plain versions (which the CUDA kernels are then held to on the card by
chip_smoke.py): ``lse`` itself, the two ways to the softmax backward's row
term ``delta``, :func:`attention_backward_from_stats` against
:func:`attention_backward_reference` and against the JAX package's Pallas VJP
run with ``interpret=True``, and what the autograd Function saves.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vibertgrid_tpu_torch.ops import flash_attention as fa

SHAPES = [(2, 130, 4, 16), (1, 70, 3, 8), (2, 64, 2, 32)]  # ragged and tile-sized T
RATES = [0.0, 0.1]
SEED = 77


def _t(x, dtype=None):
    out = torch.from_numpy(np.array(x, dtype=np.float32))
    return out if dtype is None else out.to(dtype)


def _np(x):
    return x.detach().float().numpy()


def _case(b, t, nh, dh, seed):
    """q, k, v, bias, d_out from a seed; ragged key masks: the first row
    loses its last third, the last row a single key."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, t, nh * dh)).astype(np.float32) for _ in range(4))
    bias = np.zeros((b, t), np.float32)
    bias[0, t - t // 3:] = -1e9
    bias[-1, t - 1] = -1e9
    return q, k, v, bias, do


def _biased_scores(q, k, bias, nh, scale):
    b, t, m = q.shape
    heads = lambda x: x.reshape(b, t, nh, m // nh).transpose(0, 2, 1, 3).astype(np.float64)
    return np.einsum("bhqd,bhkd->bhqk", heads(q), heads(k)) * scale + bias[:, None, None, :]


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("shape", SHAPES)
def test_lse_is_logsumexp_of_biased_scores(shape, rate):
    b, t, nh, dh = shape
    q, k, v, bias, _ = _case(*shape, seed=1)
    scale = dh ** -0.5
    out, lse = fa.attention_reference(_t(q), _t(k), _t(v), _t(bias), scale, nh, SEED, rate,
                                      return_lse=True)
    s = _biased_scores(q, k, bias, nh, scale)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    assert lse.shape == (b, nh, t) and lse.dtype == torch.float32
    # fp32 against float64: scores of order 1-10
    np.testing.assert_allclose(_np(lse), want, atol=1e-6 * max(1.0, np.abs(want).max()), rtol=0)
    # asking for lse changes nothing about the output; dropout does not enter lse
    plain = fa.attention_reference(_t(q), _t(k), _t(v), _t(bias), scale, nh, SEED, rate)
    np.testing.assert_array_equal(_np(out), _np(plain))
    lse0 = fa.attention_reference(_t(q), _t(k), _t(v), _t(bias), scale, nh, return_lse=True)[1]
    np.testing.assert_array_equal(_np(lse), _np(lse0))


def _deltas(q, k, v, bias, do, nh, scale, rate, dtype):
    """``rowsum(dp ⊙ p)`` with the keep mask, and ``rowsum(do ⊙ out)``."""
    tq, tk, tv, tdo = (_t(a, dtype) for a in (q, k, v, do))
    b, t, _ = tq.shape
    out = fa.attention_reference(tq, tk, tv, _t(bias), scale, nh, SEED, rate)
    p = fa._probabilities(tq, tk, _t(bias), scale, nh)
    doh = fa._heads(tdo, nh)
    dp = torch.matmul(doh, fa._heads(tv, nh).transpose(-1, -2))
    if rate > 0.0:
        dp = dp * fa.attention_dropout_mask(b, nh, t, SEED, rate, "cpu")
    return (dp * p).sum(-1), (doh * fa._heads(out, nh)).sum(-1)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("shape", SHAPES)
def test_delta_from_output_equals_delta_from_probabilities_fp32(shape, rate):
    b, t, nh, dh = shape
    q, k, v, bias, do = _case(*shape, seed=2)
    from_p, from_out = _deltas(q, k, v, bias, do, nh, dh ** -0.5, rate, torch.float32)
    # out = (keep ⊙ p)·v, so the two are one sum in another order (fp32)
    np.testing.assert_allclose(_np(from_out), _np(from_p), atol=1e-5, rtol=0)


def test_delta_from_bf16_output_is_too_coarse_for_d_bias():
    """Why the backward kernel sums ``dp ⊙ p`` and does not take the usual
    ``rowsum(do ⊙ out)``: in bf16 ``out`` and the forward's probabilities are
    rounded, delta moves by ~1e-3, and d_bias, which sums ds over every query
    and head, leaves the tolerance the kernel is held to on the card."""
    b, t, nh, dh, rate = 1, 256, 8, 32, 0.1
    q, k, v, bias, do = _case(b, t, nh, dh, seed=3)
    scale = dh ** -0.5
    bf = lambda a: _t(a, torch.bfloat16)
    from_p, from_out = _deltas(q, k, v, bias, do, nh, scale, rate, torch.bfloat16)
    assert (from_out - from_p).abs().max().item() > 1e-3
    out, lse = fa.attention_reference(bf(q), bf(k), bf(v), _t(bias), scale, nh, SEED, rate,
                                      return_lse=True)
    want = fa.attention_backward_reference(bf(q), bf(k), bf(v), _t(bias), bf(do), scale, nh,
                                           SEED, rate)[3]
    limit = 5e-5 + 1e-4 * want.abs()  # chip_smoke.ATTN_BIAS_TOL
    for given, holds in ((None, True), (out, False)):
        got = fa.attention_backward_from_stats(bf(q), bf(k), bf(v), _t(bias), bf(do), given, lse,
                                               scale, nh, SEED, rate)[3]
        assert bool(((got - want).abs() <= limit).all()) is holds


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_from_stats_matches_reference_and_jax_fp32(shape, rate):
    from vibertgrid_tpu.ops.flash_attention import flash_attention as jax_attention

    b, t, nh, dh = shape
    q, k, v, bias, do = _case(*shape, seed=4)
    scale = dh ** -0.5
    tq, tk, tv, tb, tdo = (_t(a) for a in (q, k, v, bias, do))
    out, lse = fa.attention_reference(tq, tk, tv, tb, scale, nh, SEED, rate, return_lse=True)
    want = fa.attention_backward_reference(tq, tk, tv, tb, tdo, scale, nh, SEED, rate)
    fn = lambda q, k, v, bias: jax_attention(q, k, v, bias, jnp.int32(SEED), scale, nh, rate, True)
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v, bias)))
    want_jax = vjp(jnp.asarray(do))
    # fp32 on every side, sums in another order: 1e-5 on values of order 1;
    # with `out` delta is rowsum(do ⊙ out), the same number in fp32
    for given in (None, out):
        got = fa.attention_backward_from_stats(tq, tk, tv, tb, tdo, given, lse, scale, nh,
                                               SEED, rate)
        for name, g, w, wj in zip(("dq", "dk", "dv", "d_bias"), got, want, want_jax):
            np.testing.assert_allclose(_np(g), _np(w), atol=1e-5, rtol=1e-5, err_msg=name)
            np.testing.assert_allclose(_np(g), np.asarray(wj), atol=1e-5, rtol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("rate", RATES)
def test_backward_from_stats_matches_jax_bf16(rate):
    from vibertgrid_tpu.ops.flash_attention import flash_attention as jax_attention

    b, t, nh, dh, seed = 2, 96, 2, 32, 5
    q, k, v, bias, do = _case(b, t, nh, dh, seed=6)
    scale = dh ** -0.5
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    fn = lambda q, k, v, bias: jax_attention(q, k, v, bias, jnp.int32(seed), scale, nh, rate, True)
    _, vjp = jax.vjp(fn, bf(q), bf(k), bf(v), jnp.asarray(bias))
    want = vjp(bf(do))
    tb = lambda a: _t(a, torch.bfloat16)
    lse = fa.attention_reference(tb(q), tb(k), tb(v), _t(bias), scale, nh, seed, rate,
                                 return_lse=True)[1]
    got = fa.attention_backward_from_stats(tb(q), tb(k), tb(v), _t(bias), tb(do), None, lse,
                                           scale, nh, seed, rate)
    assert got[0].dtype == torch.bfloat16 and got[3].dtype == torch.float32
    # the limits of test_attention_backward_matches_jax_bf16: bf16 results of
    # fp32 sums in another order, an ulp here and there
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_np(g), f32(w), atol=4e-3, rtol=8e-3, err_msg=name)
    np.testing.assert_allclose(_np(got[3]), np.asarray(want[3]), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("rate", RATES)
def test_function_saves_lse_only_when_a_gradient_is_recorded(rate, monkeypatch):
    b, t, nh, dh = 2, 70, 3, 8
    q, k, v, bias, do = _case(b, t, nh, dh, seed=7)
    scale = dh ** -0.5
    asked = []
    plain = fa.attention_reference

    def spy(*args, **kwargs):
        asked.append(kwargs.get("return_lse", False))
        return plain(*args, **kwargs)

    monkeypatch.setattr(fa, "attention_reference", spy)
    tensors = [_t(a) for a in (q, k, v, bias)]
    with torch.no_grad():
        quiet = fa.flash_attention(*tensors, scale, nh, rate=rate, seed=SEED)
    also_quiet = fa.flash_attention(*tensors, scale, nh, rate=rate, seed=SEED)
    assert asked == [False, False]
    assert quiet.grad_fn is None and also_quiet.grad_fn is None

    leaves = [x.clone().requires_grad_() for x in tensors]
    out = fa.flash_attention(*leaves, scale, nh, rate=rate, seed=SEED)
    assert asked == [False, False, True]
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5
    want_out, want_lse = plain(*tensors, scale, nh, SEED, rate, return_lse=True)
    np.testing.assert_array_equal(_np(saved[4]), _np(want_lse))
    # the three forwards agree bit for bit, and the gradient is the reference's
    for got in (quiet, also_quiet, out):
        np.testing.assert_array_equal(_np(got), _np(want_out))
    grads = torch.autograd.grad(out, leaves, _t(do))
    want = fa.attention_backward_reference(*tensors, _t(do), scale, nh, SEED, rate)
    for g, w in zip(grads, want):
        np.testing.assert_array_equal(_np(g), _np(w))
