"""The training-side operations of the port against the JAX package's, on
the same numpy inputs (CPU).

Dropout masks are compared bit for bit. The twins of the backward kernels
(attention backward, the saved-residual FFN and its backward, the scatter
backward) are compared with the VJPs of the JAX package's Pallas functions
run with ``interpret=True``, as its own kernel tests run them. On CPU tensors
the port's wrappers run these twins, so the tests pin the arithmetic the
CUDA kernels are then held to on the card (chip_smoke.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch


def _t(x, dtype=None):
    x = np.array(x)  # a writable copy
    out = torch.from_numpy(x.astype(np.float32) if x.dtype.kind == "f" else x)
    return out if dtype is None else out.to(dtype)


def _np(x):
    return x.detach().float().numpy()


SEEDS = [0, 1, -7, 2**31 - 1, -(2**31), 123456789]


# ---------------------------------------------------------------- dropout


@pytest.mark.parametrize("seed", SEEDS)
def test_splitmix32_is_bit_exact(seed):
    from vibertgrid_tpu.ops.dropout import splitmix32 as jax_splitmix
    from vibertgrid_tpu_torch.ops.dropout import splitmix32

    counters = np.concatenate([np.arange(4096), 2**32 - 1 - np.arange(64)]).astype(np.uint32)
    want = np.asarray(jax_splitmix(jnp.asarray(counters), jnp.int32(seed))).astype(np.int64)
    got = splitmix32(torch.from_numpy(counters.astype(np.int64)), seed).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("seed", SEEDS)
def test_hash_dropout_mask_is_bit_exact(seed, rate):
    from vibertgrid_tpu.ops.dropout import hash_dropout as jax_dropout
    from vibertgrid_tpu_torch.ops.dropout import hash_dropout, keep_mask

    x = np.random.default_rng(3).standard_normal((7, 33, 24)).astype(np.float32)
    want = np.asarray(jax_dropout(jnp.asarray(x), jnp.int32(seed), rate))
    got = hash_dropout(_t(x), seed, rate).numpy()
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_array_equal(keep_mask(x.shape, seed, rate, "cpu").numpy(), want != 0)
    # kept values: x · fp32(1/(1−rate)) on both sides
    np.testing.assert_array_equal(got, want)
    assert abs((got != 0).mean() - (1 - rate)) < 0.03


def test_hash_dropout_gradient_matches_jax():
    from vibertgrid_tpu.ops.dropout import hash_dropout as jax_dropout
    from vibertgrid_tpu_torch.ops.dropout import hash_dropout

    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 40)).astype(np.float32)
    g = rng.standard_normal((5, 40)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax_dropout(a, jnp.int32(11), 0.1), jnp.asarray(x))
    xt = _t(x).requires_grad_()
    (got,) = torch.autograd.grad(hash_dropout(xt, 11, 0.1), xt, _t(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))
    # rate 0 is the identity and needs no seed
    assert hash_dropout(xt, 0, 0.0) is xt


# -------------------------------------------------------------- attention


def _attention_case(b, t, nh, dh, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, t, nh * dh)).astype(np.float32) for _ in range(4))
    bias = np.zeros((b, t), np.float32)
    bias[0, t - t // 3:] = -1e9  # padded keys in the first row
    return q, k, v, bias, do


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_forward_and_backward_match_jax_fp32(rate):
    from vibertgrid_tpu.ops.flash_attention import flash_attention as jax_attention
    from vibertgrid_tpu_torch.ops.flash_attention import (
        attention_backward_reference,
        attention_reference,
        flash_attention,
    )

    b, t, nh, dh, seed = 2, 130, 4, 16, 77  # ragged T: the draw's row stride is 256, not 130
    q, k, v, bias, do = _attention_case(b, t, nh, dh, seed=5)
    scale = dh ** -0.5
    fn = lambda q, k, v, bias: jax_attention(q, k, v, bias, jnp.int32(seed), scale, nh, rate, True)
    want, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v, bias)))
    want_grads = vjp(jnp.asarray(do))

    got = attention_reference(_t(q), _t(k), _t(v), _t(bias), scale, nh, seed, rate)
    # fp32 on both sides, sums in another order: 1e-5 on values of order 1
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=0)
    grads = attention_backward_reference(
        _t(q), _t(k), _t(v), _t(bias), _t(do), scale, nh, seed, rate)
    for name, g, w in zip(("dq", "dk", "dv", "d_bias"), grads, want_grads):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-5, rtol=1e-5, err_msg=name)

    # the autograd Function takes the same twins on CPU tensors
    leaves = [_t(a).requires_grad_() for a in (q, k, v, bias)]
    out = flash_attention(*leaves, scale, nh, rate=rate, seed=seed)
    np.testing.assert_array_equal(_np(out), _np(got))
    for g, w in zip(torch.autograd.grad(out, leaves, _t(do)), grads):
        np.testing.assert_array_equal(_np(g), _np(w))


def test_attention_backward_matches_jax_bf16():
    from vibertgrid_tpu.ops.flash_attention import flash_attention as jax_attention
    from vibertgrid_tpu_torch.ops.flash_attention import (
        attention_backward_reference,
        attention_reference,
    )

    b, t, nh, dh, seed, rate = 2, 96, 2, 32, 5, 0.1
    q, k, v, bias, do = _attention_case(b, t, nh, dh, seed=6)
    scale = dh ** -0.5
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    fn = lambda q, k, v, bias: jax_attention(q, k, v, bias, jnp.int32(seed), scale, nh, rate, True)
    want, vjp = jax.vjp(fn, bf(q), bf(k), bf(v), jnp.asarray(bias))
    want_grads = vjp(bf(do))
    tb = lambda a: _t(a, torch.bfloat16)
    got = attention_reference(tb(q), tb(k), tb(v), _t(bias), scale, nh, seed, rate)
    grads = attention_backward_reference(
        tb(q), tb(k), tb(v), _t(bias), tb(do), scale, nh, seed, rate)
    assert got.dtype == torch.bfloat16 and grads[0].dtype == torch.bfloat16
    # bf16 results of fp32 sums in another order: an ulp here and there,
    # 4e-3 as the JAX package's own kernel tests allow for gradients
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    np.testing.assert_allclose(_np(got), f32(want), atol=4e-3, rtol=4e-3)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want_grads):
        np.testing.assert_allclose(_np(g), f32(w), atol=4e-3, rtol=8e-3, err_msg=name)
    np.testing.assert_allclose(_np(grads[3]), np.asarray(want_grads[3]), atol=1e-3, rtol=1e-3)


# -------------------------------------------------------------------- FFN


def _ffn_case(n, d, f, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w1 = (rng.standard_normal((d, f)) * d ** -0.5).astype(np.float32)   # JAX layout [in, out]
    w2 = (rng.standard_normal((f, d)) * f ** -0.5).astype(np.float32)
    b1 = (rng.standard_normal(f) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(d) * 0.1).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bt = (0.1 * rng.standard_normal(d)).astype(np.float32)
    dy = rng.standard_normal((n, d)).astype(np.float32)
    return x, w1, b1, w2, b2, g, bt, dy


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ffn_saved_forward_matches_jax(rate):
    from vibertgrid_tpu.ops.fused_ffn import _fused_ffn_saved_fwd
    from vibertgrid_tpu_torch.ops.fused_ffn import ffn_reference, ffn_saved_reference

    x, w1, b1, w2, b2, g, bt, _ = _ffn_case(50, 64, 128, seed=8)
    seed, eps = 31, 1e-12
    y, (_, h1, yhat, rsig, *_rest) = _fused_ffn_saved_fwd(
        *(jnp.asarray(a) for a in (x, w1, b1, w2, b2, g, bt)), jnp.int32(seed), eps, rate, True)
    args = (_t(x), _t(w1.T), _t(b1), _t(w2.T), _t(b2), _t(g), _t(bt), eps, seed, rate)
    got = ffn_saved_reference(*args)
    assert got[3].shape == (50, 1)
    # fp32 both sides; products of 64 and 128 terms summed in another order
    for name, a, w in zip(("y", "h1", "yhat", "rsig"), got, (y, h1, yhat, rsig)):
        np.testing.assert_allclose(_np(a), np.asarray(w), atol=1e-5, rtol=1e-5, err_msg=name)
    np.testing.assert_array_equal(_np(ffn_reference(*args)), _np(got[0]))


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_ffn_saved_gradients_match_jax(rate):
    from vibertgrid_tpu.ops.fused_ffn import fused_ffn_saved as jax_ffn
    from vibertgrid_tpu_torch.ops.fused_ffn import fused_ffn_saved

    x, w1, b1, w2, b2, g, bt, dy = _ffn_case(40, 64, 128, seed=9)
    seed, eps = 13, 1e-12
    fn = lambda *a: jnp.sum(jax_ffn(*a, jnp.int32(seed), eps, rate, True) * jnp.asarray(dy))
    want = jax.grad(fn, argnums=tuple(range(7)))(
        *(jnp.asarray(a) for a in (x, w1, b1, w2, b2, g, bt)))
    leaves = [_t(a).requires_grad_() for a in (x, w1.T, b1, w2.T, b2, g, bt)]
    out = fused_ffn_saved(*leaves, eps, rate=rate, seed=seed)
    got = torch.autograd.grad(out, leaves, _t(dy))
    names = ("dx", "dw1", "db1", "dw2", "db2", "dg", "dbt")
    for name, a, w in zip(names, got, want):
        w = np.asarray(w)
        if name in ("dw1", "dw2"):
            w = w.T  # the port keeps nn.Linear's [out, in]
        # fp32 both sides, sums of up to 128 products in another order
        np.testing.assert_allclose(_np(a), w, atol=2e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_ffn_gradients_match_jax(rate):
    """``fused_ffn`` on a gradient path: the residual-free forward with the
    rematerialising backward, against the JAX package's remat VJP."""
    from vibertgrid_tpu.ops.fused_ffn import fused_ffn as jax_ffn
    from vibertgrid_tpu_torch.ops.fused_ffn import fused_ffn

    x, w1, b1, w2, b2, g, bt, dy = _ffn_case(40, 64, 128, seed=10)
    seed, eps = 17, 1e-12
    fn = lambda *a: jnp.sum(jax_ffn(*a, jnp.int32(seed), eps, rate, True) * jnp.asarray(dy))
    want = jax.grad(fn, argnums=tuple(range(7)))(
        *(jnp.asarray(a) for a in (x, w1, b1, w2, b2, g, bt)))
    leaves = [_t(a).requires_grad_() for a in (x, w1.T, b1, w2.T, b2, g, bt)]
    out = fused_ffn(*leaves, eps, rate=rate, seed=seed)
    got = torch.autograd.grad(out, leaves, _t(dy))
    for name, a, w in zip(("dx", "dw1", "db1", "dw2", "db2", "dg", "dbt"), got, want):
        w = np.asarray(w).T if name in ("dw1", "dw2") else np.asarray(w)
        # fp32 both sides, sums of up to 128 products in another order
        np.testing.assert_allclose(_np(a), w, atol=2e-5, rtol=1e-5, err_msg=name)
    with torch.no_grad():  # and without a gradient path, the same values
        np.testing.assert_array_equal(_np(fused_ffn(*leaves, eps, rate=rate, seed=seed)),
                                      _np(out.detach()))


# ---------------------------------------------------------------- scatter


def test_scatter_backward_matches_jax():
    from vibertgrid_tpu.ops.pallas_scatter import bertgrid_scatter_pallas
    from vibertgrid_tpu_torch.ops.grid_scatter import grid_scatter, scatter_backward_reference

    h, w, d, stride = 8, 12, 16, 8
    boxes = np.array([
        [0, 0, 40, 32],      # overlapped by the next two
        [16, 8, 64, 40],
        [24, 16, 48, 32],    # masked: wins nothing
        [80, 40, 200, 100],  # runs past the right and bottom edges
        [8, 40, 24, 56],     # fully covered by the next: zero gradient
        [0, 32, 40, 64],
        [3, 5, 7, 7],        # inside one cell: covers no cell
    ], np.int32)
    mask = np.array([1, 1, 0, 1, 1, 1, 1], bool)
    rng = np.random.default_rng(12)
    emb = rng.standard_normal((2, len(boxes), d)).astype(np.float32)
    d_out = rng.standard_normal((2, h, w, d)).astype(np.float32)
    boxes2 = np.stack([boxes, boxes[::-1]])
    mask2 = np.stack([mask, mask[::-1]])

    def loss(e, bx, m, g):
        out = bertgrid_scatter_pallas(e, bx, m, height=h, width=w, stride=stride, interpret=True)
        return jnp.sum(out * g)

    want = np.stack([
        np.asarray(jax.grad(loss)(jnp.asarray(emb[i]), jnp.asarray(boxes2[i]),
                                  jnp.asarray(mask2[i]), jnp.asarray(d_out[i])))
        for i in range(2)
    ])
    got = scatter_backward_reference(_t(d_out), _t(boxes2), _t(mask2), stride=stride)
    # sums of at most 20 fp32 rows in another order
    np.testing.assert_allclose(_np(got), want, atol=1e-5, rtol=1e-6)
    assert not got[0, 2].any() and not got[0, 4].any() and not got[0, 6].any()
    assert got[0, 0].any() and got[0, 3].any()

    leaf = _t(emb).requires_grad_()
    out = grid_scatter(leaf, _t(boxes2), _t(mask2), height=h, width=w, stride=stride)
    (auto,) = torch.autograd.grad(out, leaf, _t(d_out))
    np.testing.assert_array_equal(_np(auto), _np(got))


# ------------------------------------------------------------------ norms


def _stats(variables):
    return {k: np.asarray(v) for k, v in variables["batch_stats"].items()}


def test_batch_norm_training_matches_jax():
    from vibertgrid_tpu.models.norm import BatchNorm as JaxBN
    from vibertgrid_tpu_torch.models.norm import BatchNorm

    rng = np.random.default_rng(14)
    x = (rng.standard_normal((3, 6, 5, 8)) * 2 + 1).astype(np.float32)  # NHWC
    g_out = rng.standard_normal(x.shape).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(8)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(8)).astype(np.float32)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(rng.standard_normal(8).astype(np.float32)),
                                 "var": jnp.asarray(rng.uniform(0.5, 2, 8).astype(np.float32))}}
    jm = JaxBN(use_running_average=False)

    def fn(xx, params):
        y, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx,
                          mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(g_out)), (y, mut)

    (_, (want_y, mut)), (want_dx, want_dp) = jax.value_and_grad(fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), variables["params"])

    tm = BatchNorm(8, device="cpu")
    with torch.no_grad():
        tm.weight.copy_(_t(scale)); tm.bias.copy_(_t(bias))
        tm.running_mean.copy_(_t(np.asarray(variables["batch_stats"]["mean"])))
        tm.running_var.copy_(_t(np.asarray(variables["batch_stats"]["var"])))
    xt = _t(x).permute(0, 3, 1, 2).requires_grad_()
    y = tm(xt, train=True)
    y.backward(_t(g_out).permute(0, 3, 1, 2))
    # fp32; the variance is E[(x−m)²] here and E[x²]−m² there: ~1e-6 apart
    np.testing.assert_allclose(_np(y.permute(0, 2, 3, 1)), np.asarray(want_y), atol=2e-5, rtol=0)
    np.testing.assert_allclose(_np(xt.grad.permute(0, 2, 3, 1)), np.asarray(want_dx), atol=2e-5, rtol=0)
    np.testing.assert_allclose(_np(tm.weight.grad), np.asarray(want_dp["scale"]), atol=2e-4, rtol=1e-5)
    np.testing.assert_allclose(_np(tm.bias.grad), np.asarray(want_dp["bias"]), atol=2e-5, rtol=1e-5)
    # the running variance takes the biased batch variance, weight 0.1
    new = _stats(mut)
    np.testing.assert_allclose(_np(tm.running_mean), new["mean"], atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(_np(tm.running_var), new["var"], atol=1e-6, rtol=1e-5)
    # eval mode reads the statistics and leaves them alone
    before = tm.running_var.clone()
    tm(xt.detach(), train=False)
    assert torch.equal(tm.running_var, before)


@pytest.mark.parametrize("n_valid", [4, 0])
def test_masked_batch_norm_training_matches_jax(n_valid):
    from vibertgrid_tpu.models.norm import MaskedBatchNorm as JaxMBN
    from vibertgrid_tpu_torch.models.norm import MaskedBatchNorm

    rng = np.random.default_rng(15)
    x = (rng.standard_normal((6, 7, 7, 8)) * 1.5 - 0.5).astype(np.float32)
    g_out = rng.standard_normal(x.shape).astype(np.float32)
    mask = np.zeros(6, bool)
    mask[:n_valid] = True
    jm = JaxMBN()
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))

    def fn(xx):
        y, mut = jm.apply(variables, xx, jnp.asarray(mask), True, mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(g_out)), (y, mut)

    (_, (want_y, mut)), want_dx = jax.value_and_grad(fn, has_aux=True)(jnp.asarray(x))
    tm = MaskedBatchNorm(8, device="cpu")
    xt = _t(x).permute(0, 3, 1, 2).requires_grad_()
    y = tm(xt, _t(mask), train=True)
    y.backward(_t(g_out).permute(0, 3, 1, 2))
    tol = dict(atol=2e-5, rtol=1e-5) if n_valid else dict(atol=1e-3, rtol=1e-5)  # /sqrt(eps)
    np.testing.assert_allclose(_np(y.permute(0, 2, 3, 1)), np.asarray(want_y), **tol)
    np.testing.assert_allclose(_np(xt.grad.permute(0, 2, 3, 1)), np.asarray(want_dx), **tol)
    new = _stats(mut)
    np.testing.assert_allclose(_np(tm.running_mean), new["mean"], atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(_np(tm.running_var), new["var"], atol=1e-6, rtol=1e-5)


# -------------------------------------------------------------- rasterize


def test_rasterize_label_maps_is_exact():
    from vibertgrid_tpu.ops.rasterize import rasterize_label_maps as jax_raster
    from vibertgrid_tpu_torch.ops.rasterize import rasterize_label_maps

    rng = np.random.default_rng(16)
    b, s, h, w = 2, 40, 64, 96  # 40 segments: two chunks of 32
    x0 = rng.integers(-8, w - 8, (b, s)); y0 = rng.integers(-4, h - 4, (b, s))
    boxes = np.stack([x0, y0, x0 + rng.integers(1, 40, (b, s)),
                      y0 + rng.integers(1, 24, (b, s))], -1).astype(np.int32)
    classes = rng.integers(0, 5, (b, s)).astype(np.int32)
    classes[0, 3] = 2000  # clipped to the 10-bit payload
    mask = rng.random((b, s)) > 0.2
    got = rasterize_label_maps(_t(classes), _t(boxes), _t(mask), height=h, width=w)
    for i in range(b):
        want = jax_raster(jnp.asarray(classes[i]), jnp.asarray(boxes[i]), jnp.asarray(mask[i]),
                          height=h, width=w)
        for g, wv in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(wv))
    assert set(np.unique(got[0].numpy())) == {0, 1, 2}
