"""The port's tensor operations and kernel twins against the JAX package's
functions, on the same numpy inputs (CPU, fp32).

Where the JAX function is a Pallas kernel it runs with ``interpret=True``,
as the JAX package's own kernel tests run it. On CPU tensors the port's
kernel wrappers run their plain twins, so these tests pin the arithmetic
that the CUDA kernels are then held to on the card (chip_smoke.py).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

RNG = np.random.default_rng(17)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _boxes(s, h, w, stride=8, seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.integers(0, w * stride - 16, s)
    y0 = rng.integers(0, h * stride - 16, s)
    return np.stack(
        [x0, y0, x0 + rng.integers(8, 64, s), y0 + rng.integers(8, 32, s)], 1
    ).astype(np.int32)


# ---------------------------------------------------------------- windows


@pytest.mark.parametrize("n_valid", [None, 0, 300, 510, 700, 1020])
def test_frame_windows_matches_jax(n_valid):
    from vibertgrid_tpu.ops.windows import frame_windows as jax_frame
    from vibertgrid_tpu_torch.ops.windows import frame_windows

    b, t = 2, 1020
    tokens = RNG.integers(3, 500, (b, t)).astype(np.int32)
    mask = np.zeros((b, t), np.int32)
    mask[0, : (n_valid or 0)] = 1
    mask[1, : (n_valid or 0) // 2] = 1
    kw = dict(cls_id=101, sep_id=102)
    if n_valid is None:
        want = jax_frame(jnp.asarray(tokens), jnp.asarray(mask), **kw)
        got = frame_windows(_t(tokens), _t(mask), **kw)
    else:
        seq_len = int(mask.sum(1).max())
        want = jax_frame(jnp.asarray(tokens), jnp.asarray(mask), seq_len=jnp.int32(seq_len), **kw)
        got = frame_windows(_t(tokens), _t(mask), seq_len=torch.tensor(seq_len), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_unframe_windows_matches_jax():
    from vibertgrid_tpu.ops.windows import unframe_windows as jax_unframe
    from vibertgrid_tpu_torch.ops.windows import unframe_windows

    x = RNG.standard_normal((4, 512, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        unframe_windows(_t(x), batch_size=2).numpy(),
        np.asarray(jax_unframe(jnp.asarray(x), batch_size=2)),
    )


# --------------------------------------------------------------- segments


@pytest.mark.parametrize("mode", ["mean", "first"])
def test_aggregate_token_embeddings_matches_jax(mode):
    from vibertgrid_tpu.ops.segments import aggregate_token_embeddings as jax_agg
    from vibertgrid_tpu_torch.ops.segments import aggregate_token_embeddings

    b, t, d, s = 2, 60, 16, 12
    emb = RNG.standard_normal((b, t, d)).astype(np.float32)
    seg_ids = RNG.integers(0, s - 2, (b, t)).astype(np.int32)  # segments s-2, s-1 empty
    mask = (RNG.random((b, t)) > 0.3).astype(np.int32)
    want = np.asarray(
        jax_agg(jnp.asarray(emb), jnp.asarray(seg_ids), jnp.asarray(mask),
                num_segments=s, mode=mode)
    )
    got = aggregate_token_embeddings(_t(emb), _t(seg_ids), _t(mask), num_segments=s, mode=mode)
    # fp32 sums of up to ~10 terms in another order: 1e-6.
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def _scatter_mean(emb, seg_ids, mask, s):
    """The aggregation's former formulation: ``scatter_add_`` into segment
    sums (atomics on the card), then the mean."""
    b, t, d = emb.shape
    valid = mask.bool()
    ids = torch.where(valid, seg_ids.long(), s)
    e = torch.where(valid[..., None], emb, 0)
    sums = e.new_zeros((b, s + 1, d)).scatter_add_(1, ids[..., None].expand(b, t, d), e)
    counts = e.new_zeros((b, s + 1)).scatter_add_(1, ids, valid.to(e.dtype))
    return sums[:, :-1] / counts[:, :-1].clamp_min(1)[..., None]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_mean_as_a_product_matches_jax_and_the_scatter(dtype):
    """The segment mean as one product with a 0/1 matrix (deterministic on
    the card) against JAX ``segment_sum`` and against the port's former
    ``scatter_add_``, in fp32 and in bf16; its gradient is the transposed
    product, each token's segment's gradient over the count."""
    from vibertgrid_tpu.ops.segments import aggregate_token_embeddings as jax_agg
    from vibertgrid_tpu_torch.ops.segments import aggregate_token_embeddings

    b, t, d, s = 2, 60, 16, 12
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((b, t, d)).astype(np.float32)
    seg_ids = rng.integers(0, s - 2, (b, t)).astype(np.int32)
    mask = (rng.random((b, t)) > 0.3).astype(np.int32)
    dt = getattr(torch, dtype)
    x = _t(emb).to(dt).requires_grad_()
    got = aggregate_token_embeddings(x, _t(seg_ids), _t(mask), num_segments=s)
    former = _scatter_mean(_t(emb).to(dt), _t(seg_ids), _t(mask), s)
    want = np.asarray(jax_agg(jnp.asarray(emb, getattr(jnp, dtype)), jnp.asarray(seg_ids),
                              jnp.asarray(mask), num_segments=s).astype(jnp.float32))
    assert got.dtype == dt
    # fp32: sums of up to ~10 terms in other orders; bf16: the product sums
    # in fp32 and rounds once, the scatter and XLA round after each add
    tol = dict(atol=1e-6, rtol=0) if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got.float().detach().numpy(), want, **tol)
    np.testing.assert_allclose(got.float().detach().numpy(), former.float().numpy(), **tol)
    g = rng.standard_normal((b, s, d)).astype(np.float32)
    got.backward(_t(g).to(dt))
    counts = np.zeros((b, s))
    for i in range(b):
        np.add.at(counts[i], seg_ids[i][mask[i] > 0], 1)
    rows = np.take_along_axis(g / np.maximum(counts, 1)[..., None], seg_ids[..., None], 1)
    np.testing.assert_allclose(x.grad.float().numpy(), rows * mask[..., None], **tol)


def test_embedding_lookup_gradient_sums_each_id_in_order():
    """``embedding_lookup``'s gradient (a sorted segment sum) against the
    library's embedding backward: every row, with an id that repeats
    everywhere (the token type's case) and ids never looked up."""
    from vibertgrid_tpu_torch.ops.segments import embedding_lookup, sorted_segment_sum

    rng = np.random.default_rng(9)
    ids = _t(rng.integers(0, 40, (3, 50)))
    ids[1] = 7
    weight = _t(rng.standard_normal((64, 8)).astype(np.float32))
    g = _t(rng.standard_normal((3, 50, 8)).astype(np.float32))
    ours = weight.clone().requires_grad_()
    embedding_lookup(ours, ids).backward(g)
    theirs = weight.clone().requires_grad_()
    torch.nn.functional.embedding(ids, theirs).backward(g)
    np.testing.assert_allclose(ours.grad.numpy(), theirs.grad.numpy(), atol=1e-5, rtol=1e-6)
    assert not ours.grad[40:].any()
    got = sorted_segment_sum(g.reshape(-1, 8), ids.reshape(-1), 64)
    np.testing.assert_allclose(got.numpy(), theirs.grad.numpy(), atol=1e-5, rtol=1e-6)


def test_nearest_upsampling_as_a_broadcast():
    """The FPN's ``_up`` against ``F.interpolate(mode="nearest")`` and the
    JAX package's ``repeat``: the same values, and the gradient each pixel
    collects from its copies."""
    from vibertgrid_tpu.models.resnet_fpn import _upsample_nearest
    from vibertgrid_tpu_torch.models.resnet_fpn import _up

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 5, 7)).astype(np.float32)
    g = rng.standard_normal((2, 3, 10, 14)).astype(np.float32)
    ours, former = (_t(x).requires_grad_() for _ in range(2))
    y = _up(ours, 2)
    np.testing.assert_array_equal(
        y.detach().numpy(),
        np.asarray(_upsample_nearest(jnp.asarray(x.transpose(0, 2, 3, 1)), 2)).transpose(0, 3, 1, 2))
    y_former = torch.nn.functional.interpolate(former, scale_factor=2, mode="nearest")
    np.testing.assert_array_equal(y.detach().numpy(), y_former.detach().numpy())
    y.backward(_t(g))
    y_former.backward(_t(g))
    np.testing.assert_allclose(ours.grad.numpy(), former.grad.numpy(), atol=1e-6, rtol=0)
    assert _up(ours, 1) is ours


def test_crf_gold_score_by_one_hot_products():
    """The CRF's gold-path score reads the transitions by one-hot products
    (their gradient is a product too): the values and the transitions'
    gradient of the former indexed reads ``transitions[tags, prev]``,
    ``transitions[-1][last]``."""
    from vibertgrid_tpu_torch.ops.crf import _active, _gold_score

    rng = np.random.default_rng(6)
    b, t, k = 3, 9, 6
    trans = _t(rng.standard_normal((k, k)).astype(np.float32))
    feats = _t(rng.standard_normal((b, t, k)).astype(np.float32))
    tags = _t(rng.integers(0, k - 2, (b, t)))
    lengths = _t(np.array([9, 4, 1]))
    ours, former = (trans.clone().requires_grad_() for _ in range(2))
    got = _gold_score(ours, feats, tags, lengths)
    prev = torch.cat([tags.new_full((b, 1), k - 2), tags[:, :-1]], dim=1)
    steps = former[tags, prev] + torch.gather(feats, 2, tags[..., None])[..., 0]
    last = torch.gather(tags, 1, (lengths - 1)[:, None])[:, 0]
    want = torch.where(_active(feats, lengths), steps, 0.0).sum(1) + former[-1][last]
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=1e-6)
    got.sum().backward()
    want.sum().backward()
    np.testing.assert_allclose(ours.grad.numpy(), former.grad.numpy(), atol=1e-6)


# ------------------------------------------------------------- rasterize


def test_box_winner_map_matches_jax():
    from vibertgrid_tpu.ops.rasterize import box_winner_map as jax_wmap
    from vibertgrid_tpu_torch.ops.rasterize import box_winner_map

    h, w, s = 20, 24, 45  # S not a multiple of the 32-box chunk
    boxes = _boxes(s, h, w, stride=4, seed=1)
    mask = RNG.random(s) > 0.2
    want = jax_wmap(jnp.asarray(boxes), jnp.asarray(mask), height=h, width=w, stride=4)
    got = box_winner_map(_t(boxes), _t(mask), height=h, width=w, stride=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("height", [16, 13])  # 13: not a multiple of the Pallas row tile
def test_bertgrid_scatter_matches_jax_and_pallas(height):
    from vibertgrid_tpu.ops.pallas_scatter import bertgrid_scatter_pallas
    from vibertgrid_tpu.ops.rasterize import bertgrid_scatter as jax_scatter
    from vibertgrid_tpu_torch.ops.grid_scatter import grid_scatter
    from vibertgrid_tpu_torch.ops.rasterize import bertgrid_scatter

    b, w, s, d = 2, 16, 19, 32
    embs = RNG.standard_normal((b, s, d)).astype(np.float32)
    boxes = np.stack([_boxes(s, height, w, seed=10 + i) for i in range(b)])
    boxes[:, 0] = [0, 0, 64, 64]      # overlapping pair, the later one wins
    boxes[:, 1] = [32, 32, 96, 96]
    boxes[:, 2] = [w * 8 - 24, height * 8 - 16, w * 8 + 40, height * 8]  # past the edge
    mask = RNG.random((b, s)) > 0.2
    mask[:, :3] = True
    kw = dict(height=height, width=w, stride=8)
    got = bertgrid_scatter(_t(embs), _t(boxes), _t(mask), **kw).numpy()
    batched = grid_scatter(_t(embs), _t(boxes), _t(mask), **kw).numpy()
    np.testing.assert_array_equal(batched, got)
    for i in range(b):
        args = (jnp.asarray(embs[i]), jnp.asarray(boxes[i]), jnp.asarray(mask[i]))
        np.testing.assert_array_equal(got[i], np.asarray(jax_scatter(*args, **kw)))
        pallas = bertgrid_scatter_pallas(*args, tile_h=8, interpret=True, **kw)
        np.testing.assert_array_equal(got[i], np.asarray(pallas))
        one = bertgrid_scatter(_t(embs[i]), _t(boxes[i]), _t(mask[i]), **kw).numpy()
        np.testing.assert_array_equal(one, got[i])


# -------------------------------------------------------------- attention


@pytest.mark.parametrize("t", [130, 512])
def test_attention_twin_matches_pallas(t):
    from vibertgrid_tpu.ops.flash_attention import flash_attention as jax_flash
    from vibertgrid_tpu_torch.ops.flash_attention import flash_attention

    b, h, d = 2, 4, 16
    q, k, v = (RNG.standard_normal((b, t, h * d)).astype(np.float32) for _ in range(3))
    valid = np.ones((b, t), bool)
    valid[0, t // 3:] = False  # padded keys
    valid[1, -7:] = False
    bias = np.where(valid, 0.0, -1e9).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
                     jnp.zeros((), jnp.int32), scale, h, 0.0, True)
    got = flash_attention(_t(q), _t(k), _t(v), _t(bias), scale, h)
    # fp32 softmax and products over up to 512 keys, summed in another
    # order: 2e-5 on outputs of order 1.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


# -------------------------------------------------------------------- FFN


def test_ffn_twin_matches_pallas():
    from vibertgrid_tpu.ops.fused_ffn import fused_ffn as jax_ffn
    from vibertgrid_tpu_torch.ops.fused_ffn import fused_ffn

    n, d, f = 40, 64, 128  # rows not a multiple of the kernel's row tile
    x = RNG.standard_normal((n, d)).astype(np.float32)
    w1 = (RNG.standard_normal((d, f)) * 0.1).astype(np.float32)
    b1 = (RNG.standard_normal(f) * 0.1).astype(np.float32)
    w2 = (RNG.standard_normal((f, d)) * 0.1).astype(np.float32)
    b2 = (RNG.standard_normal(d) * 0.1).astype(np.float32)
    g = (1 + 0.1 * RNG.standard_normal(d)).astype(np.float32)
    bt = (0.1 * RNG.standard_normal(d)).astype(np.float32)
    want = jax_ffn(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2, g, bt)),
                   jnp.zeros((), jnp.int32), 1e-12, 0.0, True)
    # the port takes W1/W2 in nn.Linear layout: [F, D] and [D, F]
    got = fused_ffn(_t(x), _t(w1.T), _t(b1), _t(w2.T), _t(b2), _t(g), _t(bt), 1e-12)
    # fp32 products over 64 and 128 terms then a LayerNorm: 2e-5.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_erf_polynomial_matches_jax():
    from vibertgrid_tpu.ops.fused_ffn import _erf_f32
    from vibertgrid_tpu_torch.ops.fused_ffn import erf_f32

    x = np.linspace(-6, 6, 4001).astype(np.float32)
    np.testing.assert_allclose(erf_f32(_t(x)).numpy(), np.asarray(_erf_f32(jnp.asarray(x))),
                               atol=1e-7, rtol=0)


# --------------------------------------------------------------- roi_align


def test_roi_align_matches_jax():
    from vibertgrid_tpu.ops.roi_align import roi_align as jax_roi
    from vibertgrid_tpu_torch.ops.roi_align import roi_align

    b, hf, wf, c, s = 2, 16, 24, 8, 9
    feats = RNG.standard_normal((b, hf, wf, c)).astype(np.float32)
    rois = np.stack([_boxes(s, hf // 2, wf // 2, seed=20 + i) for i in range(b)]).astype(np.float32)
    rois[0, 0] = [0, 0, 4 * wf, 4 * hf]          # the whole map
    rois[0, 1] = [4 * wf - 2, 4 * hf - 2, 4 * wf + 30, 4 * hf + 9]  # past the high edge
    rois[1, 0] = [5, 5, 5, 5]                    # degenerate
    mask = RNG.random((b, s)) > 0.2
    want = jax_roi(jnp.asarray(feats), jnp.asarray(rois), jnp.asarray(mask))
    got = roi_align(_t(feats), _t(rois), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# ------------------------------------------------------------------ norms


def test_norms_match_jax():
    from vibertgrid_tpu.models import norm as jnorm
    from vibertgrid_tpu_torch.models import norm

    x = (RNG.standard_normal((3, 5, 6, 8)) * 3 + 1).astype(np.float32)
    scale = (1 + 0.2 * RNG.standard_normal(8)).astype(np.float32)
    bias = (0.2 * RNG.standard_normal(8)).astype(np.float32)
    mean = RNG.standard_normal(8).astype(np.float32)
    var = RNG.uniform(0.5, 2, 8).astype(np.float32)
    params = {"params": {"scale": scale, "bias": bias},
              "batch_stats": {"mean": mean, "var": var}}
    mask = jnp.ones(3, bool)
    nchw = _t(x).permute(0, 3, 1, 2)
    tmask = torch.ones(3, dtype=torch.bool)
    cases = [
        (jnorm.LayerNorm(epsilon=1e-12), (jnp.asarray(x),),
         norm.LayerNorm(8, eps=1e-12), (_t(x),), False),
        (jnorm.BatchNorm(), (jnp.asarray(x),), norm.BatchNorm(8), (nchw,), True),
        (jnorm.MaskedBatchNorm(), (jnp.asarray(x), mask), norm.MaskedBatchNorm(8),
         (nchw, tmask), True),
    ]
    for jm, jargs, tm, targs, channels_first in cases:
        want = np.asarray(jm.apply(params if channels_first else {"params": params["params"]},
                                   *jargs))
        with torch.no_grad():
            tm.weight.copy_(_t(scale))
            tm.bias.copy_(_t(bias))
            if channels_first:
                tm.running_mean.copy_(_t(mean))
                tm.running_var.copy_(_t(var))
            got = tm(*targs)
        if channels_first:
            got = got.permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=1e-6)
