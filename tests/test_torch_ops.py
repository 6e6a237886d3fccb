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
