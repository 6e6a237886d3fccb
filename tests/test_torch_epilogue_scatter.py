"""The plain versions behind the attention epilogue's and the scatter
backward's kernels (CPU, small sizes).

- ``proj_ln_reference`` is the FFN's ``ffn_down_ln_reference`` with the
  context as ``h`` and the out-projection as ``W2``, bit for bit: the card
  runs the epilogue in bf16 at width 768 on the down-projection's kernel.
- ``winner_cells`` (the scatter backward's first launch: each image's cells
  listed by winning segment) against the winners of the JAX package's Pallas
  scatter, interpreted, on one-hot embeddings.
- ``scatter_backward_pieces`` (the second launch's order: pieces of the
  list, partials added in piece order) against ``scatter_backward_reference``
  and the JAX scatter's interpreted VJP.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vibertgrid_tpu_torch.ops import fused_ffn as ffn
from vibertgrid_tpu_torch.ops import grid_scatter as gs


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------- epilogue


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_proj_ln_reference_is_the_down_projection(dtype, rate):
    rng = np.random.default_rng(50)
    n, d = 37, 64  # 37: no multiple of any block's rows
    f = lambda *shape: _t(rng.standard_normal(shape).astype(np.float32))
    ctx, res = f(n, d).to(dtype), f(n, d).to(dtype)
    w = f(d, d) * d ** -0.5  # nn.Linear layout [out, in], fp32 as a model holds it
    b, g, bt = 0.1 * f(d), 1 + 0.1 * f(d), 0.1 * f(d)
    eps, seed = 1e-12, 61
    got = ffn.proj_ln_reference(ctx, res, w, b, g, bt, eps, seed, rate)
    want = ffn.ffn_down_ln_reference(ctx, res, w, b, g, bt, eps, seed, rate)[0]
    assert got.dtype == want.dtype == dtype and got.shape == (n, d)
    assert torch.equal(got, want)


# -------------------------------------------------------------- scatter

H, W, STRIDE = 8, 12, 8
# tests/test_torch_train_ops.py's boxes under a page-wide one
BOXES = np.array([
    [0, 0, W * STRIDE, H * STRIDE],  # the whole page: wins what no later box covers
    [0, 0, 40, 32],      # overlapped by the next two
    [16, 8, 64, 40],
    [24, 16, 48, 32],    # masked: wins nothing
    [80, 40, 200, 100],  # runs past the right and bottom edges
    [8, 40, 24, 56],     # fully covered by the next: wins nothing
    [0, 32, 40, 64],
    [3, 5, 7, 7],        # inside one cell: covers no cell
], np.int32)
MASK = np.array([1, 1, 1, 0, 1, 1, 1, 1], bool)


def _two_images():
    """The boxes as they are, and reversed (the page-wide box then on top)."""
    return np.stack([BOXES, BOXES[::-1]]), np.stack([MASK, MASK[::-1]])


def _jax_winner(boxes, mask):
    """``[H, W]`` winners of the Pallas scatter, interpreted: the arg-max of
    the grid it paints from one-hot embeddings, 0 where it paints nothing."""
    from vibertgrid_tpu.ops.pallas_scatter import bertgrid_scatter_pallas

    s = len(boxes)
    grid = np.asarray(bertgrid_scatter_pallas(
        jnp.eye(s, dtype=jnp.float32), jnp.asarray(boxes), jnp.asarray(mask), height=H, width=W,
        stride=STRIDE, interpret=True))
    return np.where(grid.sum(-1) > 0, grid.argmax(-1) + 1, 0)


def _lists_from_winner(winner, s):
    """offsets [S + 2] and cells [H·W] of one image's winner map, by numpy."""
    key = np.where(winner.reshape(-1) > 0, winner.reshape(-1) - 1, s)
    counts = np.bincount(key, minlength=s + 1)
    return np.concatenate([[0], np.cumsum(counts)]), np.argsort(key, kind="stable")


def test_winner_cells_match_the_jax_scatters_winners():
    boxes, mask = _two_images()
    s = boxes.shape[1]
    offsets, cells = gs.winner_cells(_t(boxes), _t(mask), height=H, width=W, stride=STRIDE)
    assert offsets.dtype == cells.dtype == torch.int32
    assert offsets.shape == (2, s + 2) and cells.shape == (2, H * W)
    for i in range(2):
        want_offsets, want_cells = _lists_from_winner(_jax_winner(boxes[i], mask[i]), s)
        np.testing.assert_array_equal(offsets[i].numpy(), want_offsets)
        np.testing.assert_array_equal(cells[i].numpy(), want_cells)
    # the page-wide box wins the cells nobody else covers, the masked and the
    # covered box win nothing, and under the reversed order the page wins all
    won = np.diff(offsets.numpy(), axis=1)[:, :s]
    assert 0 < won[0, 0] < H * W and won[0, 3] == won[0, 5] == won[0, 7] == 0
    assert won[1, s - 1] == H * W and won[1].sum() == H * W


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_winner_cells_list_every_cell_once_in_order(seed):
    from vibertgrid_tpu_torch.entry import make_batch
    from vibertgrid_tpu_torch.ops.rasterize import box_winner_map

    batch = make_batch(3, 160, 120, 64, 40, 100, seed=seed, device="cpu")
    mask = batch.box_mask.clone()
    mask[:, 3::5] = False
    height, width = 20, 15
    offsets, cells = gs.winner_cells(batch.boxes, mask, height=height, width=width, stride=8)
    winner = box_winner_map(batch.boxes, mask, height=height, width=width, stride=8)
    for i in range(3):
        assert torch.equal(torch.sort(cells[i]).values, torch.arange(height * width).int())
        win = winner[i].reshape(-1)
        for seg in range(41):  # the 40 segments, then the cells nobody won
            run = cells[i, offsets[i, seg]:offsets[i, seg + 1]].long()
            assert bool((win[run] == (seg + 1 if seg < 40 else 0)).all())
            assert bool((run[1:] > run[:-1]).all())  # ascending
        assert offsets[i, 40] == int((win > 0).sum()) and offsets[i, 41] == height * width


def test_piece_order_sum_matches_reference_and_jax():
    from vibertgrid_tpu.ops.pallas_scatter import bertgrid_scatter_pallas

    boxes, mask = _two_images()
    d = 16
    rng = np.random.default_rng(51)
    emb = rng.standard_normal((2, len(BOXES), d)).astype(np.float32)
    d_out = rng.standard_normal((2, H, W, d)).astype(np.float32)

    def loss(e, bx, m, g):
        out = bertgrid_scatter_pallas(e, bx, m, height=H, width=W, stride=STRIDE, interpret=True)
        return jnp.sum(out * g)

    want = np.stack([
        np.asarray(jax.grad(loss)(*(jnp.asarray(a[i]) for a in (emb, boxes, mask, d_out))))
        for i in range(2)])
    # four cells a piece: the page-wide box's cells reach across many pieces
    offsets, _ = gs.winner_cells(_t(boxes), _t(mask), height=H, width=W, stride=STRIDE)
    assert int(offsets[0, 1]) > 8 * 4
    got = gs.scatter_backward_pieces(_t(d_out), _t(boxes), _t(mask), stride=STRIDE, piece=4)
    ref = gs.scatter_backward_reference(_t(d_out), _t(boxes), _t(mask), stride=STRIDE)
    # fp32 sums of up to 96 rows in another order
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=0)
    assert not got[0, 3].any() and not got[0, 5].any() and not got[0, 7].any()


@pytest.mark.parametrize("piece", [4, gs.PIECE])
def test_piece_order_sum_in_bf16(piece):
    """bf16 rows summed in fp32 and rounded once: within a bf16 ulp of the
    reference, whatever the piece size."""
    boxes, mask = _two_images()
    rng = np.random.default_rng(52)
    d_out = _t(rng.standard_normal((2, H, W, 24)).astype(np.float32)).bfloat16()
    got = gs.scatter_backward_pieces(d_out, _t(boxes), _t(mask), stride=STRIDE, piece=piece)
    want = gs.scatter_backward_reference(d_out, _t(boxes), _t(mask), stride=STRIDE)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=2 ** -7, rtol=2 ** -7)
