"""The port's sampled / OHEM losses against the JAX package's: value and
gradient, on the same numpy inputs (CPU, fp32).

The cases cover what decides which elements a loss selects and how the
gradient is shared among them: ties at the top-k threshold (a 4×-repeated
logit map, and the pooled forms, where every cell value repeats over its
pixels), ``k = -1``, ``k`` above the count, padded entries, class weights,
targets outside the class range, and random sampling, where the port takes
the int seed that ``derive_seed(key)`` gives on the JAX side.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vibertgrid_tpu.ops import losses as jl
from vibertgrid_tpu.ops.dropout import derive_seed
from vibertgrid_tpu_torch.ops import losses as tl

# fp32 on both sides; a loss is a mean of O(1) terms summed in another order
TOL = dict(atol=2e-6, rtol=1e-5)
KEY = jax.random.PRNGKey(42)
SEED = int(derive_seed(KEY))


def _t(x):
    return torch.from_numpy(np.array(x))


def _compare(jax_fn, torch_fn, logits):
    """Value and gradient with respect to the logits."""
    want, want_grad = jax.value_and_grad(jax_fn)(jnp.asarray(logits))
    leaf = _t(logits).requires_grad_()
    got = torch_fn(leaf)
    (got_grad,) = torch.autograd.grad(got, leaf)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad), **TOL)
    return got_grad.numpy()


def _segments(n=48, c=5, seed=0, tie=False):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, c)).astype(np.float32)
    targets = rng.integers(0, c, n).astype(np.int32)
    targets[: n // 3] = 0
    valid = rng.random(n) > 0.15
    if tie:  # every (logit row, target, valid) occurs four times: four-way ties everywhere
        targets[n // 8: n // 4] = 1 + targets[n // 8: n // 4] % (c - 1)
        logits = np.tile(logits[: n // 4], (4, 1))
        targets = np.tile(targets[: n // 4], 4)
        valid = np.tile(valid[: n // 4], 4)
    return logits, targets, valid


OHEM_COUNTS = [(-1, -1), (3, 4), (5, -1), (-1, 2), (100, 100), (1, 1)]


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("k_pos,k_neg", OHEM_COUNTS)
def test_cross_entropy_ohem(k_pos, k_neg, tie):
    logits, targets, valid = _segments(seed=1, tie=tie)
    kw = dict(num_hard_positive=k_pos, num_hard_negative=k_neg)
    grad = _compare(
        lambda x: jl.cross_entropy_ohem(x, jnp.asarray(targets), jnp.asarray(valid), **kw),
        lambda x: tl.cross_entropy_ohem(x, _t(targets), _t(valid), **kw),
        logits,
    )
    assert not grad[~valid].any()
    if tie and (k_pos, k_neg) == (1, 1):
        # one positive is kept, and it is a four-way tie: each copy gets a
        # quarter of it, none gets nothing
        rows = np.abs(grad).sum(1)
        pos = rows[(targets != 0) & valid]
        assert (pos > 0).sum() == 4 and len(set(np.round(pos[pos > 0], 7))) == 1


@pytest.mark.parametrize("k_pos,k_neg", [(-1, -1), (4, 4)])
def test_cross_entropy_ohem_weighted(k_pos, k_neg):
    logits, targets, valid = _segments(seed=2)
    targets[5] = 9   # outside [0, C): no gold logit, weight 0
    weight = [0.5, 1.0, 2.0, 1.5, 0.25]
    kw = dict(num_hard_positive=k_pos, num_hard_negative=k_neg, weight=weight)
    _compare(
        lambda x: jl.cross_entropy_ohem(x, jnp.asarray(targets), jnp.asarray(valid), **kw),
        lambda x: tl.cross_entropy_ohem(x, _t(targets), _t(valid), **kw),
        logits,
    )


@pytest.mark.parametrize("k_pos,k_neg", [(3, 4), (2, -1), (100, 100)])
def test_cross_entropy_ohem_random_presample(k_pos, k_neg):
    logits, targets, valid = _segments(n=64, seed=3)
    kw = dict(num_hard_positive=k_pos, num_hard_negative=k_neg, random=True)
    _compare(
        lambda x: jl.cross_entropy_ohem(x, jnp.asarray(targets), jnp.asarray(valid), key=KEY, **kw),
        lambda x: tl.cross_entropy_ohem(x, _t(targets), _t(valid), seed=SEED, **kw),
        logits,
    )


@pytest.mark.parametrize("sample_list", [None, [5, 7], [100, 1], [3, 2, 4, 100, 1], [0, 3]])
def test_cross_entropy_random_sample(sample_list):
    logits, targets, valid = _segments(n=64, seed=4)
    grad = _compare(
        lambda x: jl.cross_entropy_random_sample(
            x, jnp.asarray(targets), jnp.asarray(valid), sample_list=sample_list, key=KEY),
        lambda x: tl.cross_entropy_random_sample(
            x, _t(targets), _t(valid), sample_list=sample_list, seed=SEED),
        logits,
    )
    if sample_list == [5, 7]:
        rows = np.abs(grad).sum(1) > 0
        assert rows[(targets == 0)].sum() == 5 and rows[(targets != 0)].sum() == 7


def test_random_subsample_masks_select_the_same_sets():
    rng = np.random.default_rng(5)
    cats = rng.integers(0, 3, 500)
    masks = [cats == i for i in range(3)]
    limits = [10, 1000, 37]
    for key in jax.random.split(KEY, 3):
        want = jl._random_subsample_masks([jnp.asarray(m) for m in masks], limits, key)
        got = tl._random_subsample_masks([_t(m) for m in masks], limits, int(derive_seed(key)))
        for g, w, lim, m in zip(got, want, limits, masks):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert g.sum().item() == min(lim, m.sum())


def _binary(n=60, seed=6, tie=False):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal(n).astype(np.float32)
    targets = (rng.random(n) > 0.6).astype(np.float32)
    if tie:
        logits, targets = np.tile(logits[: n // 4], 4), np.tile(targets[: n // 4], 4)
    valid = rng.random(n) > 0.2
    return logits, targets, valid


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("k_pos,k_neg", [(-1, -1), (3, 5), (100, 2)])
def test_bce_ohem(k_pos, k_neg, tie):
    logits, targets, valid = _binary(tie=tie)
    for random in (False, True):
        kw = dict(num_hard_positive=k_pos, num_hard_negative=k_neg, random=random)
        _compare(
            lambda x: jl.bce_ohem(x, jnp.asarray(targets), jnp.asarray(valid), key=KEY, **kw),
            lambda x: tl.bce_ohem(x, _t(targets), _t(valid), seed=SEED, **kw),
            logits,
        )


@pytest.mark.parametrize("sample_list", [None, [6], [4, 50]])
def test_bce_random_sample(sample_list):
    logits, targets, valid = _binary(seed=7)
    _compare(
        lambda x: jl.bce_random_sample(
            x, jnp.asarray(targets), jnp.asarray(valid), sample_list=sample_list, key=KEY),
        lambda x: tl.bce_random_sample(
            x, _t(targets), _t(valid), sample_list=sample_list, seed=SEED),
        logits,
    )


def _pixels(b=2, h=6, w=8, c=4, block=4, seed=8):
    rng = np.random.default_rng(seed)
    logits4 = rng.standard_normal((b, h, w, c)).astype(np.float32)
    # coarse label blobs, so that whole cells share a class (ties across cells
    # come from repeating half of the logit map)
    logits4[:, :, w // 2:] = logits4[:, :, : w // 2]
    targets = rng.integers(0, c, (b, h * block // 2, w * block // 2)).astype(np.int32)
    targets = targets.repeat(2, axis=1).repeat(2, axis=2)
    targets[rng.random(targets.shape) < 0.5] = 0
    return logits4, targets


@pytest.mark.parametrize("k_pos,k_neg", [(-1, -1), (40, 60), (7, -1), (10000, 10000), (1, 1)])
def test_cross_entropy_ohem_pooled(k_pos, k_neg):
    logits4, targets = _pixels()
    targets[0, 0, :3] = 7  # the overflow bucket
    for weight in (None, [0.5, 1.0, 2.0, 1.5]):
        for random in (False, True):
            kw = dict(block=4, num_hard_positive=k_pos, num_hard_negative=k_neg,
                      weight=weight, random=random)
            _compare(
                lambda x: jl.cross_entropy_ohem_pooled(x, jnp.asarray(targets), key=KEY, **kw),
                lambda x: tl.cross_entropy_ohem_pooled(x, _t(targets), seed=SEED, **kw),
                logits4,
            )


def test_cross_entropy_ohem_pooled_equals_the_unpooled_loss():
    logits4, targets = _pixels(seed=9)
    full = logits4.repeat(4, axis=1).repeat(4, axis=2).reshape(-1, logits4.shape[-1])
    kw = dict(num_hard_positive=40, num_hard_negative=60)
    pooled = tl.cross_entropy_ohem_pooled(_t(logits4), _t(targets), block=4, **kw)
    flat = tl.cross_entropy_ohem(
        _t(full), _t(targets.reshape(-1)), torch.ones(full.shape[0], dtype=torch.bool), **kw)
    np.testing.assert_allclose(pooled.item(), flat.item(), **TOL)


@pytest.mark.parametrize("sample_list", [None, [30, 50], [20, 10, 5, 10000], [10000, 10000]])
def test_cross_entropy_random_sample_pooled(sample_list):
    logits4, targets = _pixels(seed=10)
    targets[1, 5, :2] = -3  # the overflow bucket
    _compare(
        lambda x: jl.cross_entropy_random_sample_pooled(
            x, jnp.asarray(targets), block=4, sample_list=sample_list, key=KEY),
        lambda x: tl.cross_entropy_random_sample_pooled(
            x, _t(targets), block=4, sample_list=sample_list, seed=SEED),
        logits4,
    )


@pytest.mark.parametrize("k_pos,k_neg", [(-1, -1), (30, 45), (10000, 3)])
def test_bce_ohem_pooled(k_pos, k_neg):
    logits4, targets = _pixels(seed=11)
    rng = np.random.default_rng(12)
    gate = rng.random(targets.shape) > 0.3
    for random in (False, True):
        kw = dict(block=4, num_hard_positive=k_pos, num_hard_negative=k_neg, random=random)
        _compare(
            lambda x: jl.bce_ohem_pooled(
                x, jnp.asarray(targets == 2), jnp.asarray(gate), key=KEY, **kw),
            lambda x: tl.bce_ohem_pooled(x, _t(targets == 2), _t(gate), seed=SEED, **kw),
            logits4[..., 0],
        )


def test_topk_helpers_with_k_zero_and_empty_masks():
    losses = torch.tensor([1.0, 2.0, 3.0])
    none = torch.zeros(3, dtype=torch.bool)
    assert tl._masked_topk_sum(losses, none, 2)[0].item() == 0
    assert tl._masked_topk_sum(losses, ~none, 0)[0].item() == 0
    total, kept = tl._masked_topk_sum(losses, ~none, 2)
    assert (total.item(), kept.item()) == (5.0, 2)
    total, kept = tl._weighted_topk_sum(losses, torch.tensor([2, 0, 1]), 2)
    assert (total.item(), kept.item()) == (4.0, 2)  # 3 once, then one of the two 1s
