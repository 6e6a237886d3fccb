"""Sampled / OHEM losses as static-shape masked reductions (port of
``vibertgrid_tpu/ops/losses.py``).

Every variant is a masked fixed-shape computation, so no step depends on a
count read back from the device:

- ``cross_entropy_random_sample``: per-category random keep of
  ``min(sample, n_cat)`` elements; a 2-element sample list splits into
  (target == 0, target != 0), a C-element list per class.
- ``cross_entropy_ohem``: positives = target != 0, negatives = target == 0;
  optional random pre-sampling of ``2k`` before keeping the ``min(k, n)``
  hardest (largest) losses of each side; mean = sum / total kept.
- ``bce_random_sample``: binary, categories split by the prediction sign.
- ``bce_ohem``: binary OHEM split by target == 0.
- the ``*_pooled`` forms compute the same losses over ``block``-times
  nearest-upsampled logits at cell cost.

``k = -1`` disables mining. All functions take a ``valid`` mask so padded
entries behave as if absent. Where the JAX package takes a PRNG key, these
take an int ``seed``: the random keys are ``splitmix32(index, seed)``, the
stream the JAX package draws after ``derive_seed(key)``.

Two rules of the JAX package are kept because they decide gradients:

- ties at the top-k threshold contribute ``n_take/n_ties · Σ tied losses``,
  so every tied element gets a gradient (``torch.topk`` would pick some ties
  and leave the others without one). Ties are everywhere in the pooled
  losses;
- a random subsample is the k largest hash keys of the category, exact and
  without replacement; the keys are distinct, so no tie rule is needed.

The JAX package finds each threshold by a 32-step search over the key bits
(sorting is slow on its hardware); here the thresholds come from
``torch.topk`` and a sort, which select the same sets.

Inside a data-parallel train step
(:func:`vibertgrid_tpu_torch.parallel.collectives.global_batch`) every
selection and every count is over the global batch, as in the JAX package's
one program over it: the global k largest lie among the union of each
rank's k largest, so each rank gathers its k candidate keys, all find the
global threshold, each sums its own share (ties included), and the sums and
counts are summed over the ranks. The random keys hash the global flat
index (this rank's base plus the local index), so the selected sets are a
single process's on the concatenated batch when the ranks' shapes agree,
and the ranks' streams are disjoint when they do not.
"""

from __future__ import annotations

import functools

import torch

from vibertgrid_tpu_torch.ops.dropout import flat_index, splitmix32
from vibertgrid_tpu_torch.parallel.collectives import active, all_sum, gather, index_base


@functools.lru_cache(maxsize=None)
def _weights_on(weight: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(weight, dtype=torch.float32, device=device)


def _weight_tensor(weight, device):
    """The class weights on ``device``, copied there once (an eager step
    makes the copy before a CUDA graph's capture would need it)."""
    if isinstance(weight, torch.Tensor):
        return weight.to(device=device, dtype=torch.float32)
    return _weights_on(tuple(float(w) for w in weight), torch.device(device))


def _per_example_weight(targets, weight):
    """Class weight per example; 0 for a target outside ``[0, C)``."""
    w = _weight_tensor(weight, targets.device)
    inside = (targets >= 0) & (targets < w.shape[0])
    return torch.where(inside, w[targets.long().clamp(0, w.shape[0] - 1)], 0.0)


def _ce_per_example(logits, targets, weight=None):
    """Per-example weighted cross entropy (``reduction='none'``). A target
    outside ``[0, C)`` selects no gold logit: its loss is ``logsumexp``."""
    logits = logits.float()
    c = logits.shape[-1]
    t = targets.long()
    inside = (t >= 0) & (t < c)
    gold = torch.gather(logits, -1, t.clamp(0, c - 1)[..., None])[..., 0]
    loss = torch.logsumexp(logits, dim=-1) - torch.where(inside, gold, 0.0)
    if weight is not None:
        loss = loss * _per_example_weight(targets, weight)
    return loss


def _bce_per_example(logits, targets):
    """Per-example binary cross entropy with logits (stable formulation)."""
    logits = logits.float()
    targets = targets.float()
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _sortable_key(x):
    """Monotone fp32 → int64 key in ``[0, 2³²)`` (total order; sign-flip
    trick on the bit pattern)."""
    x = x.detach().float().contiguous()
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(x >= 0, bits | 0x80000000, bits ^ 0xFFFFFFFF)


def _tie_take(sum_above, cnt_above, sum_ties, cnt_ties, kept):
    n_take = (kept - cnt_above).clamp(min=0)
    frac = n_take.float() / cnt_ties.clamp(min=1).float()
    return sum_above + frac * sum_ties


def _global_topk(keys, k: int, pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of this rank's ``min(k, n)`` largest ``keys``,
    the values padded with ``pad`` to ``k``, gathered from every rank:
    ``[world·k]`` candidates that hold the global k largest (in one process,
    this process's k largest)."""
    kk = min(k, keys.numel())
    top = torch.topk(keys, kk)
    values = torch.cat([top.values, top.values.new_full((k - kk,), pad)])
    return gather(values).reshape(-1), top.indices


def _kth_largest(keys, k: int, pad: int) -> torch.Tensor:
    """The k-th largest of the ranks' ``keys`` together, ``pad`` where fewer
    than k exist (one process: its own, already in order)."""
    cands = _global_topk(keys, k, pad)[0]
    return torch.topk(cands, k).values[-1] if active() else cands[k - 1]


def _sum_pairs(values, counts):
    """The ranks' sums of a list of value sums and of a list of counts."""
    return all_sum(torch.stack(values)).unbind(), all_sum(torch.stack(counts)).unbind()


def _masked_topk_sum(losses, mask, k: int):
    """Sum of the ``min(k, n_masked)`` largest masked losses, and the kept
    count. ``k = -1`` keeps everything masked. Threshold ties are taken
    through their values (see the module docstring)."""
    n = all_sum(mask.sum())
    if k == -1:
        return all_sum(torch.where(mask, losses, 0.0).sum()), n
    if k == 0:
        return losses.new_zeros(()), torch.zeros_like(n)
    keys = torch.where(mask, _sortable_key(losses), 0).reshape(-1)
    # key of the k-th largest value; 0 ("keep everything") when fewer than k
    # elements exist at all
    t = _kth_largest(keys, k, 0)
    keys = keys.reshape(mask.shape)
    above = keys > t
    ties = (keys == t) & mask & (t > 0)
    kept = n.clamp(max=k)
    (sum_above, sum_ties), (cnt_above, cnt_ties) = _sum_pairs(
        [torch.where(above, losses, 0.0).sum(), torch.where(ties, losses, 0.0).sum()],
        [above.sum(), ties.sum()])
    return _tie_take(sum_above, cnt_above, sum_ties, cnt_ties, kept), kept


def _weighted_threshold(keys, w, k: int):
    """The largest key t whose weighted count of keys >= t reaches k (0 if
    none does)."""
    order = torch.argsort(keys, descending=True)
    reached = torch.cumsum(w[order], 0) >= k
    first = torch.argmax(reached.to(torch.int8))
    # a gather by the 1-element index: indexing by the 0-d ``first`` would
    # read it back to the host
    at = keys.gather(0, order.gather(0, first.reshape(1)))[0]
    return torch.where(reached.any(), at, 0)


def _weighted_topk_sum(values, weights, k: int):
    """Sum of the ``min(k, Σweights)`` largest elements of the multiset in
    which ``values[i]`` occurs ``weights[i]`` times (integer weights ≥ 0),
    and the kept count. Gradients reach ``values`` through the weighted
    sums; threshold ties as in :func:`_masked_topk_sum`."""
    w = weights.reshape(-1).to(torch.int64)
    v = values.float().reshape(-1)
    wf = w.float()
    n = all_sum(w.sum())
    if k == -1:
        return all_sum((wf * v).sum()), n
    if k == 0:
        return v.new_zeros(()), torch.zeros_like(n)
    keys = torch.where(w > 0, _sortable_key(v), 0)
    # every key at or above the threshold that a rank leaves out of its k
    # largest lies below k of its own candidates, each of weight >= 1, so
    # the candidates decide the threshold
    cand_keys, idx = _global_topk(keys, k, 0)
    cw = w[idx]
    t = _weighted_threshold(cand_keys, gather(torch.cat([cw, cw.new_zeros(k - cw.numel())])
                                              ).reshape(-1), k)
    above = keys > t
    ties = (keys == t) & (w > 0) & (t > 0)
    kept = n.clamp(max=k)
    (sum_above, sum_ties), (cnt_above, cnt_ties) = _sum_pairs(
        [torch.where(above, wf * v, 0.0).sum(), torch.where(ties, wf * v, 0.0).sum()],
        [torch.where(above, w, 0).sum(), torch.where(ties, w, 0).sum()])
    return _tie_take(sum_above, cnt_above, sum_ties, cnt_ties, kept), kept


def _hash_bits(n: int, seed: int, device) -> torch.Tensor:
    """``[n]`` int64 random keys in ``[0, 2³²)``: splitmix32 of (seed, global
    flat index). The finalizer is a bijection, so the keys are pairwise
    distinct."""
    return splitmix32(flat_index(n, device, index_base(n, device)), seed)


def _random_subsample_masks(cat_masks, limits, seed: int):
    """Uniform ``min(limit_i, n_i)`` subsets of disjoint categories: the
    ``limit_i`` largest keys among a category's entries, all categories
    drawing from one key stream. Returns kept masks shaped as ``cat_masks``."""
    n = cat_masks[0].numel()
    bits = _hash_bits(n, seed, cat_masks[0].device)
    outs = []
    for mask, limit in zip(cat_masks, limits):
        flat = mask.reshape(-1)
        if limit <= 0:
            keep = torch.zeros_like(flat)
        else:
            keyed = torch.where(flat, bits, -1)
            # the limit-th largest key of the category; -1 (keep the whole
            # category) when it has fewer entries than the limit
            keep = flat & (keyed >= _kth_largest(keyed, limit, -1))
        outs.append(keep.reshape(mask.shape))
    return outs


def _ohem_random_presample(pos_mask, neg_mask, num_hard_positive, num_hard_negative, seed):
    """Random 2k pre-sampling of both OHEM sides from one joint draw."""
    cats, lims = [], []
    if num_hard_positive != -1:
        cats.append(pos_mask)
        lims.append(2 * num_hard_positive)
    if num_hard_negative != -1:
        cats.append(neg_mask)
        lims.append(2 * num_hard_negative)
    if not cats:
        return pos_mask, neg_mask
    outs = _random_subsample_masks(cats, lims, seed)
    if num_hard_positive != -1:
        pos_mask = outs.pop(0)
    if num_hard_negative != -1:
        neg_mask = outs.pop(0)
    return pos_mask, neg_mask


def _block_sum(x, block: int):
    """Sum over non-overlapping ``block×block`` tiles of ``[..., H, W]``."""
    *lead, h, w = x.shape
    return x.reshape(*lead, h // block, block, w // block, block).sum(dim=(-3, -1))


def _cell_ce_values(logits4, weight=None):
    """``[..., C+1]`` per-class CE value table: ``CE(logits, c)`` for each
    class plus an overflow column (index C) holding the loss of a target
    outside ``[0, C)``: plain ``logsumexp``, or 0 under class weights."""
    logits4 = logits4.float()
    logz = torch.logsumexp(logits4, dim=-1, keepdim=True)
    vals = logz - logits4
    if weight is not None:
        vals = vals * _weight_tensor(weight, logits4.device)
        over = torch.zeros_like(logz)
    else:
        over = logz
    return torch.cat([vals, over], dim=-1)


def _class_count_masks(targets, c: int):
    """Per-class pixel masks incl. the overflow bucket (targets ∉ [0, C))."""
    masks = [targets == ci for ci in range(c)]
    masks.append((targets < 0) | (targets >= c))
    return masks


def _counts(masks, block: int):
    return torch.stack([_block_sum(m.to(torch.int32), block) for m in masks], dim=-1)


def _mean_of_selected(pos_sum, pos_n, neg_sum, neg_n):
    return (pos_sum + neg_sum) / (pos_n + neg_n).float().clamp(min=1.0)


def cross_entropy_ohem_pooled(logits4, targets, *, block: int, num_hard_positive: int = -1,
                              num_hard_negative: int = -1, weight=None, random: bool = False,
                              seed: int | None = None):
    """:func:`cross_entropy_ohem` over block-upsampled logits, exactly, at
    cell cost: within a ``block×block`` tile every pixel shares the cell's
    logits, so per-pixel CE takes at most C distinct values per cell. The
    selection masks stay at pixel resolution (integer work only); the loss
    reduction runs on the ``[B, h, w, C+1]`` value table weighted by
    per-(cell, class) pixel counts, and gradients flow only through that
    table.

    logits4 ``[B, h, w, C]`` cell logits; targets ``[B, h·block, w·block]``.
    """
    c = logits4.shape[-1]
    vals = _cell_ce_values(logits4, weight)
    cmasks = _class_count_masks(targets, c)

    if num_hard_positive == -1 and num_hard_negative == -1:
        counts = _counts(cmasks, block).float()
        total = all_sum((counts * vals).sum())
        if weight is not None:
            w_ext = torch.cat([_weight_tensor(weight, vals.device), vals.new_zeros(1)])
            return total / all_sum((counts * w_ext).sum()).clamp(min=1e-12)
        return total / all_sum(counts.sum()).clamp(min=1.0)

    pos_mask, neg_mask = targets != 0, targets == 0
    if random:
        assert seed is not None, "ohem random sampling needs a seed"
        pos_mask, neg_mask = _ohem_random_presample(
            pos_mask, neg_mask, num_hard_positive, num_hard_negative, seed)
    # The negative side only ever holds class-0 pixels; the positive side
    # covers classes 1..C-1 plus the overflow bucket.
    pos_counts = _counts([pos_mask & m for m in cmasks[1:]], block)
    neg_counts = _block_sum(neg_mask.to(torch.int32), block)[..., None]
    pos = _weighted_topk_sum(vals[..., 1:], pos_counts, num_hard_positive)
    neg = _weighted_topk_sum(vals[..., :1], neg_counts, num_hard_negative)
    return _mean_of_selected(*pos, *neg)


def cross_entropy_random_sample_pooled(logits4, targets, *, block: int, sample_list=None,
                                       weight=None, seed: int | None = None):
    """:func:`cross_entropy_random_sample` over block-upsampled logits,
    exactly, at cell cost (see :func:`cross_entropy_ohem_pooled`)."""
    c = logits4.shape[-1]
    vals = _cell_ce_values(logits4, weight)
    cmasks = _class_count_masks(targets, c)

    if sample_list is None:
        counts = _counts(cmasks, block).float()
        return all_sum((counts * vals).sum()) / all_sum(counts.sum()).clamp(min=1.0)

    assert seed is not None, "random sampling needs a seed"
    num_cats = len(sample_list)
    if num_cats == 2 and c >= 2:
        cat_masks = [targets == 0, targets != 0]
        # a pixel's loss is CE at its own class, so the "!= 0" category needs
        # per-class counts (incl. the overflow bucket)
        cat_classes = [[0], list(range(1, c + 1))]
    else:
        assert num_cats == c, (
            f"sample_list length {num_cats} must be 2 or match the class dimension {c}")
        cat_masks = [targets == i for i in range(num_cats)]
        cat_classes = [[i] for i in range(num_cats)]

    kept_list = _random_subsample_masks(cat_masks, list(sample_list), seed)
    total = vals.new_zeros(())
    count = vals.new_zeros(())
    for kept, classes in zip(kept_list, cat_classes):
        for ci in classes:
            kc = _block_sum((kept & cmasks[ci]).to(torch.int32), block).float()
            total = total + (kc * vals[..., ci]).sum()
            count = count + kc.sum()
    return all_sum(total) / all_sum(count).clamp(min=1.0)


def bce_ohem_pooled(logits4, targets, gate, *, block: int, num_hard_positive: int = -1,
                    num_hard_negative: int = -1, random: bool = False,
                    seed: int | None = None):
    """:func:`bce_ohem` over block-upsampled logits, exactly, at cell cost.
    logits4 ``[B, h, w]``; targets ``[B, h·block, w·block]`` binary; gate:
    pixel validity. Per-cell BCE takes two values (target 0 / target 1)."""
    logits4 = logits4.float()
    vals = torch.stack(
        [_bce_per_example(logits4, torch.full_like(logits4, t)) for t in (0.0, 1.0)], dim=-1)
    tpos = targets != 0
    pos_mask, neg_mask = gate & tpos, gate & ~tpos
    mining = not (num_hard_positive == -1 and num_hard_negative == -1)
    if mining and random:
        assert seed is not None
        pos_mask, neg_mask = _ohem_random_presample(
            pos_mask, neg_mask, num_hard_positive, num_hard_negative, seed)
    pos_counts = _block_sum(pos_mask.to(torch.int32), block)
    neg_counts = _block_sum(neg_mask.to(torch.int32), block)
    pos = _weighted_topk_sum(vals[..., 1], pos_counts, num_hard_positive)
    neg = _weighted_topk_sum(vals[..., 0], neg_counts, num_hard_negative)
    return _mean_of_selected(*pos, *neg)


def _masked_mean(losses, valid):
    return (all_sum(torch.where(valid, losses, 0.0).sum())
            / all_sum(valid.sum()).float().clamp(min=1.0))


def _ohem(losses, targets, valid, num_hard_positive, num_hard_negative, random, seed):
    pos_mask = valid & (targets != 0)
    neg_mask = valid & (targets == 0)
    if random:
        assert seed is not None, "ohem random sampling needs a seed"
        pos_mask, neg_mask = _ohem_random_presample(
            pos_mask, neg_mask, num_hard_positive, num_hard_negative, seed)
    pos = _masked_topk_sum(losses, pos_mask, num_hard_positive)
    neg = _masked_topk_sum(losses, neg_mask, num_hard_negative)
    return _mean_of_selected(*pos, *neg)


def cross_entropy_ohem(logits, targets, valid, *, num_hard_positive: int = -1,
                       num_hard_negative: int = -1, weight=None, random: bool = False,
                       seed: int | None = None):
    """CE with online hard example mining. logits ``[N, C]``, targets and
    valid ``[N]``."""
    losses = _ce_per_example(logits, targets, weight)
    valid = valid.bool()
    if num_hard_positive == -1 and num_hard_negative == -1:
        if weight is not None:
            # the mean of a weighted CE divides by the summed weights
            wsum = all_sum(torch.where(valid, _per_example_weight(targets, weight), 0.0).sum())
            return all_sum(torch.where(valid, losses, 0.0).sum()) / wsum.clamp(min=1e-12)
        return _masked_mean(losses, valid)
    return _ohem(losses, targets, valid, num_hard_positive, num_hard_negative, random, seed)


def _sampled_mean(losses, cat_masks, samples, seed):
    kept_list = _random_subsample_masks(cat_masks, samples, seed)
    total = sum(torch.where(kept, losses, 0.0).sum() for kept in kept_list)
    count = sum(kept.sum() for kept in kept_list)
    return all_sum(total) / all_sum(count).float().clamp(min=1.0)


def cross_entropy_random_sample(logits, targets, valid, *, sample_list=None, weight=None,
                                seed: int | None = None):
    """CE with per-category random sampling."""
    losses = _ce_per_example(logits, targets, weight)
    valid = valid.bool()
    if sample_list is None:
        return _masked_mean(losses, valid)
    assert seed is not None, "random sampling needs a seed"
    num_cats = len(sample_list)
    if num_cats == 2 and logits.shape[-1] >= 2:
        cat_masks = [valid & (targets == 0), valid & (targets != 0)]
    else:
        assert num_cats == logits.shape[-1], (
            f"sample_list length {num_cats} must be 2 or match the class "
            f"dimension {logits.shape[-1]}")
        cat_masks = [valid & (targets == i) for i in range(num_cats)]
    return _sampled_mean(losses, cat_masks, list(sample_list), seed)


def bce_ohem(logits, targets, valid, *, num_hard_positive: int = -1,
             num_hard_negative: int = -1, random: bool = False, seed: int | None = None):
    """Binary CE with OHEM, split by target."""
    losses = _bce_per_example(logits, targets)
    valid = valid.bool()
    if num_hard_positive == -1 and num_hard_negative == -1:
        return _masked_mean(losses, valid)
    return _ohem(losses, targets, valid, num_hard_positive, num_hard_negative, random, seed)


def bce_random_sample(logits, targets, valid, *, sample_list=None, seed: int | None = None):
    """Binary CE with random sampling split by prediction sign (category
    0 = logit <= 0, 1 = logit > 0). As in the reference, both categories
    use ``sample_list[0]``."""
    losses = _bce_per_example(logits, targets)
    valid = valid.bool()
    if sample_list is None:
        return _masked_mean(losses, valid)
    assert seed is not None
    samples = [sample_list[0], sample_list[0]]
    cat_masks = [valid & (logits <= 0), valid & (logits > 0)]
    return _sampled_mean(losses, cat_masks, samples, seed)
