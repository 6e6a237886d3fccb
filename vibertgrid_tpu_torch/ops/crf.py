"""Linear-chain CRF, batched (port of ``vibertgrid_tpu/ops/crf.py``).

The forward algorithm, the gold-path score and Viterbi decoding over
``feats [B, T, K]`` with per-sample ``lengths [B]``: one step of tensor
operations over the whole batch and tag dimension per time step (where the
JAX package scans), masked by the lengths, with nothing read back from the
device inside a loop.

Tag layout: ``K`` includes START = K−2 and STOP = K−1 after the field
classes. ``transitions[i, j]`` scores the move *to* i *from* j; the row to
START and the column from STOP are pinned to −1e4 at initialisation.
"""

from __future__ import annotations

import torch

from vibertgrid_tpu_torch.parallel.collectives import active, all_sum

NEG = -10000.0


def init_transitions(num_tags: int, *, device=None,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """Random-normal transitions with the START / STOP constraints."""
    t = torch.randn(num_tags, num_tags, device=device, generator=generator)
    t[num_tags - 2, :] = NEG  # never move to START
    t[:, num_tags - 1] = NEG  # never move from STOP
    return t


def _initial(feats: torch.Tensor) -> torch.Tensor:
    """``[B, K]`` scores before the first step: 0 at START, −1e4 elsewhere."""
    b, _, k = feats.shape
    init = feats.new_full((b, k), NEG, dtype=torch.float32)
    init[:, k - 2] = 0.0
    return init


def _active(feats: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """``[B, T]``: step t belongs to sample b's sequence."""
    return torch.arange(feats.shape[1], device=feats.device)[None, :] < lengths[:, None]


def _forward_logz(transitions, feats, lengths):
    """``[B]`` log partition function over each sample's first ``length`` steps."""
    alpha = _initial(feats)
    steps = zip(feats.float().unbind(1), _active(feats, lengths).unbind(1))
    for feat, active in steps:
        # next[i] = logsumexp_j alpha[j] + trans[i, j] + feat[i]
        scores = alpha[:, None, :] + transitions + feat[:, :, None]
        alpha = torch.where(active[:, None], torch.logsumexp(scores, dim=2), alpha)
    return torch.logsumexp(alpha + transitions[-1], dim=1)


def _gold_score(transitions, feats, tags, lengths):
    """``[B]`` score of the gold path, masked by length."""
    b, _, k = feats.shape
    tags = tags.long()
    prev = torch.cat([tags.new_full((b, 1), k - 2), tags[:, :-1]], dim=1)
    steps = transitions[tags, prev] + torch.gather(feats.float(), 2, tags[..., None])[..., 0]
    score = torch.where(_active(feats, lengths), steps, 0.0).sum(dim=1)
    last = torch.gather(tags, 1, (lengths.long() - 1).clamp(min=0)[:, None])[:, 0]
    return score + transitions[-1][last]


def crf_nll_batch(transitions, feats, tags, lengths) -> torch.Tensor:
    """Mean over the batch of ``(logZ − gold) / max(length, 1)`` (the
    global batch's in a data-parallel step). ``feats [B, T, K]``,
    ``tags [B, T]`` int, ``lengths [B]`` int."""
    logz = _forward_logz(transitions, feats, lengths)
    gold = _gold_score(transitions, feats, tags, lengths)
    nll = (logz - gold) / lengths.float().clamp(min=1.0)
    if active():
        return all_sum(nll.sum()) / all_sum(nll.new_tensor(float(nll.numel())))
    return nll.mean()


def crf_decode_batch(transitions, feats, lengths):
    """Viterbi decode → ``(path_score [B], tags [B, T] int64)``. Positions at
    and past ``length`` hold the last real tag; consumers slice by length."""
    b, _, k = feats.shape
    alpha = _initial(feats)
    identity = torch.arange(k, device=feats.device).expand(b, k)
    backpointers = []
    steps = zip(feats.float().unbind(1), _active(feats, lengths).unbind(1))
    for feat, active in steps:
        best_score, best_prev = (alpha[:, None, :] + transitions).max(dim=2)  # over prev
        active = active[:, None]
        alpha = torch.where(active, best_score + feat, alpha)
        backpointers.append(torch.where(active, best_prev, identity))  # identity past length
    path_score, tag = (alpha + transitions[-1]).max(dim=1)
    path = [tag]
    for bp in reversed(backpointers[1:]):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        path.append(tag)
    return path_score, torch.stack(path[::-1], dim=1)
