"""Late fusion and the three field-type heads with their losses (port of
``vibertgrid_tpu/models/heads.py``).

- :class:`FieldTypeClassification`: the two-stage design, a binary pos/neg
  gate trained with randomly sampled BCE, then per-class binary classifiers
  trained with BCE-OHEM on the predicted positives (a validity mask, so the
  shapes stay static).
- :class:`SimplifiedFieldTypeClassification`: one multi-class classifier plus
  an auxiliary 2-way pos/neg classifier, both CE-OHEM.
- :class:`CRFFieldTypeClassification`: an emission MLP and a linear-chain CRF
  (:mod:`vibertgrid_tpu_torch.ops.crf`).

The first two work on flattened ``[N = B·S]`` segment rows with a validity
mask; the CRF head keeps ``[B, S]`` for its sequence model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vibertgrid_tpu_torch.models.layers import conv, conv2d, dense, linear
from vibertgrid_tpu_torch.models.norm import MaskedBatchNorm
from vibertgrid_tpu_torch.ops import crf
from vibertgrid_tpu_torch.ops.losses import bce_ohem, bce_random_sample, cross_entropy_ohem
from vibertgrid_tpu_torch.parallel.collectives import all_max


class MLPClassifier(nn.Module):
    """'single': one linear layer; 'multi': linear → ReLU → linear with a
    half-width hidden layer."""

    def __init__(self, in_f: int, out_f: int, layer_mode: str = "single", *,
                 dtype, device, generator):
        super().__init__()
        self.dtype = dtype
        self.layer_mode = layer_mode
        kw = dict(device=device, generator=generator)
        if layer_mode == "multi":
            self.hidden = linear(in_f, in_f // 2, **kw)
            in_f //= 2
        self.out = linear(in_f, out_f, **kw)

    def forward(self, x):
        if self.layer_mode == "multi":
            x = F.relu(dense(x, self.hidden, self.dtype))
        return dense(x, self.out, self.dtype)


class ROIEmbedding(nn.Module):
    """RoI features ``[N, 7, 7, C]`` (NHWC) → 1024-d: two (3×3 conv, masked
    BatchNorm, ReLU), then a flatten in NHWC order and a linear layer."""

    def __init__(self, channels: int, roi_shape: int, *, dtype, device, generator):
        super().__init__()
        self.dtype = dtype
        kw = dict(device=device, generator=generator)
        self.conv1 = conv2d(channels, channels, 3, **kw)
        self.bn1 = MaskedBatchNorm(channels, dtype=dtype, device=device)
        self.conv2 = conv2d(channels, channels, 3, **kw)
        self.bn2 = MaskedBatchNorm(channels, dtype=dtype, device=device)
        self.linear = linear(roi_shape * roi_shape * channels, 1024, **kw)

    def forward(self, rois, valid, train: bool = False):
        x = rois.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(self.bn1(conv(x, self.conv1, self.dtype), valid, train))
        x = F.relu(self.bn2(conv(x, self.conv2, self.dtype), valid, train))
        # the linear weight was laid out for an NHWC flatten
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return dense(x, self.linear, self.dtype)


class LateFusion(nn.Module):
    """concat(RoI embedding 1024, segment BERT embedding) → linear 1024."""

    def __init__(self, channels: int, roi_shape: int, text_dim: int, *, dtype,
                 device, generator):
        super().__init__()
        self.dtype = dtype
        kw = dict(device=device, generator=generator)
        self.roi_embedding = ROIEmbedding(channels, roi_shape, dtype=dtype, **kw)
        self.fuse = linear(1024 + text_dim, 1024, **kw)

    def forward(self, rois, bert_embeddings, valid, train: bool = False):
        roi_emb = self.roi_embedding(rois, valid, train)
        fuse = torch.cat([roi_emb, bert_embeddings.to(roi_emb.dtype)], dim=-1)
        return dense(fuse, self.fuse, self.dtype)


class FieldTypeClassification(nn.Module):
    """Two-stage head: a pos/neg gate and C−1 per-class binary classifiers.

    ``forward(fuse, segment_classes, valid, compute_loss, seeds)`` →
    ``(loss, class_pred [N, C])``. Column 0 of ``class_pred`` is the gate's
    positive probability under ``decision="reference"`` (the reference's
    rule: the argmax returns background whenever the gate's confidence
    reaches the class's) and its negative probability under ``"gated"``; the
    class columns are the class sigmoids where the gate predicts positive
    and 0 elsewhere. The loss is a randomly sampled BCE on the gate plus, if
    anything is predicted positive, the sum of the per-class BCE-OHEM losses
    over the predicted positives. ``seeds``: C ints, one for the gate's
    random sample and one per class for the OHEM pre-sampling (read only
    when ``ohem_random``)."""

    def __init__(self, in_f: int, num_classes: int, *, layer_mode: str = "single",
                 num_hard_positive_1: int = -1, num_hard_negative_1: int = -1,
                 num_hard_positive_2: int = -1, num_hard_negative_2: int = -1,
                 ohem_random: bool = False, decision: str = "reference", dtype, device,
                 generator):
        super().__init__()
        self.num_classes = num_classes
        self.sample_list = [num_hard_negative_1, num_hard_positive_1]  # [neg, pos]
        self.ohem = dict(num_hard_positive=num_hard_positive_2,
                         num_hard_negative=num_hard_negative_2, random=ohem_random)
        self.decision = decision
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.pos_neg_net = MLPClassifier(in_f, 1, layer_mode, **kw)
        self.category_net = MLPClassifier(in_f, num_classes - 1, layer_mode, **kw)

    def forward(self, fuse_embeddings, segment_classes=None, valid=None, *,
                compute_loss: bool = False, seeds=None):
        pos_neg_logit = self.pos_neg_net(fuse_embeddings)[:, 0]
        class_logits = self.category_net(fuse_embeddings)  # [N, C-1]
        gate_sig = torch.sigmoid(pos_neg_logit.float())
        pred_pos = gate_sig >= 0.5
        col0 = gate_sig if self.decision == "reference" else 1.0 - gate_sig
        class_sig = torch.where(pred_pos[:, None], torch.sigmoid(class_logits.float()), 0.0)
        class_pred = torch.cat([col0[:, None], class_sig], dim=1)  # [N, C]
        if not compute_loss:
            return None, class_pred
        if seeds is None:
            seeds = (0,) * self.num_classes
        loss1 = bce_random_sample(pos_neg_logit, (segment_classes > 0).float(), valid,
                                  sample_list=self.sample_list, seed=seeds[0])
        gated = valid.bool() & pred_pos
        loss2 = 0.0
        for ci in range(self.num_classes - 1):
            loss2 = loss2 + bce_ohem(class_logits[:, ci], (segment_classes == ci + 1).float(),
                                     gated, seed=seeds[1 + ci], **self.ohem)
        # with nothing predicted positive the reference skips the class losses
        # (anywhere in the global batch, in a data-parallel step)
        return loss1 + all_max(gated.any().float()) * loss2, class_pred


class SimplifiedFieldTypeClassification(nn.Module):
    """Multi-class classifier plus the auxiliary pos/neg classifier.

    ``forward(fuse, segment_classes, valid, compute_loss, seeds)`` →
    ``(loss, class_pred)``: the class softmax, and with ``compute_loss`` two
    OHEM cross entropies (pos/neg on ``class > 0``, then the classes), summed
    when ``add_pos_neg``. ``seeds``: two ints for the random pre-sampling,
    read only when ``ohem_random``.

    Both MLPs are always two-layer ("multi"), whatever ``layer_mode`` says:
    the reference compares against the typo "sigle", so its shipped
    "single" configs build the two-layer head, and the published numbers
    come from that architecture."""

    def __init__(self, in_f: int, num_classes: int, *, num_hard_positive_1: int = -1,
                 num_hard_negative_1: int = -1, num_hard_positive_2: int = -1,
                 num_hard_negative_2: int = -1, ohem_random: bool = False,
                 add_pos_neg: bool = True, loss_weights=None, dtype, device, generator):
        super().__init__()
        self.ohem_1 = dict(num_hard_positive=num_hard_positive_1,
                           num_hard_negative=num_hard_negative_1, random=ohem_random)
        self.ohem_2 = dict(num_hard_positive=num_hard_positive_2,
                           num_hard_negative=num_hard_negative_2, random=ohem_random,
                           weight=loss_weights)
        self.add_pos_neg = add_pos_neg
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.pos_neg_net = MLPClassifier(in_f, 2, "multi", **kw)
        self.category_net = MLPClassifier(in_f, num_classes, "multi", **kw)

    def forward(self, fuse_embeddings, segment_classes=None, valid=None, *,
                compute_loss: bool = False, seeds=(0, 0)):
        class_logits = self.category_net(fuse_embeddings)
        class_pred = torch.softmax(class_logits.float(), dim=-1)
        if not compute_loss:
            return None, class_pred
        pos_neg_logits = self.pos_neg_net(fuse_embeddings)
        loss1 = cross_entropy_ohem(
            pos_neg_logits, (segment_classes > 0).long(), valid, seed=seeds[0], **self.ohem_1)
        loss2 = cross_entropy_ohem(
            class_logits, segment_classes, valid, seed=seeds[1], **self.ohem_2)
        return (loss1 + loss2 if self.add_pos_neg else loss2), class_pred


class CRFFieldTypeClassification(nn.Module):
    """Emission MLP and linear-chain CRF over ``fuse [B, S, D]`` with
    per-sample ``lengths [B]``; ``num_classes`` excludes START and STOP.

    ``forward(fuse, segment_classes, lengths, train, compute_loss)`` →
    ``(loss, pred)``: the mean NLL and the emissions ``[B, S, K]`` when
    ``train and compute_loss``; else the Viterbi tags ``[B, S]`` (int64) and,
    with ``compute_loss``, the mean path score as the reference's eval mode
    reports it. It draws no seed."""

    def __init__(self, in_f: int, num_classes: int, *, layer_mode: str = "single", dtype,
                 device, generator):
        super().__init__()
        num_tags = num_classes + 2
        self.category_net = MLPClassifier(in_f, num_tags, layer_mode, dtype=dtype,
                                          device=device, generator=generator)
        self.transitions = nn.Parameter(
            crf.init_transitions(num_tags, device=device, generator=generator))

    def forward(self, fuse_embeddings, segment_classes=None, lengths=None, *,
                train: bool = False, compute_loss: bool = False):
        feats = self.category_net(fuse_embeddings).float()
        if compute_loss and train:
            return crf.crf_nll_batch(self.transitions, feats, segment_classes, lengths), feats
        scores, paths = crf.crf_decode_batch(self.transitions, feats, lengths)
        return (scores.mean() if compute_loss else None), paths
