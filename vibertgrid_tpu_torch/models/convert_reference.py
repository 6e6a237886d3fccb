"""Load a trained ViBERTgrid-PyTorch checkpoint into the port's model (port
of ``vibertgrid_tpu/models/convert_reference.py``).

The migration path for users of the reference implementation: a torch
``state_dict`` saved by ``ZeningLin/ViBERTgrid-PyTorch`` (the ``"model"``
entry of its checkpoint dict; an optional DDP ``module.`` prefix is
stripped) maps onto the port's parameters and BatchNorm statistics for all
three classifier modes. The port names its modules after the JAX tree and
keeps torch layouts, so conv OIHW and linear ``[out, in]`` weights copy as
they are; only the names change, and:

- the RoI-embedding linear consumed a CHW flatten of the 7×7 RoI map, the
  port's consumes HWC: its input axis is permuted;
- the full head's per-class ``ss_binary_classifier_{i}`` 1×1 convs and
  ``category_classification_net_{i}`` single layers stack, in class order,
  into ``binary_bank`` and ``category_net.out``;
- ``bert_model.*`` goes through
  :func:`vibertgrid_tpu_torch.models.bert.load_hf_weights` (the alias
  ``BERTgrid_generator.model.*`` and the unused ``pooler`` are ignored);
- ``num_batches_tracked`` counters have no counterpart and are dropped.

Name map (reference → port): ``backbone.conv_1.{0,1}`` → ``stem_conv`` /
``stem_bn``; ``conv_2_x.{i}`` → ``stage2_block{i}``; ``conv_3_x.block_1`` →
``stage3_block0``, ``conv_3_x.early_fusion`` → ``early_fusion``,
``conv_3_x.layers.{i}`` → ``stage3_block{i+1}``; ``conv_4_x`` / ``conv_5_x``
→ ``stage4/5_block{i}``; block leaves ``conv_1/bn_1/conv_2/bn_2/
conv_shortcut.{0,1}`` (D variant ``.{1,2}``) → ``conv1/bn1/conv2/bn2/
shortcut_conv/shortcut_bn``; ``conv_6_x/skip_k/merge_k/fuse`` → ``conv6/
skip{k}/merge{k}/fuse``; ``late_fusion_net.ROI_embedding_net`` →
``late_fusion.roi_embedding``, ``late_fusion_net.fuse_embedding_net.linear``
→ ``late_fusion.fuse``; the segmentation encoder's ``conv_3_1`` /
``conv_3_2`` → ``mask_proj`` / ``class_proj``; the simplified head's
``linear_1/linear_2`` → ``hidden/out``; ``crf_layer.transitions`` →
``transitions``.

Scope, as in the JAX package: the from-scratch ``resnet_18/34_fpn`` and
``resnet_18/34_D_fpn`` trunks; ``*_pretrained`` checkpoints (torchvision
layout, ``backbone.resnet.*``) and full-head checkpoints with
``layer_mode='multi'`` raise ``ValueError``.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from vibertgrid_tpu_torch.models.bert import load_hf_weights


def _t(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return torch.from_numpy(np.array(v))


def _roi_linear(w, h: int = 7, wdt: int = 7, c: int = 256) -> torch.Tensor:
    """The RoI-embedding linear ``[out, c·h·w]`` in (c, h, w) input order →
    (h, w, c) order, the port's flatten."""
    w = _t(w)
    return w.reshape(w.shape[0], c, h, wdt).permute(0, 2, 3, 1).reshape(w.shape[0], -1)


def _indices(sd: dict, prefix: str) -> list[int]:
    """Sorted distinct integer suffixes following ``prefix`` in key names."""
    pattern = re.compile(rf"{re.escape(prefix)}(\d+)\.")
    return sorted({int(m.group(1)) for k in sd if (m := pattern.match(k))})


def load_reference_checkpoint(model: nn.Module, state_dict: dict) -> None:
    """Copy a reference ``state_dict`` into ``model`` (a
    :class:`~vibertgrid_tpu_torch.models.vibertgrid.ViBERTgridNet`) in place.
    Raises ``KeyError`` on a missing source key, ``ValueError`` on an
    unsupported architecture or a shape mismatch."""
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in state_dict.items()}
    if any(k.startswith("backbone.resnet.") for k in sd):
        raise ValueError(
            "torchvision-pretrained trunk checkpoints use the torchvision module layout; "
            "load them with models.resnet_fpn.load_torchvision_resnet")
    own = model.state_dict()
    new: dict[str, torch.Tensor] = {}

    def put(name: str, value) -> None:
        value = _t(value)
        if value.shape != own[name].shape:
            raise ValueError(f"{name}: checkpoint shape {tuple(value.shape)}, "
                             f"model {tuple(own[name].shape)}")
        new[name] = value

    def weight_bias(src: str, dst: str) -> None:
        put(f"{dst}.weight", sd[f"{src}.weight"])
        put(f"{dst}.bias", sd[f"{src}.bias"])

    def conv_bn(src_conv: str, src_bn: str, dst_conv: str, dst_bn: str) -> None:
        put(f"{dst_conv}.weight", sd[f"{src_conv}.weight"])
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            put(f"{dst_bn}.{leaf}", sd[f"{src_bn}.{leaf}"])

    # ---- text encoder (the HF ingester; keys live at bert_model.*) ----
    load_hf_weights(model.bert_model, {k[len("bert_model."):]: v for k, v in sd.items()
                                       if k.startswith("bert_model.") and ".pooler." not in k})

    # ---- backbone ----
    b = d = "backbone"
    conv_bn(f"{b}.conv_1.0", f"{b}.conv_1.1", f"{d}.stem_conv", f"{d}.stem_bn")

    def block(src: str, dst: str) -> None:
        conv_bn(f"{src}.conv_1", f"{src}.bn_1", f"{dst}.conv1", f"{dst}.bn1")
        conv_bn(f"{src}.conv_2", f"{src}.bn_2", f"{dst}.conv2", f"{dst}.bn2")
        # plain BasicBlock: Sequential(conv, bn); D variant: (AvgPool, conv, bn)
        for first in (0, 1):
            if f"{src}.conv_shortcut.{first}.weight" in sd:
                conv_bn(f"{src}.conv_shortcut.{first}", f"{src}.conv_shortcut.{first + 1}",
                        f"{dst}.shortcut_conv", f"{dst}.shortcut_bn")
                break

    for i in _indices(sd, f"{b}.conv_2_x."):
        block(f"{b}.conv_2_x.{i}", f"{d}.stage2_block{i}")
    block(f"{b}.conv_3_x.block_1", f"{d}.stage3_block0")
    put(f"{d}.early_fusion.weight", sd[f"{b}.conv_3_x.early_fusion.weight"])
    if f"{b}.conv_3_x.early_fusion.bias" in sd:
        put(f"{d}.early_fusion.bias", sd[f"{b}.conv_3_x.early_fusion.bias"])
    for i in _indices(sd, f"{b}.conv_3_x.layers."):
        block(f"{b}.conv_3_x.layers.{i}", f"{d}.stage3_block{i + 1}")
    for stage in (4, 5):
        for i in _indices(sd, f"{b}.conv_{stage}_x."):
            block(f"{b}.conv_{stage}_x.{i}", f"{d}.stage{stage}_block{i}")
    put(f"{d}.conv6.weight", sd[f"{b}.conv_6_x.weight"])
    for k in (1, 2, 3):
        put(f"{d}.skip{k}.weight", sd[f"{b}.skip_{k}.weight"])
        put(f"{d}.merge{k}.weight", sd[f"{b}.merge_{k}.weight"])
    put(f"{d}.fuse.weight", sd[f"{b}.fuse.weight"])

    # ---- late fusion ----
    lf, d = "late_fusion_net.ROI_embedding_net", "late_fusion.roi_embedding"
    conv_bn(f"{lf}.conv_1", f"{lf}.bn_1", f"{d}.conv1", f"{d}.bn1")
    conv_bn(f"{lf}.conv_2", f"{lf}.bn_2", f"{d}.conv2", f"{d}.bn2")
    put(f"{d}.linear.weight", _roi_linear(sd[f"{lf}.linear.weight"]))
    put(f"{d}.linear.bias", sd[f"{lf}.linear.bias"])
    weight_bias("late_fusion_net.fuse_embedding_net.linear", "late_fusion.fuse")

    # ---- aux segmentation head (absent in inference-mode checkpoints) ----
    sseg = d = "semantic_segmentation_head"
    enc = (f"{sseg}.semantic_segmentation_encoder"
           if f"{sseg}.semantic_segmentation_encoder.conv_1.weight" in sd
           else f"{sseg}.ss_encoder")
    if f"{enc}.conv_1.weight" in sd:
        conv_bn(f"{enc}.conv_1", f"{enc}.bn_1", f"{d}.encoder.conv1", f"{d}.encoder.bn1")
        conv_bn(f"{enc}.conv_2", f"{enc}.bn_2", f"{d}.encoder.conv2", f"{d}.encoder.bn2")
        weight_bias(f"{enc}.conv_3_1", f"{d}.encoder.mask_proj")
        weight_bias(f"{enc}.conv_3_2", f"{d}.encoder.class_proj")
        bins = _indices(sd, f"{sseg}.ss_binary_classifier_")
        if bins:
            src = [f"{sseg}.ss_binary_classifier_{i}.conv1" for i in bins]
            put(f"{d}.binary_bank.weight", torch.cat([_t(sd[f"{s}.weight"]) for s in src]))
            put(f"{d}.binary_bank.bias", torch.cat([_t(sd[f"{s}.bias"]) for s in src]))

    # ---- field-type head ----
    fh, d = "field_type_classification_head", "field_type_head"
    if f"{fh}.crf_layer.transitions" in sd:  # crf mode
        cat = f"{fh}.category_classification_net"
        if f"{cat}.linear.weight" in sd:  # single layer
            weight_bias(f"{cat}.linear", f"{d}.category_net.out")
        else:  # multi
            weight_bias(f"{cat}.linear_1", f"{d}.category_net.hidden")
            weight_bias(f"{cat}.linear_2", f"{d}.category_net.out")
        put(f"{d}.transitions", sd[f"{fh}.crf_layer.transitions"])
    elif f"{fh}.category_classification_net_0.layer.linear.weight" in sd:
        # full (two-stage) mode: per-class single layers stack into rows
        if f"{fh}.category_classification_net_0.layer.linear_1.weight" in sd:
            raise ValueError(
                "full-mode checkpoints with layer_mode='multi' use per-class hidden layers "
                "with no equivalent here; retrain or use layer_mode='single'")
        src = [f"{fh}.category_classification_net_{i}.layer.linear"
               for i in _indices(sd, f"{fh}.category_classification_net_")]
        put(f"{d}.category_net.out.weight", torch.cat([_t(sd[f"{s}.weight"]) for s in src]))
        put(f"{d}.category_net.out.bias", torch.cat([_t(sd[f"{s}.bias"]) for s in src]))
        pn = f"{fh}.pos_neg_classification_net.layer"
        if f"{pn}.linear.weight" in sd:
            weight_bias(f"{pn}.linear", f"{d}.pos_neg_net.out")
        elif f"{pn}.linear_1.weight" in sd:
            raise ValueError("full-mode checkpoints with layer_mode='multi' are not mapped")
    elif f"{fh}.category_classification_net.linear_1.weight" in sd:
        # simplified mode: always the two-layer MLP
        for src, dst in (("pos_neg_classification_net", "pos_neg_net"),
                         ("category_classification_net", "category_net")):
            weight_bias(f"{fh}.{src}.linear_1", f"{d}.{dst}.hidden")
            weight_bias(f"{fh}.{src}.linear_2", f"{d}.{dst}.out")
    else:
        raise ValueError(
            "could not identify the classifier mode from the state dict (no crf_layer, "
            "category_classification_net_0, or category_classification_net.linear_1 keys)")

    model.load_state_dict(new, strict=False)
