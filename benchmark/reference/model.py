"""The plain reference of ViBERTgrid's training forward, written from the
model's definition (arXiv:2105.11672 and its reference implementation's
layers) in plain PyTorch, fp32: functions over a dict of leaf tensors named
as the checkpoint both sides load, with no module of the port. This file
is the trunk; the text encoder is a file of ``encoders/``.

    tokens ─ text encoder ─ segment mean ──────────┐
                                                   ├─ BERTgrid ─ early-fused
    image ─────────────────────────────────────────┘   ResNet-FPN ─ P_fuse
    P_fuse ─ RoIAlign ─ late fusion with the segment embeddings ─ field head
    P_fuse ─ auxiliary segmentation head (training loss)

What both sides take from the configuration rather than from each other:

- dropout (rate 0.1 on the embeddings, the attention probabilities, the
  attention output and the FFN output) keeps an element where
  ``splitmix32(index, seed)`` reaches ``rate·2³²``; the index of a hidden
  state is its row-major flat index, that of an attention probability
  ``row·Tp + col`` (``Tp`` = the window length rounded up to 128) under the
  seed ``seed + window·H + head``. The seeds of a step come from
  :func:`step_seeds` in call order: the text encoder's (RoBERTa's: the
  embeddings; each layer's attention probabilities, attention output and
  FFN output); the segmentation head's sample and one a class; the field
  head's sample and one a class;
- a random subsample of ``k`` elements of a category keeps the ``k``
  largest ``splitmix32(flat index, seed)`` among its members;
- online hard example mining (OHEM) sums the ``k`` largest losses of each
  side; where the ``k``-th value is tied, the tied elements share what is
  left of ``k`` equally;
- the auxiliary head's losses are taken per pixel of its logits upsampled
  4x (nearest), the labels rasterised from the boxes at stride 1 (the last
  box wins where boxes overlap);
- RoIAlign is torchvision's (``aligned=False``, adaptive sampling).
"""

from __future__ import annotations

import importlib

import torch
import torch.nn.functional as F

M32 = 0xFFFFFFFF
DROPOUT = 0.1         # hidden and attention dropout of BERT-base and RoBERTa-base
BN_EPS = 1e-5


# ------------------------------------------------------------------ the seeds

class step_seeds:
    """The seeds of train step ``step`` of a run seeded with ``seed``, in call
    order: int32 values drawn from a CPU generator seeded with
    ``(seed mod 2³²)·2³² + step``."""

    def __init__(self, seed: int, step: int):
        self._gen = torch.Generator(device="cpu").manual_seed(((seed & M32) << 32) | (step & M32))

    def next(self) -> int:
        return int(torch.randint(0, 2**31 - 1, (), generator=self._gen))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x·c mod 2³²`` of int64 values in ``[0, 2³²)``, without overflow."""
    lo, hi = x & 0xFFFF, x >> 16
    return ((lo * c) + (((hi * c) & 0xFFFF) << 16)) & M32


def splitmix32(counter: torch.Tensor, seed) -> torch.Tensor:
    """The splitmix32 finalizer of ``counter ^ (seed·0x9E3779B9)``, int64 in
    ``[0, 2³²)``; ``seed`` an int or an int64 tensor that broadcasts."""
    if isinstance(seed, torch.Tensor):
        mixed = _mul32(seed & M32, 0x9E3779B9)
    else:
        mixed = ((int(seed) & M32) * 0x9E3779B9) & M32
    x = (counter.to(torch.int64) & M32) ^ mixed
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _keep(bits: torch.Tensor, rate: float) -> torch.Tensor:
    return bits >= int(rate * 2.0**32)


def dropout(x: torch.Tensor, seed: int, rate: float = DROPOUT) -> torch.Tensor:
    keep = _keep(splitmix32(torch.arange(x.numel(), device=x.device), seed), rate)
    return x * keep.reshape(x.shape) / (1.0 - rate)


def attention_keep(bw: int, heads: int, t: int, seed: int, device) -> torch.Tensor:
    tp = -(-t // 128) * 128
    rows = torch.arange(t, device=device, dtype=torch.int64)
    index = rows[:, None] * tp + rows[None, :]
    head_seed = (seed + torch.arange(bw * heads, device=device, dtype=torch.int64)) & M32
    bits = splitmix32(index[None], head_seed[:, None, None])
    return _keep(bits, DROPOUT).reshape(bw, heads, t, t)


def subsample(categories: list, limits: list, seed: int) -> list:
    """Each category (a bool mask, all of one shape) cut to its ``limit``
    members of the largest keys ``splitmix32(flat index, seed)``; a
    category with fewer members is kept whole."""
    shape = categories[0].shape
    bits = splitmix32(torch.arange(categories[0].numel(), device=categories[0].device), seed)
    out = []
    for cat, limit in zip(categories, limits):
        flat = cat.reshape(-1)
        n = int(flat.sum())
        if n <= limit:
            out.append(cat)
            continue
        kth = torch.topk(torch.where(flat, bits, -1), limit).values[-1]
        out.append((flat & (bits >= kth)).reshape(shape))
    return out


def top_sum(losses: torch.Tensor, mask: torch.Tensor, k: int):
    """``(sum, count)`` of the ``min(k, n)`` largest masked losses, ties at
    the ``k``-th value sharing the remainder equally."""
    v = losses[mask]
    kk = min(k, v.numel())
    if kk == 0:
        return losses.sum() * 0.0, 0
    t = torch.topk(v.detach(), kk).values[-1]
    above, tied = v > t, v == t
    share = (kk - int(above.sum())) / int(tied.sum())
    return v[above].sum() + share * v[tied].sum(), kk


def ohem(losses, pos, neg, k_pos: int, k_neg: int):
    sp, np_ = top_sum(losses, pos, k_pos)
    sn, nn_ = top_sum(losses, neg, k_neg)
    return (sp + sn) / max(np_ + nn_, 1)


def bce(logits, targets):
    return F.binary_cross_entropy_with_logits(logits, targets.float(), reduction="none")


# ------------------------------------------------- layers the encoders share

def _linear(P, name, x):
    return F.linear(x, P[name + ".weight"], P.get(name + ".bias"))


def _ln(P, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], P[name + ".weight"], P[name + ".bias"], eps)


def segment_mean(tok, seg_ids, token_mask, s: int):
    """The mean of each segment's valid token embeddings, 0 for a segment
    without one: ``[B, T, D]`` → ``[B, S, D]``."""
    b, t, d = tok.shape
    valid = token_mask.bool()
    index = (seg_ids.long() + s * torch.arange(b, device=tok.device)[:, None])[valid]
    sums = tok.new_zeros((b * s, d)).index_add(0, index, tok[valid])
    counts = torch.bincount(index, minlength=b * s).clamp(min=1)
    return (sums / counts[:, None]).reshape(b, s, d)


def winners(boxes, box_mask, h: int, w: int, stride: int):
    """``[B, h, w]`` int64: 1 + the index of the last valid box covering each
    cell of a stride-``stride`` grid (box corners floor-divided), 0 where
    none does."""
    c = torch.div(boxes.long(), stride, rounding_mode="floor")
    rows = torch.arange(h, device=boxes.device)
    cols = torch.arange(w, device=boxes.device)
    out = torch.zeros((boxes.shape[0], h, w), dtype=torch.int64, device=boxes.device)
    for s in range(boxes.shape[1]):
        x0, y0, x1, y1 = (c[:, s, j, None] for j in range(4))
        inside = (((rows >= y0) & (rows < y1))[:, :, None] & ((cols >= x0) & (cols < x1))[:, None]
                  & box_mask[:, s, None, None].bool())
        out = torch.where(inside, s + 1, out)
    return out


# --------------------------------------------------------------- the backbone

def _conv(P, name, x, stride=1):
    wt = P[name + ".weight"]
    return F.conv2d(x, wt, P.get(name + ".bias"), stride, wt.shape[-1] // 2)


def _bn(P, name, x):
    """Training BatchNorm: the batch's statistics (biased variance)."""
    return F.batch_norm(x, None, None, P[name + ".weight"], P[name + ".bias"], True, 0.0, BN_EPS)


def _block(P, name, x, downsample: bool, d_variant: bool):
    h = F.relu(_bn(P, name + ".bn1", _conv(P, name + ".conv1", x, 2 if downsample else 1)))
    h = _bn(P, name + ".bn2", _conv(P, name + ".conv2", h))
    if downsample:
        sc = F.avg_pool2d(x, 2, 2) if d_variant else x
        x = _bn(P, name + ".shortcut_bn", _conv(P, name + ".shortcut_conv", sc,
                                                1 if d_variant else 2))
    return F.relu(h + x)


def _up(x, k: int):
    return x if k == 1 else F.interpolate(x, scale_factor=k, mode="nearest")


def backbone(P, images, grid, blocks, d_variant: bool):
    """ResNet-FPN with BERTgrid early fusion after stage 3's first block:
    ``images [B, H, W, 3]``, ``grid [B, H/8, W/8, D]`` → P_fuse
    ``[B, 256, H/4, W/4]``."""
    g = "backbone."
    x = images.permute(0, 3, 1, 2)
    x = F.max_pool2d(F.relu(_bn(P, g + "stem_bn", _conv(P, g + "stem_conv", x, 2))), 3, 2, 1)
    feats = []
    for k, (stage, n) in enumerate(zip(("stage2", "stage3", "stage4", "stage5"), blocks)):
        for i in range(n):
            x = _block(P, f"{g}{stage}_block{i}", x, k > 0 and i == 0, d_variant)
            if stage == "stage3" and i == 0:
                x = _conv(P, g + "early_fusion", torch.cat([x, grid.permute(0, 3, 1, 2)], 1))
        feats.append(x)
    x1, x2, x3, x5 = feats
    p5 = _conv(P, g + "conv6", x5)
    p4 = _conv(P, g + "merge1", _up(p5, 2) + _conv(P, g + "skip1", x3))
    p3 = _conv(P, g + "merge2", _up(p4, 2) + _conv(P, g + "skip2", x2))
    p2 = _conv(P, g + "merge3", _up(p3, 2) + _conv(P, g + "skip3", x1))
    return _conv(P, g + "fuse", torch.cat([_up(p5, 8), _up(p4, 4), _up(p3, 2), p2], 1))


# --------------------------------------------------------------- the heads

def _axis_weights(start, size_bin, grid, length: int):
    """torchvision's bilinear taps along one axis, summed over a bin's
    samples: ``[N, P, length]``. ``start [N, P]`` bin starts, ``size_bin
    [N]``, ``grid [N]`` samples a bin."""
    n, p = start.shape
    w = start.new_zeros((n, p, length))
    gf = grid.to(start.dtype)
    for i in range(int(grid.max())):
        c = start + (i + 0.5) * size_bin[:, None] / gf[:, None]
        use = (i < grid)[:, None] & (c >= -1.0) & (c <= length)
        c = c.clamp(min=0.0)
        low = c.floor().long()
        edge = low >= length - 1
        low = torch.where(edge, length - 1, low)
        high = torch.where(edge, length - 1, low + 1)
        frac = torch.where(edge, 0.0, c - low.to(c.dtype))
        w.scatter_add_(2, low[..., None], ((1 - frac) * use)[..., None])
        w.scatter_add_(2, high[..., None], (frac * use)[..., None])
    return w


def roi_align(features, boxes, box_mask, out: int = 7, scale: float = 0.25):
    """torchvision ``roi_align(aligned=False, sampling_ratio=-1)`` of
    ``features [B, C, Hf, Wf]`` over the boxes → ``[B·S, C, out, out]``;
    invalid boxes give zeros."""
    b, c, hf, wf = features.shape
    s = boxes.shape[1]
    box = boxes.reshape(b * s, 4).to(features.dtype) * scale
    x0, y0, x1, y1 = box.unbind(-1)
    pooled = torch.full_like(x0, float(out))
    bin_w = (x1 - x0).clamp(min=1.0) / pooled
    bin_h = (y1 - y0).clamp(min=1.0) / pooled
    gw, gh = torch.ceil(bin_w).long().clamp(min=1), torch.ceil(bin_h).long().clamp(min=1)
    r = torch.arange(out, device=features.device, dtype=features.dtype)
    wy = _axis_weights(y0[:, None] + r * bin_h[:, None], bin_h, gh, hf)
    wx = _axis_weights(x0[:, None] + r * bin_w[:, None], bin_w, gw, wf)
    wy = wy * (box_mask.reshape(-1).to(wy.dtype) / (gh * gw).to(wy.dtype))[:, None, None]
    rows = []
    for i in range(b):
        sl = slice(i * s, (i + 1) * s)
        fy = torch.einsum("nph,chw->npcw", wy[sl], features[i])
        rows.append(torch.einsum("nqw,npcw->ncpq", wx[sl], fy))
    return torch.cat(rows)


def _masked_bn(P, name, x, valid):
    m = valid.to(x.dtype)[:, None, None, None]
    denom = (m.sum() * x.shape[2] * x.shape[3]).clamp(min=1.0)
    mean = (x * m).sum((0, 2, 3)) / denom
    var = (((x - mean[None, :, None, None]) * m) ** 2).sum((0, 2, 3)) / denom
    y = (x - mean[None, :, None, None]) / torch.sqrt(var + BN_EPS)[None, :, None, None]
    return y * P[name + ".weight"][None, :, None, None] + P[name + ".bias"][None, :, None, None]


def late_fusion(P, rois, seg_emb, valid):
    r = "late_fusion.roi_embedding."
    x = F.relu(_masked_bn(P, r + "bn1", _conv(P, r + "conv1", rois), valid))
    x = F.relu(_masked_bn(P, r + "bn2", _conv(P, r + "conv2", x), valid))
    x = _linear(P, r + "linear", x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))
    return _linear(P, "late_fusion.fuse", torch.cat([x, seg_emb], -1))


def field_head(P, fuse, classes, valid, seeds, hyp):
    """The two-stage head: a positive/negative gate, then a binary
    classifier a field class over what the gate calls positive. Returns
    ``(loss, scores [N, C])``: column 0 the gate's probability, the others
    the class probabilities where the gate says positive, else 0."""
    h = "field_type_head."
    gate = _linear(P, h + "pos_neg_net.out", fuse)[:, 0]
    logits = _linear(P, h + "category_net.out", fuse)
    g = torch.sigmoid(gate)
    positive = g >= 0.5
    scores = torch.cat([g[:, None], torch.where(positive[:, None], torch.sigmoid(logits), 0.0)], 1)
    # the gate: BCE over a random sample of each side of its decision
    cats = subsample([valid & (gate <= 0), valid & (gate > 0)],
                     [hyp["num_hard_negative_main_1"]] * 2, seeds.next())
    kept = cats[0] | cats[1]
    loss = (bce(gate, classes > 0) * kept).sum() / max(int(kept.sum()), 1)
    gated = valid & positive
    k_pos, k_neg = hyp["num_hard_positive_main_2"], hyp["num_hard_negative_main_2"]
    classes_loss = 0.0
    for ci in range(logits.shape[1]):
        target = classes == ci + 1
        pos, neg = gated & target, gated & ~target
        if hyp.get("ohem_random"):
            pos, neg = subsample([pos, neg], [2 * k_pos, 2 * k_neg], seeds.next())
        else:
            seeds.next()
        classes_loss = classes_loss + ohem(bce(logits[:, ci], target), pos, neg, k_pos, k_neg)
    return loss + float(bool(gated.any())) * classes_loss, scores


def segmentation_head(P, p_fuse, classes, boxes, box_mask, seeds, hyp):
    """The auxiliary two-stage segmentation loss over P_fuse
    ``[B, 256, H/4, W/4]``: a 3-way mask (background, key text, other
    text) under a random sample a category, then a binary OHEM loss a field
    class over the pixels the mask calls key text."""
    s = "semantic_segmentation_head."
    x = F.relu(_bn(P, s + "encoder.bn1", _conv(P, s + "encoder.conv1", p_fuse)))
    x = F.relu(_bn(P, s + "encoder.bn2", _conv(P, s + "encoder.conv2", x)))
    mask_logits = _conv(P, s + "encoder.mask_proj", x)
    binary = _conv(P, s + "binary_bank", _conv(P, s + "encoder.class_proj", x))
    b, _, h4, w4 = mask_logits.shape
    h, w = 4 * h4, 4 * w4
    win = winners(boxes, box_mask, h, w, 1)
    cls = torch.cat([classes.new_zeros((b, 1)), classes], 1).long()
    class_map = torch.gather(cls, 1, win.reshape(b, -1)).reshape(b, h, w)
    pos_neg = torch.where(win > 0, torch.where(class_map > 0, 1, 2), 0)
    mask_up = _up(mask_logits, 4)
    ce = F.cross_entropy(mask_up, pos_neg, reduction="none")
    sample = hyp["loss_aux_sample_list"]
    kept = subsample([pos_neg == i for i in range(len(sample))], list(sample), seeds.next())
    kept = torch.stack(kept).any(0)
    loss = (ce * kept).sum() / max(int(kept.sum()), 1)
    positive = mask_up.argmax(1) == 1
    k_pos, k_neg = hyp["num_hard_positive_aux"], hyp["num_hard_negative_aux"]
    binary_up = _up(binary, 4)
    classes_loss = 0.0
    for ci in range(binary.shape[1]):
        seeds.next()  # a seed a class, read only by a random pre-sample (off here)
        target = class_map == ci + 1
        classes_loss = classes_loss + ohem(bce(binary_up[:, ci], target), positive & target,
                                           positive & ~target, k_pos, k_neg)
    return loss + float(bool(positive.any())) * classes_loss


def forward(P, batch: dict, seeds, cfg: dict):
    """One training forward: ``(total loss, class scores [B, S, C])``.
    ``batch``: the collated arrays as tensors; ``cfg``: the configuration
    file's ``model`` and ``hyp`` with the cell's ``cls_sep`` ids. The text
    encoder is the file that ``model.text_encoder`` names under
    ``benchmark/reference/encoders/``."""
    model, hyp = cfg["model"], cfg["hyp"]
    if hyp["classifier_mode"] != "full":
        raise ValueError("the reference's trunk follows the two-stage head")
    encoder = importlib.import_module("benchmark.reference.encoders." + model["text_encoder"])
    b, hh, ww, _ = batch["images"].shape
    s = batch["boxes"].shape[1]
    tok = encoder.encode(P, encoder.frame(batch["tokens"], batch["token_mask"], cfg), seeds, cfg)
    seg = segment_mean(tok, batch["seg_ids"], batch["token_mask"], s)
    stride = hyp["early_fusion_downsampling_ratio"]
    win = winners(batch["boxes"], batch["box_mask"], hh // stride, ww // stride, stride)
    grid = torch.gather(torch.cat([seg.new_zeros((b, 1, seg.shape[-1])), seg], 1), 1,
                        win.reshape(b, -1, 1).expand(-1, -1, seg.shape[-1]))
    grid = grid.reshape(b, hh // stride, ww // stride, -1)
    p_fuse = backbone(P, batch["images"], grid, model["resnet_blocks"],
                      "_D_" in hyp["backbone"])
    loss_aux = segmentation_head(P, p_fuse, batch["seg_classes"], batch["boxes"],
                                 batch["box_mask"], seeds, hyp)
    valid = batch["box_mask"].reshape(-1).bool()
    rois = roi_align(p_fuse, batch["boxes"], batch["box_mask"], hyp["roi_shape"],
                     1.0 / hyp["p_fuse_downsampling_ratio"])
    fuse = late_fusion(P, rois, seg.reshape(b * s, -1), valid)
    loss_c, scores = field_head(P, fuse, batch["seg_classes"].reshape(-1).long(), valid, seeds,
                                hyp)
    return loss_c + hyp["loss_control_lambda"] * loss_aux, scores.reshape(b, s, -1)
