"""The analytic counts against what the port computes, on the CPU at a tiny
size, and the kernels' bounds against the repository's earlier arithmetic
at the flagship shapes (16 pages of 512x384, one window, 128 segments)."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import counts

TINY = dict(text_encoder="roberta", hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128, num_classes=5, roi_shape=7,
            late_fusion_fuse_embedding_channel=1024)
FLAGSHIP = counts.Model.of({"model": dict(
    text_encoder="roberta", hidden_size=768, num_hidden_layers=12,
    num_attention_heads=12, intermediate_size=3072, resnet_blocks=[3, 4, 6, 3], num_classes=5,
    classifier_mode="simp")})


def _batch(b, h, w, t, s, vocab, seed=0):
    from vibertgrid_tpu_torch.models.vibertgrid import Batch

    rng = np.random.default_rng(seed)
    x0 = rng.integers(0, w - 40, (b, s))
    y0 = rng.integers(0, h - 20, (b, s))
    boxes = np.stack([x0, y0, x0 + 32, y0 + 12], -1)
    n_tok = t - 100
    seg = np.sort(rng.integers(0, s, (b, n_tok)), 1)
    mask = np.zeros((b, t), np.int32)
    mask[:, :n_tok] = 1
    arrays = dict(images=rng.standard_normal((b, h, w, 3)).astype(np.float32),
                  tokens=rng.integers(5, vocab, (b, t)).astype(np.int32), token_mask=mask,
                  seg_ids=np.pad(seg, ((0, 0), (0, t - n_tok))).astype(np.int32),
                  boxes=boxes.astype(np.int32), box_mask=np.ones((b, s), bool),
                  seg_classes=rng.integers(0, 5, (b, s)).astype(np.int32))
    return Batch(**{k: torch.from_numpy(v) for k, v in arrays.items()})


def _implementation_extras(m, x: counts.Shape) -> int:
    """Products the port computes that the model count leaves out: the segment
    mean as a product with a 0/1 matrix, RoIAlign's two dense products."""
    hf, wf, p = x.h // 4, x.w // 4, m.roi
    seg_mean = 2 * x.b * x.s * x.tokens * m.width
    roi_align = 2 * x.b * x.s * p * hf * wf * m.pyramid + 2 * x.b * x.s * p * p * wf * m.pyramid
    return seg_mean + roi_align


@pytest.mark.parametrize("mode,backbone,blocks,bert", [
    ("simp", "resnet_18_fpn", (2, 2, 2, 2), "tiny-bert-test"),
    ("simp", "resnet_34_fpn_pretrained", (3, 4, 6, 3), "tiny-bert-test"),
    ("full", "resnet_18_D_fpn", (2, 2, 2, 2), "tiny-roberta-test"),
])
@pytest.mark.parametrize("train", [False, True])
def test_forward_flops_match_the_ports_products(mode, backbone, blocks, bert, train):
    from vibertgrid_tpu_torch.models.vibertgrid import ModelConfig, ViBERTgridNet
    from vibertgrid_tpu_torch.train.seeds import SeedStream

    cfg = ModelConfig(num_classes=5, bert_version=bert, backbone=backbone, classifier_mode=mode,
                      loss_aux_sample_list=[16, 32, 16], num_hard_positive_aux=16,
                      num_hard_negative_aux=16, cls_token_id=0 if "roberta" in bert else 101,
                      sep_token_id=2 if "roberta" in bert else 102)
    net = ViBERTgridNet(cfg, device="cpu")
    m = counts.Model.of({"model": dict(TINY, resnet_blocks=list(blocks), classifier_mode=mode)})
    x = counts.Shape(b=2, h=128, w=192, tokens=1020, window=510, s=32, train=train)
    batch = _batch(2, 128, 192, 1020, 32, 512)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(batch, train=train, compute_loss=train, seeds=SeedStream(0) if train else None)
    want = counts.forward_flops(m, x) + _implementation_extras(m, x)
    assert counter.get_total_flops() == want


@pytest.mark.parametrize("kind,expected_ms", [
    ("attention", 0.0150), ("ffn", 0.0782), ("scatter", 0.0235), ("attention_bwd", 0.0326)])
def test_kernel_bounds_at_the_flagship(kind, expected_ms):
    """The bound column of PERF.md's kernel table (``chip_smoke._bound``)."""
    fn, _ = counts.calls(FLAGSHIP)[kind]
    x = counts.Shape(b=16, h=512, w=384, tokens=510, window=510, s=128)
    assert round(1e3 * counts.bound_s(*fn(FLAGSHIP, x)), 4) == expected_ms


def test_a_train_step_counts_three_forwards_with_the_losses():
    x = counts.Shape(b=16, h=512, w=384, tokens=510, window=510, s=128)
    fwd = counts.forward_flops(FLAGSHIP, dataclasses.replace(x, train=True))
    assert counts.step_flops(FLAGSHIP, x) == 3 * fwd > 3 * counts.forward_flops(FLAGSHIP, x)
