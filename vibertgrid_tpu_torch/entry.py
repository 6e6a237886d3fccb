"""Entry points of the port: the flagship model and a synthetic batch.

- :func:`make_batch` builds the same synthetic batch, from the same numpy
  draws, as the JAX package's ``__graft_entry__._make_batch``.
- :func:`entry` returns an inference forward and its arguments, the model
  randomly initialised from a seeded generator; by default the flagship
  (BERT-base-uncased, ResNet-34-FPN, simplified head, bf16).
- :func:`train_entry` returns a train step (the losses' OHEM and sampling
  counts, SGD + AdamW with bf16 state), its state and a batch at the shapes
  the JAX package times training at; by default the flagship's.
- ``FULL_FUSED`` and ``CRF_FUSED`` are the flagship's width and depth with
  the full two-stage head and the CRF head, the encoder's attention epilogue
  as one fused kernel; both entries take them as ``config``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vibertgrid_tpu_torch.device import resolve_device
from vibertgrid_tpu_torch.models.bert import TextEncoderConfig
from vibertgrid_tpu_torch.models.vibertgrid import Batch, ModelConfig, ViBERTgridNet
from vibertgrid_tpu_torch.train.optim import make_optimizer
from vibertgrid_tpu_torch.train.state import create_train_state, make_train_step

FLAGSHIP = ModelConfig(
    num_classes=5,
    bert_version="bert-base-uncased",
    backbone="resnet_34_fpn",
    classifier_mode="simp",
    compute_dtype=torch.bfloat16,
)

# The configuration the JAX package times its train step at (bench.py).
FLAGSHIP_TRAIN = dataclasses.replace(
    FLAGSHIP,
    num_hard_positive_main_1=32,
    num_hard_negative_main_1=32,
    num_hard_positive_main_2=32,
    num_hard_negative_main_2=32,
    loss_aux_sample_list=[64, 128, 64],
    num_hard_positive_aux=512,
    num_hard_negative_aux=512,
)
# The other two model families on the encoder with the fused attention
# epilogue, with the training counts above (an inference forward reads none).
_FUSED_EPILOGUE = dataclasses.replace(TextEncoderConfig.base(), attn_epilogue="fused")
FULL_FUSED = dataclasses.replace(FLAGSHIP_TRAIN, classifier_mode="full",
                                 text_config=_FUSED_EPILOGUE)
CRF_FUSED = dataclasses.replace(FLAGSHIP_TRAIN, classifier_mode="crf",
                                text_config=_FUSED_EPILOGUE)
FLAGSHIP_TRAIN_HYP = {
    "optimizer_cnn_hyp": dict(
        learning_rate=0.005, min_learning_rate=1e-6, warm_up_epoches=0,
        warm_up_init_lr=1e-6, momentum=0.9, weight_decay=5e-4, min_weight_decay=5e-4,
    ),
    "optimizer_bert_hyp": dict(
        learning_rate=5e-5, min_learning_rate=1e-8, warm_up_epoches=0,
        warm_up_init_lr=1e-8, beta1=0.9, beta2=0.999, epsilon=1e-8,
        weight_decay=0.01, min_weight_decay=0.01,
    ),
}
TRAIN_SHAPE = dict(b=16, h=512, w=384, t=510, s=128, vocab=30522)


def make_batch(b: int, h: int, w: int, t: int, s: int, vocab: int, seed: int = 0,
               device="cuda") -> Batch:
    """Random boxes of 8-32 x 4-16 px, 3·s sorted segment ids over the first
    tokens, normal images, every box valid."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    boxes = []
    for _ in range(b):
        x0 = rng.integers(0, w - 32, s)
        y0 = rng.integers(0, h - 16, s)
        boxes.append(
            np.stack([x0, y0, x0 + rng.integers(8, 32, s), y0 + rng.integers(4, 16, s)], 1)
        )
    n_tok = min(3 * s, t)
    seg_ids = np.sort(rng.integers(0, s, (b, n_tok)), axis=1)
    seg_ids = np.pad(seg_ids, ((0, 0), (0, t - n_tok)))
    token_mask = np.zeros((b, t), np.int32)
    token_mask[:, :n_tok] = 1
    arrays = dict(
        images=np.asarray(rng.standard_normal((b, h, w, 3)), np.float32),
        tokens=np.asarray(rng.integers(3, vocab - 1, (b, t)), np.int32),
        token_mask=token_mask,
        seg_ids=np.asarray(seg_ids, np.int32),
        boxes=np.asarray(np.stack(boxes), np.int32),
        box_mask=np.ones((b, s), bool),
        seg_classes=np.asarray(rng.integers(0, 5, (b, s)), np.int32),
    )
    return Batch(**{k: torch.from_numpy(v).to(dev) for k, v in arrays.items()})


def entry(device="cuda", seed: int = 0, config: ModelConfig = FLAGSHIP):
    """``(forward, (model, batch))``: ``forward(model, batch)`` is the
    inference ``pred_label`` (``[1, 32, 5]`` scores, or ``[1, 32]`` tags from
    the CRF head) on the batch of the JAX package's ``entry()`` (one 256x256
    page, 510 tokens, 32 segments)."""
    dev = resolve_device(device)
    generator = torch.Generator(device=dev).manual_seed(seed)
    model = ViBERTgridNet(config, device=dev, generator=generator).eval()
    batch = make_batch(b=1, h=256, w=256, t=510, s=32, vocab=30522, device=dev)

    @torch.no_grad()
    def forward(model: ViBERTgridNet, batch: Batch) -> torch.Tensor:
        return model(batch).pred_label

    return forward, (model, batch)


def train_entry(device="cuda", seed: int = 0, config: ModelConfig = FLAGSHIP_TRAIN,
                hyp: dict = FLAGSHIP_TRAIN_HYP, shape: dict = TRAIN_SHAPE):
    """``(state, train_step, batch)``: a train step, the flagship's unless
    ``config`` names another. ``state``
    holds the model (randomly initialised from ``seed``) and the dual
    optimizer (2 epochs of 100 iterations of schedule, bf16 state);
    ``train_step(state, batch, seeds)`` updates it in place and returns
    ``(state, loss)``; ``batch`` is 16 pages of 512x384 with one 510-token
    window and 128 segments. ``hyp`` and ``shape`` let a test take the same
    path at a small size."""
    dev = resolve_device(device)
    generator = torch.Generator(device=dev).manual_seed(seed)
    model = ViBERTgridNet(config, device=dev, generator=generator)
    optimizer = make_optimizer(hyp, num_epochs=2, niter_per_ep=100,
                               named_parameters=model.named_parameters())
    batch = make_batch(**shape, device=dev)
    return create_train_state(model, optimizer), make_train_step(), batch
