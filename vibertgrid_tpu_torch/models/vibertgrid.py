"""The ViBERTgrid network (port of ``vibertgrid_tpu/models/vibertgrid.py``):

tokens ─ windowed BERT ─ segment aggregation ─┐
                                              ├─ BERTgrid scatter ─ early-fused
images ───────────────────────────────────────┘   ResNet-FPN ─ P_fuse
P_fuse ─ RoIAlign ─ late fusion with segment BERT embeddings ─ field-type head

With ``compute_loss`` the auxiliary segmentation head reads P_fuse too and
``total_loss = loss_c + λ·loss_aux``; with ``train`` the encoder drops out
and the BatchNorms use and update batch statistics. ``classifier_mode``
picks the field-type head: ``"simp"`` (with the simplified segmentation
head), ``"full"`` or ``"crf"`` (both with the two-stage segmentation head).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from vibertgrid_tpu_torch.device import resolve_device
from vibertgrid_tpu_torch.models.bert import (
    BERT_MODEL_REGISTRY,
    TextEncoder,
    TextEncoderConfig,
)
from vibertgrid_tpu_torch.models.heads import (
    CRFFieldTypeClassification,
    FieldTypeClassification,
    LateFusion,
    SimplifiedFieldTypeClassification,
)
from vibertgrid_tpu_torch.models.resnet_fpn import BACKBONE_REGISTRY, ResNetFPN
from vibertgrid_tpu_torch.models.seg_head import (
    SemanticSegmentationHead,
    SimplifiedSemanticSegmentationHead,
)
from vibertgrid_tpu_torch.ops.grid_scatter import grid_scatter
from vibertgrid_tpu_torch.ops.roi_align import roi_align
from vibertgrid_tpu_torch.ops.segments import aggregate_token_embeddings
from vibertgrid_tpu_torch.ops.windows import frame_windows, unframe_windows
from vibertgrid_tpu_torch.parallel.collectives import all_max
from vibertgrid_tpu_torch.parallel.sharding import apply_shardings


@dataclasses.dataclass
class Batch:
    """Static-shape batch, as the host collator pads it into buckets."""

    images: torch.Tensor       # [B, H, W, 3] float32, normalised, resized, padded
    tokens: torch.Tensor       # [B, T] int32 wordpiece ids, T a multiple of 510
    token_mask: torch.Tensor   # [B, T] int32 validity
    seg_ids: torch.Tensor      # [B, T] int32 segment index per token
    boxes: torch.Tensor        # [B, S, 4] int32 (x0, y0, x1, y1), resized coords
    box_mask: torch.Tensor     # [B, S] bool
    seg_classes: torch.Tensor  # [B, S] int32 field-type class per segment

    def to(self, device) -> "Batch":
        return Batch(**{f.name: getattr(self, f.name).to(device)
                        for f in dataclasses.fields(self)})


@dataclasses.dataclass
class ModelOutput:
    total_loss: Any            # None at inference
    pred_mask: Any             # None at inference
    pred_ss: Any               # None at inference
    gt_label: torch.Tensor     # [B, S]
    pred_label: torch.Tensor   # [B, S, C] class scores, or [B, S] CRF tags
    loss_c: Any = None
    loss_aux: Any = None


_VOCAB = {
    "private_bert-base-uncased": 30522,
    "bert-base-uncased": 30522,
    "bert-base-cased": 28996,
    "bert-base-chinese": 21128,
    "hfl/chinese-bert-wwm-ext": 21128,
    "hfl/chinese-bert-wwm": 21128,
    "roberta-base": 50265,
    "tiny-bert-test": 512,
    "tiny-roberta-test": 512,
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model-structure knobs, as the reference constructor and
    ``example_config.yaml`` name them."""

    num_classes: int = 5
    bert_version: str = "bert-base-uncased"
    backbone: str = "resnet_18_fpn"
    grid_mode: str = "mean"                    # 'mean' | 'first'
    early_fusion_downsampling_ratio: int = 8
    roi_shape: int = 7
    p_fuse_downsampling_ratio: int = 4
    late_fusion_fuse_embedding_channel: int = 1024
    classifier_mode: str = "simp"              # 'full' | 'simp' | 'crf'
    tag_to_idx: Any = None
    layer_mode: str = "single"
    full_head_decision: str = "reference"
    add_pos_neg: bool = True
    loss_weights: Any = None
    loss_control_lambda: float = 1.0
    num_hard_positive_main_1: int = -1
    num_hard_negative_main_1: int = -1
    num_hard_positive_main_2: int = -1
    num_hard_negative_main_2: int = -1
    loss_aux_sample_list: Any = None
    num_hard_positive_aux: int = -1
    num_hard_negative_aux: int = -1
    ohem_random: bool = False
    cls_token_id: int = 101
    sep_token_id: int = 102
    compute_dtype: torch.dtype = torch.float32
    attention_impl: str = "auto"
    ffn_impl: str = "auto"
    # a parallel.mesh.Layout, threaded into the encoder as the JAX package's
    # ModelConfig.mesh is: with a model axis above 1 the encoder is
    # tensor-parallel, everything else replicated
    mesh: Any = None
    text_config: TextEncoderConfig | None = None  # override (tests)

    @property
    def num_tokens(self) -> int:
        """Output class count: len(tag_to_idx) when tags are configured,
        else num_classes."""
        if self.tag_to_idx is not None:
            return len(self.tag_to_idx)
        return self.num_classes

    def resolved_text_config(self) -> TextEncoderConfig:
        kw = dict(attention_impl=self.attention_impl, ffn_impl=self.ffn_impl, mesh=self.mesh)
        if self.text_config is not None:
            return dataclasses.replace(self.text_config, **kw)
        if self.bert_version not in BERT_MODEL_REGISTRY:
            raise ValueError(
                f"unknown bert_version {self.bert_version!r}; "
                f"available: {sorted(BERT_MODEL_REGISTRY)}"
            )
        _, flavor = BERT_MODEL_REGISTRY[self.bert_version]
        if self.bert_version in ("tiny-bert-test", "tiny-roberta-test"):
            cfg = TextEncoderConfig.tiny(flavor)
        else:
            cfg = TextEncoderConfig.base(flavor, _VOCAB[self.bert_version])
        return dataclasses.replace(cfg, **kw)

    @staticmethod
    def from_yaml_dict(hyp: dict) -> "ModelConfig":
        """Build from a reference-compatible YAML dict (example_config.yaml)."""
        return ModelConfig(
            num_classes=hyp["num_classes"],
            bert_version=hyp["bert_version"],
            backbone=hyp["backbone"],
            grid_mode=hyp.get("grid_mode", "mean"),
            early_fusion_downsampling_ratio=hyp.get("early_fusion_downsampling_ratio", 8),
            roi_shape=hyp.get("roi_shape", 7),
            p_fuse_downsampling_ratio=hyp.get("p_fuse_downsampling_ratio", 4),
            late_fusion_fuse_embedding_channel=hyp.get(
                "late_fusion_fuse_embedding_channel", 1024
            ),
            classifier_mode=hyp.get("classifier_mode", "simp"),
            tag_to_idx=hyp.get("tag_to_idx"),
            layer_mode=hyp.get("layer_mode", "single"),
            full_head_decision=hyp.get("full_head_decision", "reference"),
            add_pos_neg=hyp.get("add_pos_neg", True),
            loss_weights=hyp.get("loss_weights"),
            loss_control_lambda=hyp.get("loss_control_lambda", 1.0),
            num_hard_positive_main_1=hyp.get("num_hard_positive_main_1", -1),
            num_hard_negative_main_1=hyp.get("num_hard_negative_main_1", -1),
            num_hard_positive_main_2=hyp.get("num_hard_positive_main_2", -1),
            num_hard_negative_main_2=hyp.get("num_hard_negative_main_2", -1),
            loss_aux_sample_list=hyp.get("loss_aux_sample_list"),
            num_hard_positive_aux=hyp.get("num_hard_positive_aux", -1),
            num_hard_negative_aux=hyp.get("num_hard_negative_aux", -1),
            ohem_random=hyp.get("ohem_random", False),
            compute_dtype=torch.bfloat16 if hyp.get("amp", False) else torch.float32,
            attention_impl=hyp.get("attention_impl", "auto"),
            ffn_impl=hyp.get("ffn_impl", "auto"),
        )


class ViBERTgridNet(nn.Module):
    """See the module docstring. ``forward(batch, train, compute_loss,
    seeds)`` → :class:`ModelOutput` with ``pred_label [B, S, C]`` and, with
    ``compute_loss``, the losses and the segmentation logits (the CRF head
    returns tag ids ``[B, S]``, or its emissions ``[B, S, K]`` from a training
    forward with the loss). Parameters are fp32; products run in ``config.compute_dtype``.

    ``seeds`` (an object with ``next() -> int``, see ``train/seeds.py``)
    feeds the dropout sites and the sampled losses in the order that module
    documents; without it the dropout sites raise and the losses use seed 0.
    An evaluation forward works with autograd recording or under
    ``torch.no_grad()``, with the same values; only the latter takes the
    residual-free FFN kernel and keeps no activations, so inference callers
    (``entry()``'s ``forward`` does) run it under ``torch.no_grad()``."""

    def __init__(self, config: ModelConfig, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        mode = config.classifier_mode
        if mode not in ("simp", "full", "crf"):
            raise ValueError(f"classifier_mode {mode!r} is not 'simp', 'full' or 'crf'")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.config = config
        dt = config.compute_dtype
        text_cfg = config.resolved_text_config()
        kw = dict(device=device, generator=generator)
        self.bert_model = TextEncoder(text_cfg, dt, **kw)
        self.backbone = ResNetFPN(
            grid_channels=text_cfg.hidden_size, dtype=dt,
            **BACKBONE_REGISTRY[config.backbone], **kw,
        )
        self.late_fusion = LateFusion(
            256, config.roi_shape, text_cfg.hidden_size, dtype=dt, **kw
        )
        seg_cls = (SimplifiedSemanticSegmentationHead if mode == "simp"
                   else SemanticSegmentationHead)
        self.semantic_segmentation_head = seg_cls(
            256, config.num_tokens,
            loss_1_sample_list=config.loss_aux_sample_list,
            num_hard_positive=config.num_hard_positive_aux,
            num_hard_negative=config.num_hard_negative_aux,
            loss_weights=config.loss_weights, dtype=dt, **kw,
        )
        if mode == "crf":
            self.field_type_head = CRFFieldTypeClassification(
                1024, config.num_tokens, layer_mode=config.layer_mode, dtype=dt, **kw)
            self._split(text_cfg)
            return
        ohem = dict(
            num_hard_positive_1=config.num_hard_positive_main_1,
            num_hard_negative_1=config.num_hard_negative_main_1,
            num_hard_positive_2=config.num_hard_positive_main_2,
            num_hard_negative_2=config.num_hard_negative_main_2,
            ohem_random=config.ohem_random,
        )
        if mode == "simp":
            self.field_type_head = SimplifiedFieldTypeClassification(
                1024, config.num_tokens, add_pos_neg=config.add_pos_neg,
                loss_weights=config.loss_weights, dtype=dt, **ohem, **kw)
        else:
            self.field_type_head = FieldTypeClassification(
                1024, config.num_tokens, layer_mode=config.layer_mode,
                decision=config.full_head_decision, dtype=dt, **ohem, **kw)
        self._split(text_cfg)

    def _split(self, text_cfg: TextEncoderConfig) -> None:
        """Under tensor parallelism keep this rank's slices of the encoder's
        split weights: every rank draws the whole model from the same
        generator, so the slices are those of the one-process model."""
        layout = self.config.mesh
        if layout is None or layout.model == 1:
            return
        if text_cfg.num_heads % layout.model or text_cfg.intermediate_size % layout.model:
            raise ValueError(f"{text_cfg.num_heads} heads and {text_cfg.intermediate_size} FFN "
                             f"features do not split over mesh_model={layout.model}")
        apply_shardings(self, layout)

    def forward(self, batch: Batch, *, train: bool = False, compute_loss: bool = False,
                seeds=None) -> ModelOutput:
        cfg = self.config
        dt = cfg.compute_dtype
        b, h, w, _ = batch.images.shape
        s = batch.boxes.shape[1]
        gs = cfg.early_fusion_downsampling_ratio
        if h % 32 or w % 32:
            raise ValueError(f"image bucket {h}x{w} must be a multiple of 32")

        # seq_len = the batch-max valid token count: where each window's
        # [SEP] lands, as the reference frames its padded corpus (the
        # global batch's in a data-parallel step).
        seq_len = all_max(batch.token_mask.to(torch.int32).sum(dim=1).max())
        ids, amask = frame_windows(
            batch.tokens, batch.token_mask, cls_id=cfg.cls_token_id,
            sep_id=cfg.sep_token_id, seq_len=seq_len,
        )
        tok_emb = unframe_windows(
            self.bert_model(ids, amask, deterministic=not train, seeds=seeds), batch_size=b
        )  # [B, T, D]
        seg_emb = aggregate_token_embeddings(
            tok_emb.float(), batch.seg_ids, batch.token_mask,
            num_segments=s, mode=cfg.grid_mode,
        )  # [B, S, D] fp32
        grid = grid_scatter(
            seg_emb.to(dt), batch.boxes, batch.box_mask,
            height=h // gs, width=w // gs, stride=gs,
        )  # [B, H/gs, W/gs, D]
        p_fuse = self.backbone(batch.images, grid, train)  # [B, H/4, W/4, 256]

        # Seeds of the sampled losses, in the order train/seeds.py documents:
        # 2 for the simplified heads, one per class for the two-stage ones.
        n_seeds = 2 if cfg.classifier_mode == "simp" else cfg.num_tokens
        draw = lambda: [0 if seeds is None else seeds.next() for _ in range(n_seeds)]
        loss_aux = pred_mask = pred_ss = None
        if compute_loss:
            loss_aux, pred_mask, pred_ss = self.semantic_segmentation_head(
                p_fuse, batch.seg_classes, batch.boxes, batch.box_mask,
                train=train, seeds=draw(),
            )
        rois = roi_align(
            p_fuse, batch.boxes.float(), batch.box_mask,
            output_size=cfg.roi_shape, spatial_scale=1.0 / cfg.p_fuse_downsampling_ratio,
        )  # [B, S, 7, 7, 256]
        rois_flat = rois.reshape(b * s, cfg.roi_shape, cfg.roi_shape, -1)
        valid_flat = batch.box_mask.reshape(b * s)
        fuse = self.late_fusion(
            rois_flat, seg_emb.reshape(b * s, -1), valid_flat, train
        )  # [B·S, 1024]
        if cfg.classifier_mode == "crf":
            loss_c, pred_label = self.field_type_head(
                fuse.reshape(b, s, -1), batch.seg_classes,
                batch.box_mask.to(torch.int32).sum(dim=1),
                train=train, compute_loss=compute_loss,
            )
        else:
            loss_c, pred = self.field_type_head(
                fuse, batch.seg_classes.reshape(b * s), valid_flat,
                compute_loss=compute_loss, seeds=draw() if compute_loss else None,
            )
            pred_label = pred.reshape(b, s, -1)
        total_loss = None
        if compute_loss:
            total_loss = loss_c + cfg.loss_control_lambda * loss_aux
        return ModelOutput(
            total_loss=total_loss, pred_mask=pred_mask, pred_ss=pred_ss,
            gt_label=batch.seg_classes, pred_label=pred_label,
            loss_c=loss_c, loss_aux=loss_aux,
        )
