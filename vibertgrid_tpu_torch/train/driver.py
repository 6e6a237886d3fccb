"""The training driver's setup functions (port of the first half of
``vibertgrid_tpu/train/driver.py``): the tokenizer, the model with its
transform and collator from a reference-compatible YAML dict, and the
loaders of local pretrained weights. The serving engine builds its model
through these; ``train`` and ``main`` come with the driver slice.

``transformers`` is imported only where a tokenizer is built; nothing is
downloaded (``tokenizer_path`` or ``bert_version`` names local files).
"""

from __future__ import annotations

import dataclasses
import os

import torch

from vibertgrid_tpu_torch.data.dataset import Collator
from vibertgrid_tpu_torch.data.spec import get_spec
from vibertgrid_tpu_torch.data.transform import ImageTransform
from vibertgrid_tpu_torch.device import resolve_device
from vibertgrid_tpu_torch.models.vibertgrid import ModelConfig, ViBERTgridNet


def build_tokenizer(hyp: dict):
    """Local tokenizer only (no hub). ``tokenizer_path`` points at a dir with
    vocab/tokenizer files or at a bare ``vocab.txt``; without it
    ``bert_version`` is read as a local path. Fast (Rust) tokenizers unless
    ``fast_tokenizer: false``."""
    import transformers

    fast = hyp.get("fast_tokenizer", True)
    path = hyp.get("tokenizer_path") or hyp["bert_version"]

    def pick(name: str):
        # transformers 5 folds the *Fast classes into the plain names
        slow = getattr(transformers, name)
        return getattr(transformers, name + "Fast", slow) if fast else slow

    if "roberta" in hyp["bert_version"]:
        return pick("RobertaTokenizer").from_pretrained(path)
    cls = pick("BertTokenizer")
    if os.path.isfile(path):  # bare vocab.txt
        return cls(vocab_file=path)
    return cls.from_pretrained(path)


def build_all(hyp: dict, dataset: str, tokenizer=None, spec=None, *, device="cuda",
              seed: int = 0):
    """``(spec, cfg, model, transform, collator, tag_to_idx)`` from a YAML
    dict: the model built on ``device`` with weights drawn from a generator
    seeded with ``seed`` (in eval mode), the [CLS] / [SEP] ids taken from the
    tokenizer."""
    spec = spec or get_spec(dataset)
    tag_mode = hyp.get("tag_mode", "B")
    tag_to_idx = spec.tag_to_idx(tag_mode)
    model_cfg_dict = dict(hyp)
    model_cfg_dict["num_classes"] = hyp.get("num_classes", spec.num_classes)
    if hyp.get("classifier_mode") == "crf" or tag_mode == "BIO":
        model_cfg_dict["tag_to_idx"] = tag_to_idx
    cfg = ModelConfig.from_yaml_dict(model_cfg_dict)
    if tokenizer is not None:
        # RoBERTa's <s> id is 0 (falsy): explicit None checks only
        cls_id, sep_id = tokenizer.cls_token_id, tokenizer.sep_token_id
        cfg = dataclasses.replace(
            cfg,
            cls_token_id=cls_id if cls_id is not None else 101,
            sep_token_id=sep_id if sep_id is not None else 102,
        )
    dev = resolve_device(device)
    model = ViBERTgridNet(cfg, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(seed)).eval()
    transform = ImageTransform(
        hyp.get("image_mean", spec.image_mean),
        hyp.get("image_std", spec.image_std),
        hyp.get("image_min_size", [320, 416, 512, 608, 704]),
        hyp.get("test_image_min_size", 512),
        hyp.get("image_max_size", 800),
    )
    return spec, cfg, model, transform, Collator(transform), tag_to_idx


def _load_torch_state_dict(path: str) -> dict:
    """A ``.safetensors`` file, or a ``torch.save`` file holding a state dict
    (or a checkpoint dict with one under ``"model"``), as CPU tensors."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.get("model", sd) if isinstance(sd, dict) else sd


def load_pretrained_into_state(state, hyp: dict):
    """Load local pretrained weights into a model (or the model of a
    ``TrainState``) in place and return ``state``:

    - ``reference_weights``: a trained ViBERTgrid-PyTorch checkpoint (the full
      model ``state_dict``), every component through
      :func:`~vibertgrid_tpu_torch.models.convert_reference.load_reference_checkpoint`;
    - ``bert_weights``: a HuggingFace BERT / RoBERTa state dict into the text
      encoder;
    - ``backbone_weights``: a torchvision ResNet state dict into the trunk.
    """
    model = getattr(state, "model", state)
    if hyp.get("reference_weights"):
        from vibertgrid_tpu_torch.models.convert_reference import load_reference_checkpoint

        load_reference_checkpoint(model, _load_torch_state_dict(hyp["reference_weights"]))
        print("==> loaded reference (ViBERTgrid-PyTorch) checkpoint")
    if hyp.get("bert_weights"):
        from vibertgrid_tpu_torch.models.bert import load_hf_weights

        load_hf_weights(model.bert_model, _load_torch_state_dict(hyp["bert_weights"]))
        print("==> loaded local BERT weights")
    if hyp.get("backbone_weights"):
        from vibertgrid_tpu_torch.models.resnet_fpn import load_pretrained_backbone

        load_pretrained_backbone(model, _load_torch_state_dict(hyp["backbone_weights"]))
        print("==> loaded local backbone weights")
    return state
