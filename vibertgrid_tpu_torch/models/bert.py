"""BERT / RoBERTa text encoder (port of ``vibertgrid_tpu/models/bert.py``).

On CUDA tensors every layer's attention runs the hand-written attention
kernels (forward and backward) and its FFN tail the fused FFN kernel; on CPU
tensors both run their plain twins. The Q/K/V projections are plain
``F.linear`` products, as the JAX package left them to XLA. The attention
epilogue, out-projection → dropout → residual → LayerNorm, is an ``F.linear``
and elementwise passes by default and one launch of the fused epilogue kernel
(``fused_proj_ln``) under ``attn_epilogue="fused"``; both read the same
parameters and drop the same elements for one seed.

``deterministic=True`` (evaluation) drops nothing. ``deterministic=False``
(training) drops the embeddings, the attention probabilities (inside the
kernel), the attention output (inside the kernel under the fused epilogue)
and the FFN output (inside the kernel), each from its own seed drawn from
``seeds`` in that order. Under ``ffn_impl`` ``"auto"`` or ``"fused-saved"``
the FFN tail is chosen by the gradient path, not by that flag: where autograd
records and an input or a parameter requires a gradient it is
``fused_ffn_saved``, whose backward needs no rematerialisation; elsewhere
(under ``torch.no_grad()``) it is the residual-free ``fused_ffn``.
``ffn_impl="fused"`` takes ``fused_ffn`` on every path, with its
rematerialising backward, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from vibertgrid_tpu_torch.device import resolve_device
from vibertgrid_tpu_torch.models.layers import assign, dense, embedding, linear
from vibertgrid_tpu_torch.models.norm import LayerNorm
from vibertgrid_tpu_torch.ops.dropout import hash_dropout
from vibertgrid_tpu_torch.ops.flash_attention import flash_attention
from vibertgrid_tpu_torch.ops.fused_ffn import fused_ffn, fused_ffn_saved, fused_proj_ln

# name → (hidden size, flavor); the reference's 7-entry bert_model_list
# plus two tiny test configs.
BERT_MODEL_REGISTRY = {
    "private_bert-base-uncased": (768, "bert"),
    "bert-base-uncased": (768, "bert"),
    "bert-base-cased": (768, "bert"),
    "roberta-base": (768, "roberta"),
    "bert-base-chinese": (768, "bert"),
    "hfl/chinese-bert-wwm-ext": (768, "bert"),
    "hfl/chinese-bert-wwm": (768, "bert"),
    "tiny-bert-test": (64, "bert"),
    "tiny-roberta-test": (64, "roberta"),
}


@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    flavor: str = "bert"  # "bert" | "roberta"
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    # The JAX package's kernel gates. CUDA tensors always take the kernels and
    # CPU tensors their twins (the port has no non-kernel path on the card),
    # so ``attention_impl`` and the value "xla" of the other two select
    # nothing and are kept for YAML compatibility.
    attention_impl: str = "auto"
    # "fused": the residual-free FFN kernel on every path, rematerialising
    # backward. "auto" / "fused-saved": the saved-residual kernel on gradient
    # paths, the residual-free one elsewhere.
    ffn_impl: str = "auto"
    # "fused": the attention epilogue as one kernel (fused_proj_ln); any other
    # value: F.linear, dropout, residual and LayerNorm as separate passes.
    attn_epilogue: str = "auto"
    mesh: Any = None

    @staticmethod
    def tiny(flavor: str = "bert") -> "TextEncoderConfig":
        return TextEncoderConfig(
            vocab_size=512,
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            intermediate_size=128,
            max_position_embeddings=520 if flavor == "roberta" else 512,
            flavor=flavor,
            pad_token_id=1 if flavor == "roberta" else 0,
        )

    @staticmethod
    def base(flavor: str = "bert", vocab_size: int | None = None) -> "TextEncoderConfig":
        if flavor == "roberta":
            return TextEncoderConfig(
                vocab_size=vocab_size or 50265,
                max_position_embeddings=514,
                pad_token_id=1,
                flavor="roberta",
            )
        return TextEncoderConfig(vocab_size=vocab_size or 30522)


def _draw(seeds, rate: float) -> int:
    """The next seed of the stream for a site that drops; a site at rate 0
    draws nothing."""
    if rate <= 0.0:
        return 0
    if seeds is None:
        raise ValueError("a training forward with dropout needs a seed stream")
    return seeds.next()


class SelfAttention(nn.Module):
    def __init__(self, config: TextEncoderConfig, dtype, *, device, generator):
        super().__init__()
        self.config = config
        self.dtype = dtype
        d = config.hidden_size
        for name in ("query", "key", "value", "out"):
            setattr(self, name, linear(d, d, device=device, generator=generator))

    def forward(self, hidden, attn_bias, deterministic: bool = True, seeds=None,
                return_ctx: bool = False):
        """The out-projected attention output, or with ``return_ctx`` the
        context before the out-projection (the fused epilogue applies it)."""
        cfg = self.config
        dt = self.dtype
        q = dense(hidden, self.query, dt)
        k = dense(hidden, self.key, dt)
        v = dense(hidden, self.value, dt)
        dh = cfg.hidden_size // cfg.num_heads
        rate = 0.0 if deterministic else cfg.attention_dropout
        ctx = flash_attention(
            q, k, v, attn_bias, 1.0 / float(dh) ** 0.5, cfg.num_heads,
            rate=rate, seed=_draw(seeds, rate),
        )
        return ctx if return_ctx else dense(ctx, self.out, dt)


class EncoderLayer(nn.Module):
    def __init__(self, config: TextEncoderConfig, dtype, *, device, generator):
        super().__init__()
        self.config = config
        self.dtype = dtype
        d, f = config.hidden_size, config.intermediate_size
        eps = config.layer_norm_eps
        kw = dict(device=device, generator=generator)
        self.attention = SelfAttention(config, dtype, **kw)
        self.attention_ln = LayerNorm(d, eps=eps, dtype=dtype, device=device)
        self.intermediate = linear(d, f, **kw)
        self.output = linear(f, d, **kw)
        self.output_ln = LayerNorm(d, eps=eps, dtype=dtype, device=device)

    def forward(self, hidden, attn_bias, deterministic: bool = True, seeds=None):
        b, t, d = hidden.shape
        rate = 0.0 if deterministic else self.config.hidden_dropout
        eps = self.config.layer_norm_eps
        if self.config.attn_epilogue == "fused":
            ctx = self.attention(hidden, attn_bias, deterministic, seeds, return_ctx=True)
            x2d = fused_proj_ln(
                ctx.reshape(b * t, d), hidden.reshape(b * t, d), self.attention.out.weight,
                self.attention.out.bias, self.attention_ln.weight, self.attention_ln.bias, eps,
                rate=rate, seed=_draw(seeds, rate),
            )
        else:
            attn = self.attention(hidden, attn_bias, deterministic, seeds)
            attn = hash_dropout(attn, _draw(seeds, rate), rate)
            x2d = self.attention_ln(hidden + attn).reshape(b * t, d)
        # both take the fp32 parameters: their gradients leave in fp32
        params = (self.intermediate.weight, self.intermediate.bias, self.output.weight,
                  self.output.bias, self.output_ln.weight, self.output_ln.bias)
        # Unless "fused" forces it, the residual-free kernel serves only where
        # no gradient can be asked: an evaluation forward under autograd takes
        # the saved-residual kernel at rate 0, as every training forward does.
        grad_path = torch.is_grad_enabled() and any(t.requires_grad for t in (x2d, *params))
        residual_free = self.config.ffn_impl == "fused" or (deterministic and not grad_path)
        ffn = fused_ffn if residual_free else fused_ffn_saved
        out = ffn(x2d, *params, eps, rate=rate, seed=_draw(seeds, rate))
        return out.reshape(b, t, d)


class TextEncoder(nn.Module):
    """BERT/RoBERTa encoder returning the last hidden state:
    ``forward(input_ids [B, T], attention_mask [B, T], deterministic, seeds)``
    → ``[B, T, D]``. ``seeds`` (an object with ``next() -> int``, see
    ``train/seeds.py``) is read only when ``deterministic`` is false."""

    def __init__(self, config: TextEncoderConfig, dtype=torch.float32, *,
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.config = config
        self.dtype = dtype
        d = config.hidden_size
        kw = dict(device=device, generator=generator)
        self.word_embeddings = embedding(config.vocab_size, d, **kw)
        self.position_embeddings = embedding(config.max_position_embeddings, d, **kw)
        self.token_type_embeddings = embedding(config.type_vocab_size, d, **kw)
        self.embeddings_ln = LayerNorm(
            d, eps=config.layer_norm_eps, dtype=dtype, device=device
        )
        self.layer = nn.ModuleList(
            EncoderLayer(config, dtype, **kw) for _ in range(config.num_layers)
        )

    def forward(self, input_ids, attention_mask, deterministic: bool = True, seeds=None):
        cfg = self.config
        b, t = input_ids.shape
        ids = input_ids.long()
        if cfg.flavor == "roberta":
            # HF create_position_ids_from_input_ids: pads keep padding_idx,
            # other positions count from padding_idx + 1.
            not_pad = (ids != cfg.pad_token_id).long()
            position_ids = torch.cumsum(not_pad, dim=1) * not_pad + cfg.pad_token_id
        else:
            position_ids = torch.arange(t, device=ids.device).expand(b, t)
        hidden = (
            self.word_embeddings(ids)
            + self.position_embeddings(position_ids)
            + self.token_type_embeddings(torch.zeros_like(ids))
        )
        hidden = self.embeddings_ln(hidden)
        rate = 0.0 if deterministic else cfg.hidden_dropout
        hidden = hash_dropout(hidden, _draw(seeds, rate), rate)
        attn_bias = torch.where(attention_mask.bool(), 0.0, -1e9).float()  # [B, T]
        for layer in self.layer:
            hidden = layer(hidden, attn_bias, deterministic, seeds)
        return hidden


# HuggingFace module name → the encoder's, under ``encoder.layer.{i}`` /
# ``layer.{i}``; both sides keep the ``nn.Linear`` layout.
_HF_LAYER = {
    "attention.self.query": "attention.query",
    "attention.self.key": "attention.key",
    "attention.self.value": "attention.value",
    "attention.output.dense": "attention.out",
    "attention.output.LayerNorm": "attention_ln",
    "intermediate.dense": "intermediate",
    "output.dense": "output",
    "output.LayerNorm": "output_ln",
}
_HF_EMBEDDINGS = {
    "embeddings.word_embeddings.weight": "word_embeddings.weight",
    "embeddings.position_embeddings.weight": "position_embeddings.weight",
    "embeddings.token_type_embeddings.weight": "token_type_embeddings.weight",
    "embeddings.LayerNorm.weight": "embeddings_ln.weight",
    "embeddings.LayerNorm.bias": "embeddings_ln.bias",
}


def load_hf_weights(encoder: TextEncoder, state_dict) -> None:
    """Copy a local HuggingFace ``BertModel`` / ``RobertaModel`` state dict
    into ``encoder`` in place. Values may be torch tensors or numpy arrays;
    keys may carry a ``bert.`` / ``roberta.`` prefix. A missing entry raises
    ``KeyError``, a shape mismatch ``ValueError``."""

    def get(name):
        for prefix in ("", "bert.", "roberta."):
            if prefix + name in state_dict:
                return state_dict[prefix + name]
        raise KeyError(name)

    names = dict(_HF_EMBEDDINGS)
    for i in range(encoder.config.num_layers):
        for theirs, ours in _HF_LAYER.items():
            for leaf in ("weight", "bias"):
                names[f"encoder.layer.{i}.{theirs}.{leaf}"] = f"layer.{i}.{ours}.{leaf}"
    for theirs, ours in names.items():
        assign(encoder.get_parameter(ours), get(theirs), theirs)
