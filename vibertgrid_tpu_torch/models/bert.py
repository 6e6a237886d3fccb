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

**Tensor parallelism.** Where ``TextEncoderConfig.mesh`` is a layout with a
model axis above 1 (``parallel/mesh.py``), each layer holds this rank's
slices of its weights (``parallel/sharding.py``, the JAX package's Megatron
rules) and runs Megatron's layer: the Q/K/V products on its column slices
after *copy to the model group*, the attention kernels on its ``num_heads /
model`` heads (the dropout seed folded with the shard, as the JAX package's
``flash_attention_sharded`` does), the out-projection on its row slice, a
sum over the model group, then the bias, the dropout, the residual and the
LayerNorm; the FFN up-projection and gelu on its column slice and the
down-projection on its row slice, a sum over the model group, then ``+ b2``,
the dropout, the residual and the LayerNorm. The partial sums need that sum
before the residual and the LayerNorm, so the fused FFN and epilogue kernels
do not run there, as in the JAX package (``models/bert.py``: the fusion
boundary); the products are ``F.linear``. Every rank of a model group draws
the same seeds and holds the same activations between the sums, so the
hidden-dropout masks agree across it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from vibertgrid_tpu_torch.device import resolve_device
from vibertgrid_tpu_torch.models.layers import assign, dense, embedding, linear
from vibertgrid_tpu_torch.models.norm import LayerNorm
from vibertgrid_tpu_torch.ops.dropout import hash_dropout
from vibertgrid_tpu_torch.ops.flash_attention import flash_attention
from vibertgrid_tpu_torch.ops.fused_ffn import fused_ffn, fused_ffn_saved, fused_proj_ln
from vibertgrid_tpu_torch.ops.segments import embedding_lookup
from vibertgrid_tpu_torch.parallel.collectives import copy_to_model, reduce_from_model
from vibertgrid_tpu_torch.parallel.sharding import local_part, split_axis

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
    # CPU tensors their twins (the port has no non-kernel path on the card
    # but tensor parallelism's FFN and epilogue, plain products in the JAX
    # package too), so ``attention_impl`` and the value "xla" of the other
    # two select nothing and are kept for YAML compatibility.
    attention_impl: str = "auto"
    # "fused": the residual-free FFN kernel on every path, rematerialising
    # backward. "auto" / "fused-saved": the saved-residual kernel on gradient
    # paths, the residual-free one elsewhere.
    ffn_impl: str = "auto"
    # "fused": the attention epilogue as one kernel (fused_proj_ln); any other
    # value: F.linear, dropout, residual and LayerNorm as separate passes.
    attn_epilogue: str = "auto"
    # A parallel.mesh.Layout: with a model axis above 1 the layers hold their
    # slices of the weights and run tensor-parallel (module docstring).
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


def _tp(config: TextEncoderConfig):
    """The layout of a tensor-parallel encoder, else None."""
    mesh = config.mesh
    return mesh if mesh is not None and mesh.model > 1 else None


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
        tp = _tp(cfg)
        heads = cfg.num_heads // (tp.model if tp else 1)
        hidden = copy_to_model(hidden, tp)
        q = dense(hidden, self.query, dt)
        k = dense(hidden, self.key, dt)
        v = dense(hidden, self.value, dt)
        dh = cfg.hidden_size // cfg.num_heads
        if q.shape[-1] != heads * dh:
            raise ValueError(f"attention weights of {q.shape[-1]} outputs for {heads} local "
                             "heads: a tensor-parallel encoder holds its slices "
                             "(parallel.sharding.apply_shardings)")
        rate = 0.0 if deterministic else cfg.attention_dropout
        ctx = flash_attention(
            q, k, v, attn_bias, 1.0 / float(dh) ** 0.5, heads,
            rate=rate, seed=_draw(seeds, rate),
        )
        if return_ctx:
            return ctx
        if tp is None:
            return dense(ctx, self.out, dt)
        # row-parallel: this rank's partial product, summed over the model group
        partial = F.linear(ctx.to(dt), self.out.weight.to(dt))
        return reduce_from_model(partial, tp) + self.out.bias.to(dt)


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
        tp = _tp(self.config)
        if tp is not None:
            return self._tensor_parallel(hidden, attn_bias, deterministic, seeds, rate, tp)
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

    def _tensor_parallel(self, hidden, attn_bias, deterministic, seeds, rate, tp):
        """Megatron's layer on this rank's slices (module docstring); the
        seeds are drawn in the order of the other path."""
        dt = self.dtype
        attn = self.attention(hidden, attn_bias, deterministic, seeds)
        attn = hash_dropout(attn, _draw(seeds, rate), rate)
        x = self.attention_ln(hidden + attn)
        up = F.linear(copy_to_model(x, tp).to(dt), self.intermediate.weight.to(dt),
                      self.intermediate.bias.to(dt))
        partial = F.linear(F.gelu(up), self.output.weight.to(dt))
        y = reduce_from_model(partial, tp) + self.output.bias.to(dt)
        y = hash_dropout(y, _draw(seeds, rate), rate)
        return self.output_ln(x + y)


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
        t = input_ids.shape[1]
        ids = input_ids.long()
        # Every lookup's gradient sums an id's rows in a fixed order (the
        # library's embedding backward does not on the card): the positions
        # of a BERT window are the table's first t rows, and the token type
        # is always 0, so those two are broadcast slices of their tables.
        if cfg.flavor == "roberta":
            # HF create_position_ids_from_input_ids: pads keep padding_idx,
            # other positions count from padding_idx + 1.
            not_pad = (ids != cfg.pad_token_id).long()
            position_ids = torch.cumsum(not_pad, dim=1) * not_pad + cfg.pad_token_id
            pos = embedding_lookup(self.position_embeddings.weight, position_ids)
        else:
            pos = self.position_embeddings.weight[:t]
        hidden = (embedding_lookup(self.word_embeddings.weight, ids) + pos
                  + self.token_type_embeddings.weight[0])
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
        value = torch.as_tensor(get(theirs))
        # a tensor-parallel encoder takes its slice of each split weight
        value = local_part(value, split_axis("bert_model." + ours, value.ndim),
                           encoder.config.mesh)
        assign(encoder.get_parameter(ours), value, theirs)
