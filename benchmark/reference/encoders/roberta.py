"""RoBERTa over windows of ``model.window_tokens`` tokens (510 for
RoBERTa-base's 514 positions), each framed by ``<s>`` and ``</s>``."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.model import DROPOUT, _linear, _ln, attention_keep, dropout

LN_EPS = 1e-12        # the encoder's LayerNorm epsilon, BERT's published value


def encoder(P, ids, amask, seeds, heads: int):
    """RoBERTa over ``[N, T]`` framed windows → ``[N, T, D]``, training
    (dropout on)."""
    e = "bert_model."
    n, t = ids.shape
    not_pad = (ids != 1).long()  # positions count from the padding id (1) + 1
    pos = torch.cumsum(not_pad, 1) * not_pad + 1
    x = (F.embedding(ids.long(), P[e + "word_embeddings.weight"])
         + F.embedding(pos, P[e + "position_embeddings.weight"])
         + P[e + "token_type_embeddings.weight"][0])
    x = dropout(_ln(P, e + "embeddings_ln", x, LN_EPS), seeds.next())
    bias = torch.where(amask.bool(), 0.0, -1e9)[:, None, None, :]
    d = x.shape[-1]
    dh = d // heads
    split = lambda y: y.reshape(n, t, heads, dh).transpose(1, 2)
    i = 0
    while f"{e}layer.{i}.attention.query.weight" in P:
        L = f"{e}layer.{i}."
        q, k, v = (split(_linear(P, L + "attention." + m, x)) for m in ("query", "key", "value"))
        p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh) + bias, dim=-1)
        p = p * attention_keep(n, heads, t, seeds.next(), x.device) / (1.0 - DROPOUT)
        ctx = torch.matmul(p, v).transpose(1, 2).reshape(n, t, d)
        a = dropout(_linear(P, L + "attention.out", ctx), seeds.next())
        x = _ln(P, L + "attention_ln", x + a, LN_EPS)
        f = _linear(P, L + "output", F.gelu(_linear(P, L + "intermediate", x)))
        x = _ln(P, L + "output_ln", x + dropout(f, seeds.next()), LN_EPS)
        i += 1
    return x


def frame(tokens, token_mask, cfg: dict) -> dict:
    """``[B, W·window]`` → ``[B·W, window + 2]`` ids and mask: ``<s>``
    first, then the window's tokens, ``</s>`` right after the batch's
    longest document's share of the window (a window past it holds ``</s>``
    alone)."""
    window = cfg["model"]["window_tokens"]
    cls_id, sep_id = cfg["cls_sep"]
    b, t = tokens.shape
    w = t // window
    seq_len = int(token_mask.sum(1).max())
    ids = torch.zeros((b * w, window + 2), dtype=torch.int64, device=tokens.device)
    mask = torch.zeros_like(ids)
    ids[:, 1:-1] = tokens.reshape(b * w, window)
    mask[:, 1:-1] = token_mask.reshape(b * w, window)
    ids[:, 0], mask[:, 0] = cls_id, 1
    for j in range(w):
        at = 1 + min(max(seq_len - j * window, 0), window)
        ids[j::w, at], mask[j::w, at] = sep_id, 1
    return {"ids": ids, "mask": mask, "documents": b}


def encode(P, framed: dict, seeds, cfg: dict):
    """The framed windows' token states, ``<s>`` and ``</s>`` dropped, as
    ``[B, W·window, D]``."""
    tok = encoder(P, framed["ids"], framed["mask"], seeds, cfg["model"]["num_attention_heads"])
    return tok[:, 1:-1].reshape(framed["documents"], -1, tok.shape[-1])
