"""RoBERTa's counts: BERT's encoder over windows of ``x.window`` tokens, each
framed by two more positions (``<s>``, ``</s>``; 512 for RoBERTa-base's
510-token windows).

Model FLOPs of a forward, per window: the Q, K, V and output projections,
``QK^T`` and ``PV`` over all of its positions, the FFN.
"""

from __future__ import annotations

import dataclasses

BF16, F32 = 2, 4


@dataclasses.dataclass(frozen=True)
class Sizes:
    hidden: int
    layers: int
    heads: int
    intermediate: int

    @property
    def width(self) -> int:
        return self.hidden


def sizes(model: dict) -> Sizes:
    return Sizes(hidden=model["hidden_size"], layers=model["num_hidden_layers"],
                 heads=model["num_attention_heads"], intermediate=model["intermediate_size"])


def _windows(x) -> tuple[int, int]:
    """``(sequences, positions a sequence)`` of the framed windows."""
    return x.b * (x.tokens // x.window), x.window + 2


def forward_flops(m, x) -> float:
    e = m.encoder
    seqs, window = _windows(x)
    n = seqs * window
    d, f = e.hidden, e.intermediate
    per_layer = 2 * n * d * 4 * d + 4 * seqs * window * window * d + 4 * n * d * f
    return e.layers * per_layer


def attention(m, x) -> tuple[float, float]:
    """Attention forward of one layer over every window: Q, K, V read, the
    output written (bf16), the key bias read (fp32 a position), and in
    training the log-sum-exp of each row written (fp32)."""
    e = m.encoder
    seqs, window = _windows(x)
    flops = 4 * seqs * window * window * e.hidden
    nbytes = 4 * seqs * window * e.hidden * BF16 + seqs * window * F32
    if x.train:
        nbytes += seqs * e.heads * window * F32
    return flops, nbytes


def attention_bwd(m, x) -> tuple[float, float]:
    """Attention backward of one layer: ``QK^T`` again, ``dV``, ``dP``,
    ``dQ``, ``dK`` (2.5 forwards); Q, K, V, O, dO and the log-sum-exp read,
    dQ, dK, dV written, the bias's gradient written (fp32)."""
    e = m.encoder
    seqs, window = _windows(x)
    flops = 10 * seqs * window * window * e.hidden
    nbytes = (8 * seqs * window * e.hidden * BF16 + seqs * e.heads * window * F32
              + 2 * seqs * window * F32)
    return flops, nbytes


def _ffn(m, x, saved: bool) -> tuple[float, float]:
    e = m.encoder
    seqs, window = _windows(x)
    n = seqs * window
    d, f = e.hidden, e.intermediate
    flops = 4 * n * d * f
    nbytes = 2 * n * d * BF16 + 2 * d * f * BF16 + (f + 3 * d) * F32
    if saved:  # the residuals of the backward: h1, yhat, 1/sigma
        nbytes += n * f * BF16 + n * d * BF16 + n * F32
    return flops, nbytes


def ffn(m, x) -> tuple[float, float]:
    """The FFN tail of one layer, inference: x, W1, W2 read, y written."""
    return _ffn(m, x, saved=False)


def ffn_saved(m, x) -> tuple[float, float]:
    """The FFN tail of one layer in training, with its saved residuals."""
    return _ffn(m, x, saved=True)


def _layers(m) -> int:
    return m.encoder.layers


KERNELS = {  # kind -> (count function, calls a forward, name pattern)
    "attention": (attention, _layers, "attention_kernel<"),
    "attention_bwd": (attention_bwd, _layers, "attention_bwd_d(q|kv)_kernel<"),
    "ffn": (ffn, _layers, "ffn_(up|down_ln)_kernel<false>"),
    "ffn_saved": (ffn_saved, _layers, "ffn_(up|down_ln)_kernel<true>"),
}
