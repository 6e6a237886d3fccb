"""Fused self-attention on packed heads, forward and backward (port of
``vibertgrid_tpu/ops/flash_attention.py``).

q/k/v arrive as the projection outputs ``[B, T, H·D]`` and the context
leaves in the same layout, so no head transposes exist. :func:`flash_attention`
is differentiable: on CUDA tensors its forward launches
``csrc/flash_attention.cu`` and its backward ``csrc/flash_attention_bwd.cu``;
on CPU tensors they run :func:`attention_reference` and
:func:`attention_backward_reference`, the plain versions the kernels are held
against.

When a gradient will be taken the forward also returns the rows' statistic
``lse = max + log(sum)`` (fp32 ``[B, H, T]``), and the backward rebuilds the
probabilities as ``exp(s − lse)`` with no max, no sum and no divide.
:func:`attention_backward_from_stats` is the plain version of that backward,
step by step; :func:`attention_backward_reference` stays as the statement of
what the TPU kernel computes, and the kernel is held against both.

Attention-probability dropout runs inside the kernels from a stateless hash
(:mod:`vibertgrid_tpu_torch.ops.dropout`): element ``(row, col)`` of head
``(b, h)`` is kept where ``splitmix32(row·Tp + col, seed + b·H + h)`` reaches
``uint32(rate·2³²)``, with ``Tp = round_up(T, 128)`` (the row stride of the
JAX package's padded tile), so the masks match the JAX package's bit for bit
and the backward regenerates them from the seed.
"""

from __future__ import annotations

import numpy as np
import torch

from vibertgrid_tpu_torch.ops import kernels
from vibertgrid_tpu_torch.parallel.collectives import fold_seed
from vibertgrid_tpu_torch.ops.dropout import as_seed, keep_from_bits, seed_i32, splitmix32_i32


def _keep_scale(rate: float) -> float:
    return float(np.float32(1.0 / (1.0 - rate)))


def attention_dropout_mask(b: int, num_heads: int, t: int, seed: int, rate: float,
                           device) -> torch.Tensor:
    """``[B, H, T, T]`` fp32: ``1/(1−rate)`` where a probability is kept,
    else 0."""
    tp = (t + 127) // 128 * 128
    rows = torch.arange(t, dtype=torch.int32, device=device)
    index = rows[:, None] * tp + rows[None, :]
    heads = torch.arange(b * num_heads, dtype=torch.int32, device=device)
    seeds = (heads + seed_i32(seed)).reshape(b, num_heads, 1, 1)  # wrapping int32 add
    keep = keep_from_bits(splitmix32_i32(index, seeds), rate)
    return keep.float() * _keep_scale(rate)


def _heads(x, num_heads):
    b, t, m = x.shape
    return x.float().reshape(b, t, num_heads, m // num_heads).transpose(1, 2)


def _scores(q, k, bias, sm_scale, num_heads):
    s = torch.matmul(_heads(q, num_heads), _heads(k, num_heads).transpose(-1, -2)) * sm_scale
    return s + bias.float()[:, None, None, :]  # [B, H, T, T] fp32


def _softmax_stats(s):
    """Probabilities and ``lse = max + log(sum)`` of fp32 scores."""
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return p / l, (m + torch.log(l)).squeeze(-1)


def _probabilities(q, k, bias, sm_scale, num_heads):
    return _softmax_stats(_scores(q, k, bias, sm_scale, num_heads))[0]


def _packed(x, dtype):
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d).to(dtype)


def attention_reference(q, k, v, bias, sm_scale: float, num_heads: int,
                        seed: int = 0, rate: float = 0.0, return_lse: bool = False):
    """Plain twin of the forward kernel: fp32 ``softmax(q·kᵀ·scale + bias)``,
    dropout of the probabilities, p rounded to q's dtype before ``p·v`` as
    the TPU kernel does, fp32 accumulation, result in q's dtype.

    q/k/v: ``[B, T, H·D]``; bias: ``[B, T]`` fp32 additive key bias. With
    ``return_lse`` also the statistic the backward kernel is handed:
    ``(out, lse)``, ``lse [B, H, T]`` fp32 = logsumexp of the biased scores.
    """
    b, t, _ = q.shape
    p, lse = _softmax_stats(_scores(q, k, bias, sm_scale, num_heads))
    if rate > 0.0:
        p = p * attention_dropout_mask(b, num_heads, t, seed, rate, q.device)
    p = p.to(q.dtype).float()
    out = _packed(torch.matmul(p, _heads(v, num_heads)), q.dtype)
    return (out, lse) if return_lse else out


def attention_backward_reference(q, k, v, bias, d_out, sm_scale: float, num_heads: int,
                                 seed: int = 0, rate: float = 0.0):
    """Plain twin of the backward kernel, the same steps and roundings:
    ``dp = keep ⊙ (do·vᵀ)``, ``delta = rowsum(dp ⊙ p)`` with the un-dropped
    p, ``ds = p ⊙ (dp − delta)`` in fp32; ds and ``keep ⊙ p`` rounded to the
    storage dtype before their products. Returns ``(dq, dk, dv, d_bias)``,
    ``d_bias [B, T]`` fp32 summed over heads and queries."""
    b, t, _ = q.shape
    dt = q.dtype
    p = _probabilities(q, k, bias, sm_scale, num_heads)
    do = _heads(d_out, num_heads)
    dp = torch.matmul(do, _heads(v, num_heads).transpose(-1, -2))
    p_dropped = p
    if rate > 0.0:
        keep = attention_dropout_mask(b, num_heads, t, seed, rate, q.device)
        dp = dp * keep
        p_dropped = p * keep
    delta = (dp * p).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    ds_r = ds.to(dt).float()
    dq = torch.matmul(ds_r, _heads(k, num_heads)) * sm_scale
    dk = torch.matmul(ds_r.transpose(-1, -2), _heads(q, num_heads)) * sm_scale
    dv = torch.matmul(p_dropped.to(dt).float().transpose(-1, -2), do)
    return _packed(dq, dt), _packed(dk, dt), _packed(dv, dt), ds.sum(dim=(1, 2))


def attention_backward_from_stats(q, k, v, bias, d_out, out, lse, sm_scale: float,
                                  num_heads: int, seed: int = 0, rate: float = 0.0):
    """Plain twin of the backward kernel's arithmetic, which starts from the
    forward's ``lse``: ``p = exp(s − lse)`` (no max, no sum, no divide),
    ``dp = keep ⊙ (do·vᵀ)``, ``delta = rowsum(dp ⊙ p)``,
    ``ds = p ⊙ (dp − delta)`` in fp32; the roundings and products of
    :func:`attention_backward_reference`.

    With ``out`` (the forward's result) delta is ``rowsum(do ⊙ out)``
    instead: equal in exact arithmetic, since ``out = (keep ⊙ p)·v``, but it
    carries the rounding of ``out`` and of the forward's probabilities to the
    storage dtype, which in bf16 moves d_bias by twenty times its tolerance
    (tests/test_torch_attention_stats.py). The kernel sums ``dp ⊙ p``; pass
    ``out=None`` for its arithmetic.
    """
    b, t, _ = q.shape
    dt = q.dtype
    p = torch.exp(_scores(q, k, bias, sm_scale, num_heads) - lse[..., None])
    do = _heads(d_out, num_heads)
    dp = torch.matmul(do, _heads(v, num_heads).transpose(-1, -2))
    p_dropped = p
    if rate > 0.0:
        keep = attention_dropout_mask(b, num_heads, t, seed, rate, q.device)
        dp = dp * keep
        p_dropped = p * keep
    if out is None:
        delta = (dp * p).sum(dim=-1, keepdim=True)
    else:
        delta = (do * _heads(out, num_heads)).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    ds_r = ds.to(dt).float()
    dq = torch.matmul(ds_r, _heads(k, num_heads)) * sm_scale
    dk = torch.matmul(ds_r.transpose(-1, -2), _heads(q, num_heads)) * sm_scale
    dv = torch.matmul(p_dropped.to(dt).float().transpose(-1, -2), do)
    return _packed(dq, dt), _packed(dk, dt), _packed(dv, dt), ds.sum(dim=(1, 2))


def _check(q, k, v, bias, num_heads):
    b, t, m = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q/k/v dtypes differ")
    if bias.shape != (b, t) or bias.dtype != torch.float32:
        raise ValueError(f"bias must be [B, T] float32, got {bias.shape} {bias.dtype}")
    if m % num_heads or m // num_heads > 128 or t > 512:
        raise ValueError(f"kernel takes T <= 512 and D <= 128, got T={t}, H·D={m}")


def attention_forward(q, k, v, bias, sm_scale, num_heads, seed, rate, need_lse):
    """The forward without autograd: ``(out, lse)``; ``lse`` is None unless ``need_lse`` (a gradient will
    be taken): the kernel then writes nothing more than ``out``."""
    if q.device.type == "cpu":
        got = attention_reference(q, k, v, bias, sm_scale, num_heads, seed, rate,
                                  return_lse=need_lse)
        return got if need_lse else (got, None)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    kernels.check_inputs("flash_attention", q, k, v, bias)
    _check(q, k, v, bias, num_heads)
    b, t, m = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, num_heads, t), dtype=torch.float32, device=q.device)
           if need_lse else None)
    seed = kernels.seed_tensor(seed, q.device) if rate > 0.0 else None
    lib = kernels.library()
    kernels.LAUNCHES["flash_attention"] += 1
    err = lib.vg_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
        lse.data_ptr() if need_lse else None,
        b, t, num_heads, m // num_heads, float(sm_scale), kernels.dtype_code(q.dtype),
        *kernels.dropout_args(seed, rate, _keep_scale(rate) if rate > 0.0 else 1.0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check(err, "flash_attention")
    return out, lse


def _backward(q, k, v, bias, lse, d_out, sm_scale, num_heads, seed, rate, need_bias):
    if q.device.type == "cpu":
        dq, dk, dv, d_bias = attention_backward_reference(
            q, k, v, bias, d_out, sm_scale, num_heads, seed, rate)
        return dq, dk, dv, (d_bias if need_bias else None)
    d_out = d_out.contiguous()
    kernels.check_inputs("flash_attention_bwd", q, k, v, bias, d_out, lse)
    _check(q, k, v, bias, num_heads)
    if d_out.shape != q.shape or d_out.dtype != q.dtype:
        raise ValueError(f"d_out must match q: {d_out.shape} {d_out.dtype}")
    b, t, m = q.shape
    if lse.shape != (b, num_heads, t) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be [B, H, T] float32, got {lse.shape} {lse.dtype}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    # delta = rowsum(dp * p): written by the dq pass, read by the dk/dv pass
    delta = torch.empty_like(lse)
    part = torch.empty_like(lse) if need_bias else None
    seed = kernels.seed_tensor(seed, q.device) if rate > 0.0 else None
    lib = kernels.library()
    kernels.LAUNCHES["flash_attention_bwd"] += 1
    err = lib.vg_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), d_out.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        part.data_ptr() if need_bias else None, delta.data_ptr(),
        b, t, num_heads, m // num_heads, float(sm_scale), kernels.dtype_code(q.dtype),
        *kernels.dropout_args(seed, rate, _keep_scale(rate) if rate > 0.0 else 1.0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check(err, "flash_attention_bwd")
    return dq, dk, dv, (part.sum(dim=1) if need_bias else None)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, sm_scale, num_heads, seed, rate):
        need_lse = any(ctx.needs_input_grad[:4])
        out, lse = attention_forward(q, k, v, bias, sm_scale, num_heads, seed, rate, need_lse)
        if need_lse:
            ctx.save_for_backward(q, k, v, bias, lse)
        ctx.args = (sm_scale, num_heads, seed, rate)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, bias, lse = ctx.saved_tensors
        dq, dk, dv, d_bias = _backward(
            q, k, v, bias, lse, d_out, *ctx.args, need_bias=ctx.needs_input_grad[3])
        return dq, dk, dv, d_bias, None, None, None, None


def flash_attention(q, k, v, bias, sm_scale: float, num_heads: int, rate: float = 0.0,
                    seed: int = 0):
    """``dropout(softmax(q·kᵀ·scale + bias))·v`` per head on packed
    ``[B, T, H·D]``, differentiable in q, k, v and bias.

    ``bias``: ``[B, T]`` fp32, 0 for real keys and −1e9 for masked ones;
    ``rate``, ``seed``: dropout of the probabilities (none at ``rate=0``).
    CUDA tensors go through the kernels (T ≤ 512, D ≤ 128, fp32 or bf16,
    contiguous); CPU tensors through the plain twins. In a data-parallel
    train step the rank is folded into the seed (``seed + rank·2¹⁶``, the
    JAX package's ``flash_attention_sharded`` with one model shard).
    """
    if rate > 0.0:
        seed = fold_seed(seed)
    return _FlashAttention.apply(q, k, v, bias, float(sm_scale), int(num_heads),
                                 as_seed(seed), float(rate))
