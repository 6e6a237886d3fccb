"""Fused self-attention on packed heads (port of
``vibertgrid_tpu/ops/flash_attention.py``, forward only).

q/k/v arrive as the projection outputs ``[B, T, H·D]`` and the context
leaves in the same layout, so no head transposes exist. On a CUDA tensor
:func:`flash_attention` launches the hand-written kernel in
``csrc/flash_attention.cu``; on a CPU tensor it runs
:func:`attention_reference`, the plain version the kernel is held against.
"""

from __future__ import annotations

import torch

from vibertgrid_tpu_torch.ops import kernels


def attention_reference(q, k, v, bias, sm_scale: float, num_heads: int):
    """Plain twin of the kernel: fp32 ``softmax(q·kᵀ·scale + bias)``, p
    rounded to q's dtype before ``p·v`` as the TPU kernel does, fp32
    accumulation, result in q's dtype.

    q/k/v: ``[B, T, H·D]``; bias: ``[B, T]`` fp32 additive key bias.
    """
    b, t, m = q.shape
    d = m // num_heads
    heads = lambda x: x.float().reshape(b, t, num_heads, d).transpose(1, 2)
    s = torch.matmul(heads(q), heads(k).transpose(-1, -2)) * sm_scale
    s = s + bias.float()[:, None, None, :]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    p = p.to(q.dtype).float()
    out = torch.matmul(p, heads(v))  # [B, H, T, D]
    return out.transpose(1, 2).reshape(b, t, m).to(q.dtype)


def flash_attention(q, k, v, bias, sm_scale: float, num_heads: int, rate: float = 0.0):
    """``softmax(q·kᵀ·scale + bias)·v`` per head on packed ``[B, T, H·D]``.

    ``bias``: ``[B, T]`` fp32, 0 for real keys and −1e9 for masked ones.
    CUDA tensors go through the kernel (T ≤ 512, D ≤ 128, fp32 or bf16);
    CPU tensors through :func:`attention_reference`.
    """
    if rate > 0.0:
        raise NotImplementedError(
            "attention dropout comes with the training slice (ROADMAP Queue 1 item 10)"
        )
    if q.device.type == "cpu":
        return attention_reference(q, k, v, bias, sm_scale, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    kernels.check_inputs("flash_attention", q, k, v, bias)
    b, t, m = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q/k/v dtypes differ")
    if bias.shape != (b, t) or bias.dtype != torch.float32:
        raise ValueError(f"bias must be [B, T] float32, got {bias.shape} {bias.dtype}")
    if m % num_heads or m // num_heads > 128 or t > 512:
        raise ValueError(f"kernel takes T <= 512 and D <= 128, got T={t}, H·D={m}")
    out = torch.empty_like(q)
    lib = kernels.library()
    kernels.LAUNCHES["flash_attention"] += 1
    err = lib.vg_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
        b, t, num_heads, m // num_heads, float(sm_scale),
        kernels.dtype_code(q.dtype), torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check(err, "flash_attention")
    return out
