"""Fused transformer FFN tail (port of the inference ``fused_ffn`` of
``vibertgrid_tpu/ops/fused_ffn.py``).

``LN(x + gelu_erf(x·W1ᵀ + b1)·W2ᵀ + b2)`` over the rows of ``x [N, D]``,
with W1 ``[F, D]`` and W2 ``[D, F]`` in ``nn.Linear`` layout. On a CUDA
tensor :func:`fused_ffn` launches ``csrc/fused_ffn.cu``; on a CPU tensor it
runs :func:`ffn_reference`, the plain version the kernel is held against.
"""

from __future__ import annotations

import math

import torch

from vibertgrid_tpu_torch.ops import kernels

_ERF_CLIP = 3.832506856900711
_ERF_P = (
    2.77068142495902e-08, -2.10102402082508e-06, -5.69250639462346e-05,
    -7.34990630326855e-04, -2.95459980854025e-03, -1.60960333262415e-02,
)
_ERF_Q = (
    -2.13374055278905e-04, -1.68282697438203e-03, -7.37332916720468e-03,
    -1.42647390514189e-02,
)


def erf_f32(x: torch.Tensor) -> torch.Tensor:
    """fp32 erf as the rational x·P(x²)/Q(x²) the JAX package's kernel uses
    (``_erf_f32``; within 6e-7 of erf), so the twin and the kernel agree
    with it to summation order."""
    x = x.clamp(-_ERF_CLIP, _ERF_CLIP)
    z = x * x
    a = torch.full_like(x, -2.72614225801306e-10)
    for c in _ERF_P:
        a = a * z + c
    a = a * x
    b = torch.full_like(x, -1.45660718464996e-05)
    for c in _ERF_Q:
        b = b * z + c
    return a / b


def gelu_exact_f32(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + erf_f32(x * (1.0 / math.sqrt(2.0))))


def ffn_reference(x, w1, b1, w2, b2, ln_scale, ln_bias, eps: float):
    """Plain twin of the kernel. ``x`` in the compute dtype, W1/W2 cast to
    it; products accumulate in fp32, the gelu output is rounded to the
    compute dtype before the second product, biases and the LayerNorm
    (variance E[x²]−E[x]²) are fp32."""
    dt = x.dtype
    xf = x.float()
    inter = xf @ w1.to(dt).float().t() + b1.float()
    inter = gelu_exact_f32(inter).to(dt).float()
    res = xf + (inter @ w2.to(dt).float().t() + b2.float())
    mean = res.mean(dim=-1, keepdim=True)
    var = (res * res).mean(dim=-1, keepdim=True) - mean * mean
    y = (res - mean) * torch.rsqrt(var + eps)
    return (y * ln_scale.float() + ln_bias.float()).to(dt)


def fused_ffn(x, w1, b1, w2, b2, ln_scale, ln_bias, eps: float, rate: float = 0.0):
    """Fused GEMM→gelu→GEMM→residual→LayerNorm on ``x [N, D]``.

    CUDA tensors go through the kernel (D in {64, 128, 256, 512, 768}, F a
    multiple of 128, W1/W2 in x's dtype, biases and LN params fp32); CPU
    tensors through :func:`ffn_reference`.
    """
    if rate > 0.0:
        raise NotImplementedError(
            "FFN dropout comes with the training slice (ROADMAP Queue 1 item 10)"
        )
    if x.device.type == "cpu":
        return ffn_reference(x, w1, b1, w2, b2, ln_scale, ln_bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn: unsupported device {x.device}")
    kernels.check_inputs("fused_ffn", x, w1, b1, w2, b2, ln_scale, ln_bias)
    n, d = x.shape
    f = w1.shape[0]
    if w1.shape != (f, d) or w2.shape != (d, f):
        raise ValueError(f"W1 must be [F, D] and W2 [D, F]: {w1.shape} {w2.shape}")
    if w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise TypeError("W1 and W2 must be in x's dtype")
    for name, p, size in (("b1", b1, f), ("b2", b2, d), ("ln_scale", ln_scale, d),
                          ("ln_bias", ln_bias, d)):
        if p.shape != (size,) or p.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [{size}], got {p.dtype} {tuple(p.shape)}")
    if d not in (64, 128, 256, 512, 768) or f % 128:
        raise ValueError(f"kernel takes D in (64, 128, 256, 512, 768) and F % 128 == 0: {d}, {f}")
    out = torch.empty_like(x)
    lib = kernels.library()
    kernels.LAUNCHES["fused_ffn"] += 1
    err = lib.vg_fused_ffn(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        ln_scale.data_ptr(), ln_bias.data_ptr(), out.data_ptr(), n, d, f, float(eps),
        kernels.dtype_code(x.dtype), torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernels.check(err, "fused_ffn")
    return out
