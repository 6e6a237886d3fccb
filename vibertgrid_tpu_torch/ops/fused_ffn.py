"""Fused transformer FFN tail (port of ``fused_ffn`` and ``fused_ffn_saved``
of ``vibertgrid_tpu/ops/fused_ffn.py``).

``LN(x + dropout(gelu_erf(x·W1ᵀ + b1)·W2ᵀ + b2))`` over the rows of
``x [N, D]``, with W1 ``[F, D]`` and W2 ``[D, F]`` in ``nn.Linear`` layout.

- :func:`fused_ffn` is the inference call: one output, not differentiable.
- :func:`fused_ffn_saved` is the training call: its forward also writes the
  pre-gelu intermediate ``h1``, the normalised rows ``yhat`` and each row's
  inverse deviation ``rsig``, and its backward is four matrix products plus
  elementwise arithmetic on those, with no rematerialisation (as the JAX
  package's, which is plain XLA there and plain PyTorch here).

On CUDA tensors both forwards launch ``csrc/fused_ffn.cu``; on CPU tensors
they run :func:`ffn_reference` and :func:`ffn_saved_reference`, the plain
versions the kernel is held against. Dropout keeps element ``(row, col)``
where ``splitmix32(row·D + col, seed)`` reaches ``uint32(rate·2³²)`` and
divides kept values by ``1 − rate``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vibertgrid_tpu_torch.ops import kernels
from vibertgrid_tpu_torch.ops.dropout import keep_mask

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


def gelu_grad_f32(z: torch.Tensor) -> torch.Tensor:
    """d/dz gelu_exact(z) = Φ(z) + z·φ(z).

    Φ comes from ``torch.erf``, not from :func:`erf_f32`: the backward is no
    kernel's twin, the two differ by at most 6e-7, and one library pass over
    the ``[N, F]`` intermediate replaces the polynomial's twenty-odd."""
    phi = torch.exp(-0.5 * z * z) * (1.0 / math.sqrt(2.0 * math.pi))
    cdf = 0.5 * (1.0 + torch.erf(z * (1.0 / math.sqrt(2.0))))
    return cdf + z * phi


def _keep_div(rate: float) -> float:
    return float(np.float32(1.0 - rate))


def _dropout(out: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Dropout of the fp32 ``[N, D]`` second product: kept / (1 − rate)."""
    keep = keep_mask(out.shape, seed, rate, out.device)
    return torch.where(keep, out / _keep_div(rate), torch.zeros((), device=out.device))


def ffn_saved_reference(x, w1, b1, w2, b2, ln_scale, ln_bias, eps: float,
                        seed: int = 0, rate: float = 0.0):
    """Plain twin of the saved-residual kernel: ``(y, h1, yhat, rsig)``.

    ``x`` in the compute dtype, W1/W2 cast to it; products accumulate in
    fp32; gelu takes the unrounded fp32 ``h1`` and its output is rounded to
    the compute dtype before the second product; biases, dropout and the
    LayerNorm (variance E[x²]−E[x]²) are fp32. ``h1`` and ``yhat`` are
    returned in the compute dtype, ``rsig [N, 1]`` in fp32."""
    dt = x.dtype
    xf = x.float()
    h1 = xf @ w1.to(dt).float().t() + b1.float()
    inter = gelu_exact_f32(h1).to(dt).float()
    out = inter @ w2.to(dt).float().t() + b2.float()
    if rate > 0.0:
        out = _dropout(out, seed, rate)
    res = xf + out
    mean = res.mean(dim=-1, keepdim=True)
    var = (res * res).mean(dim=-1, keepdim=True) - mean * mean
    rsig = torch.rsqrt(var + eps)
    yhat = (res - mean) * rsig
    y = (yhat * ln_scale.float() + ln_bias.float()).to(dt)
    return y, h1.to(dt), yhat.to(dt), rsig


def ffn_reference(x, w1, b1, w2, b2, ln_scale, ln_bias, eps: float,
                  seed: int = 0, rate: float = 0.0):
    """Plain twin of the inference kernel: ``y`` of :func:`ffn_saved_reference`."""
    return ffn_saved_reference(x, w1, b1, w2, b2, ln_scale, ln_bias, eps, seed, rate)[0]


def _launch(x, w1, b1, w2, b2, ln_scale, ln_bias, eps, seed, rate, saved: bool):
    name = "fused_ffn_saved" if saved else "fused_ffn"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    kernels.check_inputs(name, x, w1, b1, w2, b2, ln_scale, ln_bias)
    n, d = x.shape
    f = w1.shape[0]
    if w1.shape != (f, d) or w2.shape != (d, f):
        raise ValueError(f"W1 must be [F, D] and W2 [D, F]: {w1.shape} {w2.shape}")
    if w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise TypeError("W1 and W2 must be in x's dtype")
    for pname, p, size in (("b1", b1, f), ("b2", b2, d), ("ln_scale", ln_scale, d),
                           ("ln_bias", ln_bias, d)):
        if p.shape != (size,) or p.dtype != torch.float32:
            raise ValueError(f"{pname} must be float32 [{size}], got {p.dtype} {tuple(p.shape)}")
    if d not in (64, 128, 256, 512, 768) or f % 128:
        raise ValueError(f"kernel takes D in (64, 128, 256, 512, 768) and F % 128 == 0: {d}, {f}")
    out = torch.empty_like(x)
    h1 = yhat = rsig = None
    if saved:
        h1 = torch.empty((n, f), dtype=x.dtype, device=x.device)
        yhat = torch.empty_like(x)
        rsig = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = kernels.library()
    kernels.LAUNCHES[name] += 1
    err = lib.vg_fused_ffn(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        ln_scale.data_ptr(), ln_bias.data_ptr(), out.data_ptr(), ptr(h1), ptr(yhat), ptr(rsig),
        n, d, f, float(eps), kernels.dtype_code(x.dtype),
        *kernels.dropout_args(seed, rate, _keep_div(rate)),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernels.check(err, name)
    return out, h1, yhat, rsig


def fused_ffn(x, w1, b1, w2, b2, ln_scale, ln_bias, eps: float, rate: float = 0.0,
              seed: int = 0):
    """Fused GEMM→gelu→GEMM→dropout→residual→LayerNorm on ``x [N, D]``,
    for inference: it keeps nothing for a backward pass and raises where a
    gradient is asked of it (training calls :func:`fused_ffn_saved`).

    CUDA tensors go through the kernel (D in {64, 128, 256, 512, 768}, F a
    multiple of 128, W1/W2 in x's dtype, biases and LN params fp32); CPU
    tensors through :func:`ffn_reference`.
    """
    args = (x, w1, b1, w2, b2, ln_scale, ln_bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError(
            "fused_ffn is the inference kernel and has no backward: call it under "
            "torch.no_grad(), or use fused_ffn_saved on a gradient path"
        )
    if x.device.type == "cpu":
        return ffn_reference(*args, eps, seed, rate)
    return _launch(*args, eps, seed, rate, saved=False)[0]


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an fp32 result: fp32 accumulation of the (bf16 or
    fp32) operands, not rounded to their dtype on the way out."""
    if a.dtype == torch.float32:
        return a @ b
    if a.device.type == "cpu":
        return a.float() @ b.float()
    return torch.mm(a, b, out_dtype=torch.float32)


class _FusedFFNSaved(torch.autograd.Function):
    """Takes the fp32 parameters and casts W1/W2 to x's dtype itself, so the
    weight gradients leave in fp32 without a rounding to the compute dtype."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, ln_scale, ln_bias, eps, seed, rate):
        dt = x.dtype
        w1c, w2c = w1.to(dt), w2.to(dt)
        if x.device.type == "cpu":
            y, h1, yhat, rsig = ffn_saved_reference(
                x, w1c, b1, w2c, b2, ln_scale, ln_bias, eps, seed, rate)
        else:
            y, h1, yhat, rsig = _launch(
                x, w1c, b1.float(), w2c, b2.float(), ln_scale.float(), ln_bias.float(),
                eps, seed, rate, saved=True)
        ctx.save_for_backward(x, h1, yhat, rsig, w1c, w2c, ln_scale)
        ctx.args = (seed, rate)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, h1, yhat, rsig, w1c, w2c, ln_scale = ctx.saved_tensors
        seed, rate = ctx.args
        dt = x.dtype
        dyf, yhatf = dy.float(), yhat.float()
        # LayerNorm backward from the saved normalised rows and inverse deviation.
        dg = (dyf * yhatf).sum(dim=0)
        dbt = dyf.sum(dim=0)
        dyg = dyf * ln_scale.float()
        m1 = dyg.mean(dim=-1, keepdim=True)
        m2 = (dyg * yhatf).mean(dim=-1, keepdim=True)
        dr = rsig * (dyg - m1 - yhatf * m2)  # [N, D] fp32
        do = _dropout(dr, seed, rate) if rate > 0.0 else dr  # the same keep mask
        db2 = do.sum(dim=0)
        # gelu and its derivative from the saved (rounded) h1; the library's
        # erf gelu, for the reason gelu_grad_f32 gives.
        h1f = h1.float()
        a = torch.nn.functional.gelu(h1f).to(dt)
        do_dt = do.to(dt)
        dw2 = _mm_f32(do_dt.t(), a)          # [D, F]
        da = _mm_f32(do_dt, w2c)             # [N, F]
        dh1 = da * gelu_grad_f32(h1f)
        db1 = dh1.sum(dim=0)
        dh1_dt = dh1.to(dt)
        dw1 = _mm_f32(dh1_dt.t(), x)         # [F, D]
        dx = (_mm_f32(dh1_dt, w1c) + dr).to(dt)
        return dx, dw1, db1, dw2, db2, dg, dbt, None, None, None


def fused_ffn_saved(x, w1, b1, w2, b2, ln_scale, ln_bias, eps: float, rate: float = 0.0,
                    seed: int = 0):
    """:func:`fused_ffn` for gradient paths: the same forward arithmetic,
    differentiable in all seven tensors. ``w1``/``w2`` may be the fp32
    parameters (they are cast to x's dtype inside); their gradients are fp32.
    """
    return _FusedFFNSaved.apply(x, w1, b1, w2, b2, ln_scale, ln_bias, float(eps),
                                int(seed), float(rate))
