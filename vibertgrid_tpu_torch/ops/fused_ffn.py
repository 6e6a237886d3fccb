"""Fused transformer FFN tail and fused attention epilogue (port of
``fused_ffn``, ``fused_ffn_saved`` and ``fused_proj_ln`` of
``vibertgrid_tpu/ops/fused_ffn.py``).

``LN(x + dropout(gelu_erf(x·W1ᵀ + b1)·W2ᵀ + b2))`` over the rows of
``x [N, D]``, with W1 ``[F, D]`` and W2 ``[D, F]`` in ``nn.Linear`` layout.

- :func:`fused_ffn` runs the residual-free kernel: one output. Its backward
  rematerialises the intermediates, two more matrix products.
- :func:`fused_ffn_saved` runs the saved-residual kernel: its forward also
  writes the pre-gelu intermediate ``h1``, the normalised rows ``yhat`` and
  each row's inverse deviation ``rsig``, and its backward is four matrix
  products plus elementwise arithmetic on those, with no rematerialisation
  (as the JAX package's, which is plain XLA there and plain PyTorch here).
- :func:`fused_proj_ln` is the attention epilogue
  ``LN(res + dropout(ctx·Wᵀ + b))``; its backward rematerialises too.

On CUDA tensors the FFN forwards launch ``csrc/fused_ffn.cu`` (in bf16 at
D = 768 two kernels a call: an up-projection with gelu into an ``[N, F]``
scratch, then the down-projection with the residual LayerNorm) and the
epilogue ``csrc/fused_proj_ln.cu`` (in bf16 at D = 768 that same
down-projection kernel with the context as ``h`` and K = 768, one launch a
call); on CPU tensors they run
:func:`ffn_reference`, :func:`ffn_saved_reference` (the composition of
:func:`ffn_up_reference` and :func:`ffn_down_ln_reference`) and
:func:`proj_ln_reference`, the plain versions the kernels are held against.
Dropout keeps element ``(row, col)`` where ``splitmix32(row·D + col, seed)``
reaches ``uint32(rate·2³²)`` and divides kept values by ``1 − rate``. In a
data-parallel train step the public wrappers fold the rank into the seed
(``seed + rank·2¹⁶``), as the JAX package's ``*_sharded`` wrappers fold the
data shard in.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vibertgrid_tpu_torch.ops import kernels
from vibertgrid_tpu_torch.ops.dropout import as_seed, keep_mask
from vibertgrid_tpu_torch.parallel.collectives import fold_seed

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


def _ln_stats(res: torch.Tensor, eps: float):
    """Normalised rows and inverse deviation of fp32 ``res [N, D]``, variance
    E[x²]−E[x]² as every LayerNorm of the model."""
    mean = res.mean(dim=-1, keepdim=True)
    rsig = torch.rsqrt((res * res).mean(dim=-1, keepdim=True) - mean * mean + eps)
    return (res - mean) * rsig, rsig


def ffn_up_reference(x, w1, b1):
    """Plain twin of the up-projection: ``(h, h1)``, both in x's dtype.

    ``h1 = x·W1ᵀ + b1`` accumulates in fp32 (W1 cast to x's dtype); gelu takes
    the unrounded fp32 ``h1``, and ``h = gelu(h1)`` is rounded to x's dtype,
    the operand of the second product."""
    dt = x.dtype
    h1 = x.float() @ w1.to(dt).float().t() + b1.float()
    return gelu_exact_f32(h1).to(dt), h1.to(dt)


def ffn_down_ln_reference(h, x, w2, b2, ln_scale, ln_bias, eps: float, seed: int = 0,
                          rate: float = 0.0):
    """Plain twin of the down-projection with the residual LayerNorm:
    ``(y, yhat, rsig)`` of ``LN(x + dropout(h·W2ᵀ + b2))``.

    The product accumulates in fp32 (W2 cast to x's dtype); bias, dropout
    (flat index ``row·D + col``), residual and the LayerNorm (variance
    E[x²]−E[x]²) are fp32. ``y`` and ``yhat`` are returned in x's dtype,
    ``rsig [N, 1]`` in fp32."""
    dt = x.dtype
    out = h.float() @ w2.to(dt).float().t() + b2.float()
    if rate > 0.0:
        out = _dropout(out, seed, rate)
    yhat, rsig = _ln_stats(x.float() + out, eps)
    y = (yhat * ln_scale.float() + ln_bias.float()).to(dt)
    return y, yhat.to(dt), rsig


def ffn_saved_reference(x, w1, b1, w2, b2, ln_scale, ln_bias, eps: float,
                        seed: int = 0, rate: float = 0.0):
    """Plain twin of the saved-residual kernel: ``(y, h1, yhat, rsig)``, the
    composition of :func:`ffn_up_reference` and :func:`ffn_down_ln_reference`
    (the two launches of the kernel's wgmma body)."""
    h, h1 = ffn_up_reference(x, w1, b1)
    y, yhat, rsig = ffn_down_ln_reference(h, x, w2, b2, ln_scale, ln_bias, eps, seed, rate)
    return y, h1, yhat, rsig


def ffn_reference(x, w1, b1, w2, b2, ln_scale, ln_bias, eps: float,
                  seed: int = 0, rate: float = 0.0):
    """Plain twin of the inference kernel: ``y`` of :func:`ffn_saved_reference`."""
    return ffn_saved_reference(x, w1, b1, w2, b2, ln_scale, ln_bias, eps, seed, rate)[0]


def _launch(x, w1, b1, w2, b2, ln_scale, ln_bias, eps, seed, rate, saved: bool, h=None):
    """One call of the kernel: ``(y, h1, yhat, rsig)``, the last three None
    unless ``saved``. bf16 at D = 768 runs the wgmma body, whose up-projection
    writes ``bf16(gelu(h1))`` into an ``[N, F]`` scratch for the
    down-projection: ``h`` if given (so a check can read it), else a
    transient ``torch.empty``."""
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
    if x.dtype == torch.bfloat16 and d == 768:
        if h is None:
            h = torch.empty((n, f), dtype=x.dtype, device=x.device)
        kernels.check_inputs(name, x, h)
        if h.shape != (n, f) or h.dtype != x.dtype:
            raise ValueError(f"h must be {x.dtype} [{n}, {f}], got {h.dtype} {tuple(h.shape)}")
    else:
        h = None
    out = torch.empty_like(x)
    h1 = yhat = rsig = None
    if saved:
        h1 = torch.empty((n, f), dtype=x.dtype, device=x.device)
        yhat = torch.empty_like(x)
        rsig = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    seed = kernels.seed_tensor(seed, x.device) if rate > 0.0 else None
    lib = kernels.library()
    kernels.LAUNCHES[name] += 1
    err = lib.vg_fused_ffn(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        ln_scale.data_ptr(), ln_bias.data_ptr(), out.data_ptr(), ptr(h1), ptr(yhat), ptr(rsig),
        ptr(h), n, d, f, float(eps), kernels.dtype_code(x.dtype),
        *kernels.dropout_args(seed, rate, _keep_div(rate)),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernels.check(err, name)
    return out, h1, yhat, rsig


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an fp32 result: fp32 accumulation of the (bf16 or
    fp32) operands, not rounded to their dtype on the way out."""
    if a.dtype == torch.float32:
        return a @ b
    if a.device.type == "cpu":
        return a.float() @ b.float()
    return torch.mm(a, b, out_dtype=torch.float32)


def _ln_backward(dy, yhat, rsig, ln_scale):
    """LayerNorm backward from the normalised rows and the inverse deviation:
    fp32 ``(d_input [N, D], d_scale [D], d_bias [D])``."""
    dyf, yhatf = dy.float(), yhat.float()
    dyg = dyf * ln_scale.float()
    m1 = dyg.mean(dim=-1, keepdim=True)
    m2 = (dyg * yhatf).mean(dim=-1, keepdim=True)
    return rsig * (dyg - m1 - yhatf * m2), (dyf * yhatf).sum(dim=0), dyf.sum(dim=0)


def ffn_backward(dy, x, h1, yhat, rsig, w1c, w2c, ln_scale, seed: int, rate: float):
    """Gradients of the FFN tail from its residuals (``h1``, ``yhat`` in the
    compute dtype, ``rsig`` fp32) and the weights in the compute dtype: four
    matrix products plus elementwise arithmetic, plain PyTorch as the JAX
    package's is plain XLA. Returns ``(dx, dw1, db1, dw2, db2, dg, dbt)``,
    ``dx`` in x's dtype and the parameters' gradients in fp32."""
    dt = x.dtype
    dr, dg, dbt = _ln_backward(dy, yhat, rsig, ln_scale)
    do = _dropout(dr, seed, rate) if rate > 0.0 else dr  # the same keep mask
    db2 = do.sum(dim=0)
    # gelu and its derivative from the (rounded) h1; the library's erf gelu,
    # for the reason gelu_grad_f32 gives.
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
    return dx, dw1, db1, dw2, db2, dg, dbt


def _forward(x, w1c, b1, w2c, b2, ln_scale, ln_bias, eps, seed, rate, saved: bool):
    """``(y, h1, yhat, rsig)`` from the kernel (CUDA) or its twin (CPU); the
    last three are None from the residual-free kernel."""
    if x.device.type == "cpu":
        out = ffn_saved_reference(x, w1c, b1, w2c, b2, ln_scale, ln_bias, eps, seed, rate)
        return out if saved else (out[0], None, None, None)
    return _launch(x, w1c, b1.float(), w2c, b2.float(), ln_scale.float(), ln_bias.float(),
                   eps, seed, rate, saved=saved)


class _FusedFFNSaved(torch.autograd.Function):
    """Takes the fp32 parameters and casts W1/W2 to x's dtype itself, so the
    weight gradients leave in fp32 without a rounding to the compute dtype."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, ln_scale, ln_bias, eps, seed, rate):
        w1c, w2c = w1.to(x.dtype), w2.to(x.dtype)
        y, h1, yhat, rsig = _forward(x, w1c, b1, w2c, b2, ln_scale, ln_bias, eps, seed, rate,
                                     saved=True)
        ctx.save_for_backward(x, h1, yhat, rsig, w1c, w2c, ln_scale)
        ctx.args = (seed, rate)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, h1, yhat, rsig, w1c, w2c, ln_scale = ctx.saved_tensors
        return (*ffn_backward(dy, x, h1, yhat, rsig, w1c, w2c, ln_scale, *ctx.args),
                None, None, None)


class _FusedFFNRemat(torch.autograd.Function):
    """The residual-free kernel with a rematerialising backward: it keeps only
    its inputs, and the backward recomputes ``h1``, ``yhat`` and ``rsig`` in
    plain PyTorch (two more matrix products) before the arithmetic it shares
    with :class:`_FusedFFNSaved`."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, ln_scale, ln_bias, eps, seed, rate):
        w1c, w2c = w1.to(x.dtype), w2.to(x.dtype)
        y = _forward(x, w1c, b1, w2c, b2, ln_scale, ln_bias, eps, seed, rate, saved=False)[0]
        ctx.save_for_backward(x, w1c, b1, w2c, b2, ln_scale)
        ctx.args = (eps, seed, rate)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w1c, b1, w2c, b2, ln_scale = ctx.saved_tensors
        eps, seed, rate = ctx.args
        dt = x.dtype
        h1 = _mm_f32(x, w1c.t()) + b1.float()
        out = _mm_f32(torch.nn.functional.gelu(h1).to(dt), w2c.t()) + b2.float()
        if rate > 0.0:
            out = _dropout(out, seed, rate)
        yhat, rsig = _ln_stats(x.float() + out, eps)
        return (*ffn_backward(dy, x, h1.to(dt), yhat.to(dt), rsig, w1c, w2c, ln_scale, seed, rate),
                None, None, None)


def fused_ffn(x, w1, b1, w2, b2, ln_scale, ln_bias, eps: float, rate: float = 0.0,
              seed: int = 0):
    """Fused GEMM→gelu→GEMM→dropout→residual→LayerNorm on ``x [N, D]`` through
    the residual-free kernel. Where a gradient is asked of it, its backward
    rematerialises the forward's intermediates (the JAX package's VJP of
    ``fused_ffn``); :func:`fused_ffn_saved` gives the same gradients without
    the two extra products, for the memory of ``h1`` and ``yhat``.

    ``w1``/``w2`` may be the fp32 parameters (cast to x's dtype inside; their
    gradients are fp32). CUDA tensors go through the kernel (D in {64, 128,
    256, 512, 768}, F a multiple of 128, biases and LN params fp32 ``[F]`` /
    ``[D]``); CPU tensors through :func:`ffn_reference`.
    """
    if rate > 0.0:
        seed = fold_seed(seed)
    return _FusedFFNRemat.apply(x, w1, b1, w2, b2, ln_scale, ln_bias, float(eps), as_seed(seed),
                                float(rate))


def fused_ffn_saved(x, w1, b1, w2, b2, ln_scale, ln_bias, eps: float, rate: float = 0.0,
                    seed: int = 0):
    """:func:`fused_ffn` through the saved-residual kernel: the same forward
    arithmetic, and a backward that needs no rematerialisation.
    """
    if rate > 0.0:
        seed = fold_seed(seed)
    return _FusedFFNSaved.apply(x, w1, b1, w2, b2, ln_scale, ln_bias, float(eps),
                                as_seed(seed), float(rate))


# ---------------------------------------------------------------------------
# Fused attention epilogue: out-projection → dropout → residual → LayerNorm.
# ---------------------------------------------------------------------------


def proj_ln_reference(ctx, res, w, b, ln_scale, ln_bias, eps: float, seed: int = 0,
                      rate: float = 0.0):
    """Plain twin of the epilogue kernel: ``LN(res + dropout(ctx·Wᵀ + b))``
    over rows of ``ctx``, ``res`` ``[N, D]`` in the compute dtype, W ``[D, D]``
    in ``nn.Linear`` layout cast to it; the product accumulates in fp32, and
    bias, dropout (flat index ``row·D + col``), residual and LayerNorm
    (variance E[x²]−E[x]²) are fp32: :func:`ffn_down_ln_reference`'s ``y``
    with ``h = ctx``, ``x = res`` and ``W2 = W``, as the kernel is the
    down-projection's."""
    return ffn_down_ln_reference(ctx, res, w, b, ln_scale, ln_bias, eps, seed, rate)[0]


def _launch_proj_ln(ctx, res, w, b, ln_scale, ln_bias, eps, seed, rate):
    name = "fused_proj_ln"
    if ctx.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {ctx.device}")
    kernels.check_inputs(name, ctx, res, w, b, ln_scale, ln_bias)
    n, d = ctx.shape
    if res.shape != (n, d) or w.shape != (d, d):
        raise ValueError(f"res must be [N, D] and W [D, D]: {res.shape} {w.shape}")
    if res.dtype != ctx.dtype or w.dtype != ctx.dtype:
        raise TypeError("res and W must be in ctx's dtype")
    for pname, p in (("b", b), ("ln_scale", ln_scale), ("ln_bias", ln_bias)):
        if p.shape != (d,) or p.dtype != torch.float32:
            raise ValueError(f"{pname} must be float32 [{d}], got {p.dtype} {tuple(p.shape)}")
    if d not in (64, 128, 256, 512, 768):
        raise ValueError(f"kernel takes D in (64, 128, 256, 512, 768): {d}")
    out = torch.empty_like(ctx)
    seed = kernels.seed_tensor(seed, ctx.device) if rate > 0.0 else None
    lib = kernels.library()
    kernels.LAUNCHES[name] += 1
    err = lib.vg_fused_proj_ln(
        ctx.data_ptr(), res.data_ptr(), w.data_ptr(), b.data_ptr(), ln_scale.data_ptr(),
        ln_bias.data_ptr(), out.data_ptr(), n, d, float(eps), kernels.dtype_code(ctx.dtype),
        *kernels.dropout_args(seed, rate, _keep_div(rate)),
        torch.cuda.current_stream(ctx.device).cuda_stream,
    )
    kernels.check(err, name)
    return out


class _FusedProjLN(torch.autograd.Function):
    """Takes the fp32 parameters and casts W to ctx's dtype itself, so ``dW``
    leaves in fp32. Keeps only its inputs: the backward rematerialises the
    projection with the same keep mask, in plain PyTorch (the JAX package's
    backward is the VJP of the plain formulation)."""

    @staticmethod
    def forward(fctx, ctx, res, w, b, ln_scale, ln_bias, eps, seed, rate):
        wc = w.to(ctx.dtype)
        if ctx.device.type == "cpu":
            y = proj_ln_reference(ctx, res, wc, b, ln_scale, ln_bias, eps, seed, rate)
        else:
            y = _launch_proj_ln(ctx, res, wc, b.float(), ln_scale.float(), ln_bias.float(),
                                eps, seed, rate)
        fctx.save_for_backward(ctx, res, wc, b, ln_scale)
        fctx.args = (eps, seed, rate)
        return y

    @staticmethod
    def backward(fctx, dy):
        ctx, res, wc, b, ln_scale = fctx.saved_tensors
        eps, seed, rate = fctx.args
        dt = ctx.dtype
        out = _mm_f32(ctx, wc.t()) + b.float()
        if rate > 0.0:
            out = _dropout(out, seed, rate)
        yhat, rsig = _ln_stats(res.float() + out, eps)
        dr, dg, dbt = _ln_backward(dy, yhat, rsig, ln_scale)
        do = _dropout(dr, seed, rate) if rate > 0.0 else dr  # the same keep mask
        do_dt = do.to(dt)
        dw = _mm_f32(do_dt.t(), ctx)      # [D_out, D_in]
        dctx = _mm_f32(do_dt, wc).to(dt)
        return dctx, dr.to(dt), dw, do.sum(dim=0), dg, dbt, None, None, None


def fused_proj_ln(ctx, res, w, b, ln_scale, ln_bias, eps: float, rate: float = 0.0,
                  seed: int = 0):
    """Fused GEMM→dropout→residual→LayerNorm, the attention epilogue:
    ``ctx [N, D]`` the attention context rows, ``res [N, D]`` the residual
    stream, W ``[D, D]`` and ``b`` the out-projection (W may be the fp32
    parameter), differentiable in all six tensors.

    CUDA tensors go through the kernel (D in {64, 128, 256, 512, 768}, any N,
    ``b`` and LN params fp32 ``[D]``) or raise; CPU tensors through
    :func:`proj_ln_reference`."""
    if rate > 0.0:
        seed = fold_seed(seed)
    return _FusedProjLN.apply(ctx, res, w, b, ln_scale, ln_bias, float(eps), as_seed(seed),
                              float(rate))
