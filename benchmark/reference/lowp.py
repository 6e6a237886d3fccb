"""The control's precision: every product of the reference computed from fp8
operands.

Inside :func:`fp8_products` each operand of a matrix product or a
convolution (``F.linear``, ``F.conv2d``, ``torch.matmul``, ``torch.mm``,
``torch.bmm``, ``torch.einsum``, ``@``) is rounded to ``float8_e4m3fn`` under a
per-tensor scale (its largest magnitude onto 448) before the product, which
then accumulates in the operands' own type, as an fp8 tensor core accumulates
in fp32. A gradient flowing back through the rounding is rounded to
``float8_e5m2`` (scale onto 57344), the usual pair for fp8 training. This is
the step below bf16 that the configuration states.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    if not x.is_floating_point():
        return x
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / top
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, E5M2_MAX)


def fp8(x):
    return _Fp8.apply(x) if isinstance(x, torch.Tensor) and x.is_floating_point() else x


@contextlib.contextmanager
def fp8_products():
    saved = {(F, "linear"): F.linear, (F, "conv2d"): F.conv2d,
             (torch, "matmul"): torch.matmul, (torch, "mm"): torch.mm,
             (torch, "bmm"): torch.bmm, (torch, "einsum"): torch.einsum,
             (torch.Tensor, "__matmul__"): torch.Tensor.__matmul__}

    def linear(x, w, b=None):
        return saved[(F, "linear")](fp8(x), fp8(w), b)

    def conv2d(x, w, b=None, *args, **kwargs):
        return saved[(F, "conv2d")](fp8(x), fp8(w), b, *args, **kwargs)

    def two(key):
        return lambda a, b, *args, **kwargs: saved[key](fp8(a), fp8(b), *args, **kwargs)

    def einsum(eq, *ops):
        if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
            ops = tuple(ops[0])
        return saved[(torch, "einsum")](eq, *(fp8(o) for o in ops))

    patched = {(F, "linear"): linear, (F, "conv2d"): conv2d,
               (torch, "matmul"): two((torch, "matmul")), (torch, "mm"): two((torch, "mm")),
               (torch, "bmm"): two((torch, "bmm")), (torch, "einsum"): einsum,
               (torch.Tensor, "__matmul__"): two((torch.Tensor, "__matmul__"))}
    try:
        for (owner, name), fn in patched.items():
            setattr(owner, name, fn)
        yield
    finally:
        for (owner, name), fn in saved.items():
            setattr(owner, name, fn)
