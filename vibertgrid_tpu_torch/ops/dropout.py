"""Counter-based dropout (port of ``vibertgrid_tpu/ops/dropout.py``).

The keep decision for an element is a splitmix32 hash of (seed, flat element
index), so a mask is a pure function of an int32 seed: the backward pass
regenerates it instead of storing it, the attention and FFN kernels draw the
same bits in ``csrc/common.cuh::splitmix32``, and the masks are bit-identical
to the JAX package's for a given seed.

PyTorch has no unsigned 32-bit arithmetic, so the hash runs in wrapping
int32: multiplies wrap as uint32 multiplies do, the logical right shifts are
arithmetic shifts with the sign extension masked off, and unsigned
comparisons flip the sign bit of both sides.

Every random site takes an explicit seed (see
:class:`vibertgrid_tpu_torch.train.seeds.SeedStream`): an int, or in a train
step a 0-d int32 tensor on the device, its slot of the step's seed tensor
(:class:`vibertgrid_tpu_torch.train.seeds.DeviceSeeds`), which a replayed
CUDA graph refills; both give the same masks. The JAX package's
``derive_seed`` draws from a threefry key and has no counterpart here.

In a data-parallel train step :func:`hash_dropout` counts from this rank's
offset in the global flat index, as the JAX package's one program hashes
the index of the global array; the in-kernel dropouts fold the rank into
their seed instead (``parallel/collectives.py::fold_seed``).
"""

from __future__ import annotations

import math

import torch

from vibertgrid_tpu_torch.parallel.collectives import index_base

_M32 = 0xFFFFFFFF
_INT_MIN = -(2**31)


def _i32(value: int) -> int:
    """The Python int whose int32 bit pattern is ``value mod 2³²``."""
    value &= _M32
    return value - 2**32 if value >= 2**31 else value


def as_seed(seed):
    """A site's seed as the ops take it: a tensor seed as it is, else an int."""
    return seed if isinstance(seed, torch.Tensor) else int(seed)


def seed_i32(seed):
    """The int32 bit pattern of a seed: an int (:func:`_i32`), or an int32
    tensor for a tensor seed."""
    return seed.to(torch.int32) if isinstance(seed, torch.Tensor) else _i32(int(seed))


def _lsr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns."""
    return (x >> n) & ((1 << (32 - n)) - 1)


def splitmix32_i32(x: torch.Tensor, seed) -> torch.Tensor:
    """Splitmix32 finalizer of (seed, counter) on int32 bit patterns.

    ``x``: int32 counters; ``seed``: a Python int (any int32/uint32 value)
    or an int32 tensor that broadcasts against ``x``. Returns int32 bit
    patterns of the uint32 hash.
    """
    if isinstance(seed, torch.Tensor):
        mixed = seed.to(torch.int32) * _i32(0x9E3779B9)
    else:
        mixed = _i32((int(seed) & _M32) * 0x9E3779B9)
    x = x ^ mixed
    x = (x ^ _lsr(x, 16)) * _i32(0x7FEB352D)
    x = (x ^ _lsr(x, 15)) * _i32(0x846CA68B)
    return x ^ _lsr(x, 16)


def splitmix32(x: torch.Tensor, seed) -> torch.Tensor:
    """The hash as int64 values in ``[0, 2³²)``, ordered as uint32."""
    return splitmix32_i32(x.to(torch.int32), seed).to(torch.int64) & _M32


def dropout_threshold(rate: float) -> int:
    """Elements whose hash is below ``int(rate·2³²)`` are dropped."""
    return int(rate * float(2**32))


def keep_from_bits(bits_i32: torch.Tensor, rate: float) -> torch.Tensor:
    """Bool keep mask: ``uint32(bits) >= uint32(rate·2³²)``."""
    return (bits_i32 ^ _INT_MIN) >= _i32(dropout_threshold(rate) ^ 0x80000000)


def flat_index(n: int, device, base=0) -> torch.Tensor:
    """``[n]`` int32 counters ``base + i`` (wrapping); ``base``: an int or a
    0-d int64 tensor (a rank's offset in the global flat index)."""
    counters = torch.arange(n, dtype=torch.int32, device=device)
    if isinstance(base, torch.Tensor):
        counters += base.to(torch.int32)
    elif base:
        counters += _i32(base)
    return counters


def keep_mask(shape, seed, rate: float, device, base=0) -> torch.Tensor:
    """Bool keep mask of ``shape``, hashed over the row-major flat index
    counted from ``base`` (an int or a 0-d int64 tensor)."""
    counters = flat_index(math.prod(shape), device, base)
    return keep_from_bits(splitmix32_i32(counters, seed), rate).reshape(tuple(shape))


def _apply(x: torch.Tensor, seed, rate: float, base) -> torch.Tensor:
    # 1/(1 - rate) rounded to x's dtype, on the host: the factor is built on
    # the device from the mask and a Python scalar, with no copy from the host
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=x.dtype).item()
    keep = keep_mask(x.shape, seed, rate, x.device, base)
    return x * keep.to(x.dtype).mul_(scale)


class _HashDropout(torch.autograd.Function):
    """Saves only the seed and the index base; the backward pass regenerates
    the mask."""

    @staticmethod
    def forward(ctx, x, seed, rate):
        base = index_base(x.numel(), x.device)
        ctx.seed, ctx.rate, ctx.base = seed, rate, base
        return _apply(x, seed, rate, base)

    @staticmethod
    def backward(ctx, grad):
        return _apply(grad, ctx.seed, ctx.rate, ctx.base), None, None


def hash_dropout(x: torch.Tensor, seed, rate: float) -> torch.Tensor:
    """Dropout with a counter-based mask: ``x · keep / (1 − rate)``.

    ``seed``: int32 value, distinct for each call site (an int, or a 0-d
    int32 tensor on x's device); ``rate`` in [0, 1).
    In a data-parallel step the mask is this rank's rows of the mask of the
    ranks' arrays concatenated.
    """
    if rate <= 0.0:
        return x
    return _HashDropout.apply(x, as_seed(seed), float(rate))
