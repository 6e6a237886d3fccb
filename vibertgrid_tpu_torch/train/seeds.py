"""Seeds for the random sites of a training forward.

Every random site of the port (each dropout, each sampled loss) takes an
explicit int32 seed and hashes its own element indices with it
(:mod:`vibertgrid_tpu_torch.ops.dropout`). A :class:`SeedStream` hands those
seeds out in call order from a CPU ``torch.Generator``, so drawing them
never waits for the device. It takes the place of flax's
``make_rng("dropout")`` and of the PRNG keys the JAX package's heads take.

The order of the draws in one training forward of
:class:`~vibertgrid_tpu_torch.models.vibertgrid.ViBERTgridNet`:

1. the text encoder: the embedding dropout; then for each layer in turn the
   attention-probability dropout, the attention-output dropout (the fused
   epilogue draws it where the unfused one does) and the FFN dropout (a site
   whose rate is 0 draws nothing);
2. the auxiliary segmentation head. Simplified: the random-sample loss, then
   the OHEM loss (2 draws). Two-stage, with the full and CRF classifiers:
   the random-sample loss, then one per class 1..C−1 for the binary OHEM
   losses (1 + (C−1) draws);
3. the field-type head. Simplified: the pos/neg OHEM loss, then the class
   OHEM loss (2 draws). Full: the gate's random-sample loss, then one per
   class 1..C−1 for the binary OHEM losses (1 + (C−1) draws). CRF: none.

The train step hands its sites their seeds on the device
(:class:`DeviceSeeds`): it draws the step's seeds from its stream on the
host, in the order above, and copies them in one int32 tensor to the device
(:func:`upload`); site *i* reads slot *i*. The masks are those of the int
seeds, and a CUDA graph of the step reads the slots its replay refills.
"""

from __future__ import annotations

from typing import Iterable

import torch

from vibertgrid_tpu_torch.ops.dropout import _i32

_INT32_MAX = 2**31 - 1


class SeedStream:
    """``next()`` → a fresh seed in ``[0, 2³¹−1)`` from a seeded CPU generator."""

    def __init__(self, seed: int = 0):
        self._generator = torch.Generator(device="cpu").manual_seed(seed)

    def next(self) -> int:
        return int(torch.randint(0, _INT32_MAX, (), generator=self._generator))


def step_seeds(seed: int, step: int) -> SeedStream:
    """The seed stream of train step ``step`` of a run seeded with ``seed``:
    a function of the two alone (the counterpart of
    ``jax.random.fold_in(key, state.step)``), so a run resumed from a
    checkpoint draws the seeds that a run without the break would have."""
    return SeedStream(((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))


class ReplaySeeds:
    """A stream that replays a given list of seeds, then raises: for tests
    that must give each site a known seed."""

    def __init__(self, seeds: Iterable[int]):
        self._seeds = list(seeds)
        self._at = 0

    def next(self) -> int:
        if self._at >= len(self._seeds):
            raise IndexError(f"ReplaySeeds: only {len(self._seeds)} seeds were given")
        self._at += 1
        return self._seeds[self._at - 1]


class DeviceSeeds:
    """A train step's seeds as its sites read them: ``next()`` → the next
    slot of ``slots`` (an int32 tensor, one slot a draw), a 0-d view."""

    def __init__(self, slots: torch.Tensor):
        self.slots = slots
        self.drawn = 0

    def next(self) -> torch.Tensor:
        if self.drawn >= self.slots.numel():
            raise IndexError(f"DeviceSeeds: the step has {self.slots.numel()} seeds")
        self.drawn += 1
        return self.slots[self.drawn - 1]


def upload(seeds, count: int, device, out: torch.Tensor | None = None) -> torch.Tensor:
    """The next ``count`` draws of ``seeds`` (``next() -> int``) as int32
    (wrapped) in one tensor on ``device``: slot *i* is the *i*-th draw. On
    the card they are copied from pinned memory without waiting, into
    ``out`` when given (a CUDA graph's static seeds)."""
    host = torch.tensor([_i32(seeds.next()) for _ in range(count)], dtype=torch.int32)
    device = torch.device(device)
    if device.type != "cuda":
        host = host.to(device)
        return host if out is None else out.copy_(host)
    host = host.pin_memory()
    if out is None:
        return host.to(device, non_blocking=True)
    return out.copy_(host, non_blocking=True)
