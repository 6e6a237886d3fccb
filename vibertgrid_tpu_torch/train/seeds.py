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
"""

from __future__ import annotations

from typing import Iterable

import torch

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
