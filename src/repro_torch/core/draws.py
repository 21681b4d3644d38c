"""Where the round's random numbers come from.

torch cannot replay ``jax.random``, so every draw of the round is asked
for through a small interface, addressed by where it happens:

* ``RoundDraws.client(round, row, mediator_epoch, slot)`` -> the
  ``ClientDraws`` of one client update: per epoch, the batch permutation
  and the dropout keep-masks of all its steps;
* ``RoundDraws.augment(round, row, slot, weights)`` -> the online Alg. 2
  draws of one padded client batch: source indices ``idx`` (categorical
  over ``weights``), uniforms ``u`` (warp-or-not), and the warp's
  ``mats``/``trans``;
* ``RoundDraws.rebalance(client, n)`` -> the materialized Alg. 2 draws of
  one client: the seed of its numpy ``Generator`` (the shuffle) and its
  ``n`` augmentations' warp ``mats``/``trans``.

Keep-masks come one per dropout site, each at its site's keep probability
``1 - rate`` (``model.dropout_sites``), an epoch's steps at once: ``(steps,
*site)``.

``SeededDraws`` is the port's own source: a ``torch.Generator`` per
address, seeded from ``(seed, round, row, ...)``, so a run is
reproducible and no draw depends on the order rows run in.  Tests pass an
implementation that replays the reference's ``jax.random`` key splits.
"""
from __future__ import annotations

from typing import Protocol, Sequence

import numpy as np
import torch

from repro_torch.core.augmentation import warp_params
from repro_torch.models.cnn import Site

_CLIENT, _AUG, _REBAL = 0x636C, 0x617567, 0x7262    # "cl", "aug", "rb": salts


class ClientDraws(Protocol):
    def permutation(self, epoch: int, n: int) -> torch.Tensor: ...

    def epoch_keep_masks(self, epoch: int, steps: int,
                         sites: Sequence[Site]) -> list[torch.Tensor]: ...


class RoundDraws(Protocol):
    def client(self, rnd: int, row: int, mediator_epoch: int,
               slot: int) -> ClientDraws: ...

    def augment(self, rnd: int, row: int, slot: int, weights: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]: ...

    def rebalance(self, client: int, n: int
                  ) -> tuple[int, torch.Tensor, torch.Tensor]: ...


class SeededDraws:
    """Draws from ``torch.Generator``s seeded per address."""

    def __init__(self, seed: int, device: torch.device | str = "cpu"):
        self.seed, self.device = seed, torch.device(device)

    def generator(self, *address: int) -> torch.Generator:
        state = np.random.SeedSequence([self.seed, *address]).generate_state(
            2, np.uint32)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(state[0]) << 32 | int(state[1]))
        return gen

    def client(self, rnd, row, mediator_epoch, slot) -> "_SeededClient":
        return _SeededClient(self, (_CLIENT, rnd, row, mediator_epoch, slot))

    def augment(self, rnd, row, slot, weights):
        gen = self.generator(_AUG, rnd, row, slot)
        n = weights.shape[0]
        if bool((weights > 0).any()):
            idx = torch.multinomial(weights, n, replacement=True, generator=gen)
        else:                   # all-padding slot: pinned to row 0, masked
            idx = torch.zeros(n, dtype=torch.int64, device=self.device)
        u = torch.rand(n, generator=gen, device=self.device)
        mats, trans = warp_params(n, generator=gen, device=self.device)
        return idx, u, mats, trans

    def rebalance(self, client, n):
        gen = self.generator(_REBAL, client)
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen,
                                 device=self.device))
        mats, trans = warp_params(n, generator=gen, device=self.device)
        return seed, mats, trans


class _SeededClient:
    def __init__(self, owner: SeededDraws, address: tuple[int, ...]):
        self.owner, self.address = owner, address

    def permutation(self, epoch, n):
        gen = self.owner.generator(*self.address, epoch)
        return torch.randperm(n, generator=gen, device=self.owner.device)

    def epoch_keep_masks(self, epoch, steps, sites):
        gen = self.owner.generator(*self.address, epoch, 1)
        return [torch.rand((steps,) + tuple(shape), generator=gen,
                           device=self.owner.device) >= rate for shape, rate in sites]


class EmptySlotDraws:
    """The draws of a client update whose mask is all zero (an empty slot):
    the identity permutation and every unit kept.  Its gradients are zero
    whatever it draws, so it asks the round's source for nothing, as the
    lockstep rows ask for no draw of an inactive slot."""

    def __init__(self, device: torch.device | str = "cpu"):
        self.device = torch.device(device)

    def permutation(self, epoch, n):
        return torch.arange(n, device=self.device)

    def epoch_keep_masks(self, epoch, steps, sites):
        return [torch.ones((steps,) + tuple(shape), dtype=torch.bool,
                           device=self.device) for shape, _ in sites]
