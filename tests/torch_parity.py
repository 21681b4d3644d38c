"""Shared helpers of the ``test_torch_*`` parity tests.

``JaxDraws`` replays the reference's ``jax.random`` key tree and hands the
draws to the port as torch tensors, through the port's draw interface
(``repro_torch/core/draws.py``):

* round keys: ``split(fold_in(PRNGKey(seed + 1), round), m_real)[row]``
  (``repro/core/engine.py::_round_keys``);
* Astraea rows: ``split(split(row_key, E_m)[e], gamma)[slot]`` per client
  (``repro/core/mediator.py``); FedAvg rows use the row key itself;
* a client update: ``split(key, E)[e]`` -> ``perm_key, *step_keys``;
  ``permutation(perm_key, pad)``; per step ``d1, d2 = split(step_key)``
  and ``bernoulli(d, 0.5, shape)`` (``repro/core/fl.py``,
  ``repro/models/cnn.py``);
* online augmentation: ``fold_in(row_key, AUG_SALT)``, split over the
  slots for Astraea, then ``k_sel, k_flag, k_warp = split(key, 3)``
  (``repro/core/augmentation.py::online_augment_batch``).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.augmentation import AUG_SALT, warp_params
from repro_torch.convert import params_to_jax
from repro_torch.models.cnn import emnist_cnn, init_params


@functools.partial(jax.jit, static_argnames=("epochs", "n", "bsz", "shapes"))
def _client_draws(key, *, epochs, n, bsz, shapes):
    nb = n // bsz

    def keep_masks(step_key):
        d1, d2 = jax.random.split(step_key)
        return (jax.random.bernoulli(d1, 0.5, shapes[0]),
                jax.random.bernoulli(d2, 0.5, shapes[1]))

    def one_epoch(ekey):
        perm_key, *step_keys = jax.random.split(ekey, nb + 1)
        perm = jax.random.permutation(perm_key, n)
        keep1, keep2 = jax.vmap(keep_masks)(jnp.stack(step_keys))
        return perm, keep1, keep2

    outs = [one_epoch(k) for k in jax.random.split(key, epochs)]
    return tuple(jnp.stack(x) for x in zip(*outs))


@functools.partial(jax.jit, static_argnames=("n",))
def aug_draws(key, w, *, n):
    k_sel, k_flag, k_warp = jax.random.split(key, 3)
    logits = jnp.where(w > 0, jnp.log(jnp.maximum(w, 1e-30)), -jnp.inf)
    idx = jax.random.categorical(k_sel, logits, shape=(n,))
    idx = jnp.where(jnp.any(w > 0), idx, 0)
    u = jax.random.uniform(k_flag, (n,))
    mats, trans = warp_params(k_warp, n)
    return idx, u, mats, trans


@functools.partial(jax.jit, static_argnames=("m_real", "e_m", "gamma", "fedavg"))
def _keys(seed, rnd, row, e, slot, *, m_real, e_m, gamma, fedavg):
    """(client key, augmentation key) of one address of the round."""
    base = jax.random.fold_in(jax.random.PRNGKey(seed + 1), rnd)
    row_key = jax.random.split(base, m_real)[row]
    aug_key = jax.random.fold_in(row_key, AUG_SALT)
    if fedavg:
        return row_key, aug_key
    client_key = jax.random.split(jax.random.split(row_key, e_m)[e], gamma)[slot]
    return client_key, jax.random.split(aug_key, gamma)[slot]


def reference_params(num_classes: int, image_size: int, seed: int = 0):
    """He-normal CNN params in the reference's pytree layout (numpy), for
    feeding both packages the same weights without compiling ``init``."""
    return params_to_jax(init_params(emnist_cnn(num_classes, image_size), seed))


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


class JaxClientDraws:
    """One client update's permutations and keep-masks, drawn up front."""

    def __init__(self, key, *, epochs: int, batch: int, n: int, shapes):
        perms, keep1, keep2 = _client_draws(
            key, epochs=epochs, n=n, bsz=batch,
            shapes=tuple(tuple(s) for s in shapes))
        self._perms = np.asarray(perms)
        self._keeps = (np.asarray(keep1), np.asarray(keep2))

    def permutation(self, epoch, n):
        assert n == self._perms.shape[1]
        return _t(self._perms[epoch], np.int64)

    def keep_masks(self, epoch, step, shapes):
        return [_t(k[epoch, step]) for k in self._keeps]


class JaxDraws:
    """The reference's draws for one trainer run (see module docstring).
    ``mode`` is ``"astraea"`` or ``"fedavg"``; ``m_real`` is the number of
    real mediator rows per round (the split count of the round keys)."""

    def __init__(self, *, seed: int, mode: str, m_real: int, gamma: int,
                 mediator_epochs: int, local_epochs: int, batch: int,
                 model, pad: int):
        self.seed, self.mode, self.m_real, self.gamma = seed, mode, m_real, gamma
        self.mediator_epochs, self.local_epochs = mediator_epochs, local_epochs
        self.batch, self.pad = batch, pad
        self.shapes = model.dropout_shapes(batch)

    def _keys(self, rnd, row, e, slot):
        return _keys(self.seed, rnd, row, e, slot, m_real=self.m_real,
                     e_m=self.mediator_epochs, gamma=self.gamma,
                     fedavg=self.mode == "fedavg")

    def client(self, rnd, row, mediator_epoch, slot):
        return JaxClientDraws(self._keys(rnd, row, mediator_epoch, slot)[0],
                              epochs=self.local_epochs, batch=self.batch,
                              n=self.pad, shapes=self.shapes)

    def augment(self, rnd, row, slot, weights):
        key = self._keys(rnd, row, 0, slot)[1]
        w = jnp.asarray(weights.cpu().numpy(), jnp.float32)
        idx, u, mats, trans = aug_draws(key, w, n=int(w.shape[0]))
        return (_t(idx, np.int64), _t(u, np.float32), _t(mats, np.float32),
                _t(trans, np.float32))


def float64_tie_free(counts: np.ndarray, gamma: int, rel: float = 1e-9) -> bool:
    """True when every step of the float64 greedy pass has a unique
    minimum (the runner-up is more than ``rel`` away)."""
    counts = np.asarray(counts, np.float64)
    k, c = counts.shape
    left = list(range(k))
    med = np.zeros(c)
    fill = 0
    while left:
        merged = med[None, :] + counts[left]
        p = merged / np.maximum(merged.sum(-1, keepdims=True), 1e-300)
        with np.errstate(divide="ignore", invalid="ignore"):
            s = np.where(p > 0, p * (np.log(p) + np.log(c)), 0.0).sum(-1)
        order = np.argsort(s, kind="stable")
        if len(left) > 1 and abs(s[order[1]] - s[order[0]]) <= rel * abs(s[order[0]]):
            return False
        pick = left.pop(int(order[0]))
        med = med + counts[pick]
        fill += 1
        if fill == gamma:
            med, fill = np.zeros(c), 0
    return True
