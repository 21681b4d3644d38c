"""Synchronous single-device FL round engine (Astraea and FedAvg).

One engine drives both algorithms, as in the reference
(``repro/core/engine.py``):

* **Astraea**: KLD-greedy Alg. 3 schedule, up to ``gamma`` clients per
  mediator trained sequentially for ``E_m`` mediator epochs, Eq. 6 over
  the mediator weight *deltas*, folded into the weights.
* **FedAvg**: ``gamma=1``, a fresh random singleton schedule every round,
  Eq. 6 over the clients' *weights*, which replace the model.

The client tensors are packed once onto the device, padded to a multiple
of the batch size (the replicated store).  A schedule is an ``(M_pad,
gamma)`` gather index plus a 0/1 slot mask; rows past the real mediators
are dummies with zero Eq. 6 weight.  Client selection draws from
``np.random.default_rng(cfg.seed).choice``, the reference's stream, so the
selections, schedules and WAN ledger equal the reference's.

The path through the kernels: Alg. 3 is one ``kld_greedy_picks`` launch per
reschedule; the online Alg. 2 warp is one ``affine_warp`` launch per round
over every scheduled slot; Eq. 6 is one ``fedavg_agg`` launch per round
(``fedavg_agg_tree``).  Mediator rows run one after another; a dummy row or
an empty slot is an exact no-op and is skipped.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import scheduling
from repro_torch.core.augmentation import online_augment_rows
from repro_torch.core.comm import CommMeter
from repro_torch.core.draws import RoundDraws, SeededDraws
from repro_torch.core.fl import LocalSpec, LossFn, client_update, evaluate
from repro_torch.core.mediator import mediator_update
from repro_torch.data.federated import FederatedDataset
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.cnn import Params, count_params
from repro_torch.models.cnn import init_params as seeded_params
from repro_torch.optim.optimizers import Optimizer


def _pad_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclass(frozen=True)
class EngineConfig:
    """Static round configuration; ``astraea()``/``fedavg()`` build the two
    canonical settings."""
    clients_per_round: int                  # c
    gamma: int                              # max clients per mediator
    local: LocalSpec                        # B, E
    mediator_epochs: int = 1                # E_m
    schedule: str = "kld"                   # "kld" (Alg. 3) | "random"
    aggregate: str = "delta"                # "delta" (Astraea) | "weights" (FedAvg)
    reschedule_every_round: bool = False
    # floor for the padded mediator count (dummy rows carry zero weight)
    pad_mediators_to: int | None = None
    seed: int = 0

    def __post_init__(self):
        if self.schedule not in ("kld", "random"):
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if self.aggregate not in ("delta", "weights"):
            raise ValueError(f"unknown aggregate {self.aggregate!r}")
        if self.aggregate == "weights" and self.gamma != 1:
            raise ValueError("weight aggregation implies gamma=1 (FedAvg)")
        if self.pad_mediators_to is not None and self.pad_mediators_to < 1:
            raise ValueError("pad_mediators_to must be >= 1")

    @classmethod
    def astraea(cls, *, clients_per_round: int, gamma: int, local: LocalSpec,
                mediator_epochs: int = 1, **kw) -> "EngineConfig":
        return cls(clients_per_round=clients_per_round, gamma=gamma,
                   local=local, mediator_epochs=mediator_epochs,
                   schedule="kld", aggregate="delta", **kw)

    @classmethod
    def fedavg(cls, *, clients_per_round: int, local: LocalSpec,
               **kw) -> "EngineConfig":
        kw.setdefault("reschedule_every_round", True)
        return cls(clients_per_round=clients_per_round, gamma=1, local=local,
                   schedule="random", aggregate="weights", **kw)


class FLRoundEngine:
    """Single-device round executor (see module docstring).

    ``init_params`` (a state-dict-keyed dict) replaces the seeded He init;
    ``draws`` replaces the seeded ``torch.Generator`` draws
    (``core/draws.py``); ``loss_fn(model, params, x, y, mask, keep)``
    replaces the masked cross-entropy of local training (``core/fl.py``)."""

    def __init__(self, model, opt: Optimizer, data: FederatedDataset,
                 cfg: EngineConfig, *, aug_plan: np.ndarray | None = None,
                 device: str | torch.device | None = None,
                 init_params: Params | None = None,
                 draws: RoundDraws | None = None,
                 loss_fn: LossFn | None = None):
        self.model, self.opt, self.data, self.cfg = model, opt, data, cfg
        self.loss_fn = loss_fn
        self.device = dev = resolve_device(device)
        sizes = [x.shape[0] for x in data.client_images]
        self.pad = _pad_multiple(max(sizes), cfg.local.batch_size)
        xs, ys, mask = data.padded(self.pad)
        self._xs = torch.from_numpy(xs).to(dev)
        self._ys = torch.from_numpy(ys).to(dev)
        self._mask = torch.from_numpy(mask).to(dev)
        self._test_x = torch.from_numpy(np.asarray(data.test_images, np.float32)).to(dev)
        self._test_y = torch.from_numpy(np.asarray(data.test_labels)).to(dev)
        self._raw_counts = data.client_counts()
        self._counts = self._raw_counts
        self._rng = np.random.default_rng(cfg.seed)
        if init_params is None:
            init = seeded_params(model, cfg.seed, dev)
        else:
            init = {k: torch.as_tensor(v, dtype=torch.float32).to(dev).contiguous()
                    for k, v in init_params.items()}
        self.params: Params = init
        self.comm = CommMeter(count_params(self.params))
        self.draws = draws if draws is not None else SeededDraws(cfg.seed + 1, dev)

        self._plan = None
        if aug_plan is not None:
            plan_np = np.asarray(aug_plan)
            if plan_np.shape != (data.num_classes,):
                raise ValueError(
                    f"aug_plan shape {plan_np.shape} != ({data.num_classes},)")
            self._plan = torch.as_tensor(plan_np, dtype=torch.float32, device=dev)
            # Alg. 3 packs by the expected post-augmentation histograms
            self._counts = self._raw_counts * (1.0 + plan_np.astype(np.float64))
            self.comm.plan_broadcast(plan_np.size, data.num_clients)
        self.history: list[dict] = []
        self.last_schedule_stats: dict | None = None
        self.last_groups: list[list[int]] | None = None
        self._schedule: tuple | None = None
        self._round = 0

    # ------------------------------------------------------------------
    # scheduling (host side: tiny integer work)
    # ------------------------------------------------------------------
    def _groups_for(self, sel: np.ndarray) -> list[list[int]]:
        cfg = self.cfg
        if cfg.schedule == "kld":
            meds = scheduling.reschedule(self._counts[sel], cfg.gamma,
                                         device=self.device)
            self.last_schedule_stats = scheduling.schedule_stats(meds)
            return [[int(sel[i]) for i in m.clients] for m in meds]
        if cfg.gamma == 1:          # FedAvg: selection order, one client each
            self.last_schedule_stats = None
            return [[int(k)] for k in sel]
        meds = scheduling.random_schedule(len(sel), cfg.gamma, self._counts[sel],
                                          seed=cfg.seed + self._round)
        self.last_schedule_stats = scheduling.schedule_stats(meds)
        return [[int(sel[i]) for i in m.clients] for m in meds]

    def _pack_schedule(self, sel: np.ndarray) -> tuple:
        groups = self._groups_for(sel)
        self.last_groups = groups
        m_real = len(groups)
        m_pad = self.cfg.pad_mediators_to or m_real
        if m_pad < m_real:
            raise ValueError(f"pad_mediators_to={m_pad} smaller than the "
                             f"schedule ({m_real} mediators)")
        idx = np.zeros((m_pad, self.cfg.gamma), np.int64)
        slot = np.zeros((m_pad, self.cfg.gamma), np.float32)
        for r, g in enumerate(groups):
            idx[r, :len(g)] = g
            slot[r, :len(g)] = 1.0
        return idx, slot, m_real

    def ensure_schedule(self) -> tuple:
        """(Re)draw the selection and (re)pack the schedule if this round
        needs one: every round for FedAvg, once for Astraea."""
        cfg = self.cfg
        c = min(cfg.clients_per_round, self.data.num_clients)
        if cfg.reschedule_every_round or self._schedule is None:
            sel = self._rng.choice(self.data.num_clients, size=c, replace=False)
            self._schedule = self._pack_schedule(sel)
        return self._schedule

    # ------------------------------------------------------------------
    # the round
    # ------------------------------------------------------------------
    def _augment(self, xs, ys, weights):
        """Online Alg. 2 over every (row, slot) batch in one warp launch.
        ``xs (R, pad, H, W, C)``, ``ys``/``weights (R, pad)`` with rows
        ordered (mediator row, slot)."""
        gamma = 1 if self.cfg.aggregate == "weights" else self.cfg.gamma
        draws = [self.draws.augment(self._round, i // gamma, i % gamma,
                                    weights[i]) for i in range(ys.shape[0])]
        idx, u, mats, trans = (torch.stack([d[j] for d in draws]) for j in range(4))
        return online_augment_rows(xs, ys, self._plan, idx, u,
                                   mats.reshape(-1, 2, 2), trans.reshape(-1, 2))

    def run_round(self) -> None:
        cfg = self.cfg
        c = min(cfg.clients_per_round, self.data.num_clients)
        idx_np, slot_np, m_real = self.ensure_schedule()
        m_pad, gamma = idx_np.shape
        idx = torch.as_tensor(idx_np, device=self.device)
        slot = torch.as_tensor(slot_np, device=self.device)
        xs, ys = self._xs[idx], self._ys[idx]               # (M, gamma, pad, ...)
        ms = self._mask[idx] * slot[..., None]
        mult = ms if self._plan is None else ms * (1.0 + self._plan[ys.long()])
        weights = mult.sum(dim=(1, 2))                      # Eq. 6 sizes
        if self._plan is not None:
            flat = (m_pad * gamma, self.pad)
            ax, ay = self._augment(xs.reshape(flat + xs.shape[3:]),
                                   ys.reshape(flat), mult.reshape(flat))
            xs, ys = ax.reshape(xs.shape), ay.reshape(ys.shape)

        stacked = {k: torch.zeros((m_pad,) + p.shape, dtype=p.dtype,
                                  device=self.device)
                   for k, p in self.params.items()}
        for r in range(m_real):
            if cfg.aggregate == "weights":
                out = client_update(self.model, self.opt, cfg.local, self.params,
                                    xs[r, 0], ys[r, 0], ms[r, 0],
                                    self.draws.client(self._round, r, 0, 0),
                                    self.loss_fn)
            else:
                out = mediator_update(
                    self.model, self.opt, cfg.local, cfg.mediator_epochs,
                    self.params, xs[r], ys[r], ms[r],
                    lambda e, s, r=r: self.draws.client(self._round, r, e, s),
                    active=slot_np[r] > 0, loss_fn=self.loss_fn)
            for k, v in out.items():
                stacked[k][r] = v
        agg = ops.fedavg_agg_tree(stacked, weights)
        if cfg.aggregate == "weights":
            self.params = agg
            self.comm.fedavg_round(c)
        else:
            self.params = {k: self.params[k] + agg[k] for k in self.params}
            self.comm.astraea_round(c, cfg.gamma, cfg.mediator_epochs)
        self.comm.end_round()
        self._round += 1

    def evaluate(self) -> dict:
        """Test-set metrics now, with the history keys."""
        m = evaluate(self.model, self.params, self._test_x, self._test_y)
        m.update(round=self._round, traffic_mb=self.comm.megabytes)
        if self.last_schedule_stats and "kld_mean" in self.last_schedule_stats:
            m["mediator_kld_mean"] = self.last_schedule_stats["kld_mean"]
        return m

    def fit(self, rounds: int, eval_every: int = 10) -> list[dict]:
        for _ in range(rounds):
            self.run_round()
            if self._round % eval_every == 0 or self._round == rounds:
                self.history.append(self.evaluate())
        return self.history

