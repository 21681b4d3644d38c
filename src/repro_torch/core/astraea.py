"""The Astraea server: rebalance -> reschedule -> train -> aggregate.

Paper Fig. 3: clients report label histograms; the server computes the
Alg. 2 plan from the global distribution (online mode: the resample + warp
runs inside each round, nothing is materialized); each round the selected
clients are packed into mediators of <= gamma clients by Alg. 3, every
mediator trains its clients sequentially for E_m epochs, and Eq. 6
averages the mediator deltas with weights n_m / n.

The trainer presents the reference's arguments (``repro/core/astraea.py``)
where they apply to a synchronous single-device engine, plus ``device``,
``init_params`` and ``draws`` (see ``core/engine.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.augmentation import AUG_MODES, augmentation_plan
from repro_torch.core.engine import EngineConfig, FLRoundEngine
from repro_torch.core.fl import LocalSpec
from repro_torch.data.federated import FederatedDataset
from repro_torch.optim.optimizers import Optimizer


def online_plan(data: FederatedDataset, alpha: float | None,
                aug_mode: str | None) -> tuple[np.ndarray | None, np.ndarray | None]:
    """Resolve Alg. 2 for both trainers: ``(plan, engine_plan)``.  ``alpha``
    None or ``aug_mode`` None disables augmentation; an all-zero plan
    hands the engine no plan (nothing to augment)."""
    if aug_mode not in AUG_MODES:
        raise ValueError(f"unknown aug_mode {aug_mode!r}; this port runs "
                         f"{AUG_MODES}")
    if alpha is None or aug_mode is None:
        return None, None
    plan = augmentation_plan(data.client_counts().sum(axis=0), alpha)
    return plan, (plan if plan.any() else None)


@dataclass
class AstraeaTrainer:
    model: object
    opt: Optimizer
    data: FederatedDataset
    clients_per_round: int                  # c
    gamma: int                              # max clients per mediator
    local: LocalSpec                        # B, E
    mediator_epochs: int = 1                # E_m
    alpha: float | None = 0.67              # augmentation factor; None = NoAug
    aug_mode: str | None = "online"         # "online" | None
    reschedule_every_round: bool = False    # static client data -> schedule once
    # padded mediator count; defaults to ceil(c / gamma), Alg. 3's output size
    pad_mediators_to: int | None = None
    seed: int = 0
    device: object = None                   # None = the CUDA device
    init_params: dict | None = None
    draws: object = None
    history: list[dict] = field(default_factory=list)

    def __post_init__(self):
        self.augmentation_plan, engine_plan = online_plan(
            self.data, self.alpha, self.aug_mode)
        c_eff = min(self.clients_per_round, self.data.num_clients)
        pad_m = self.pad_mediators_to or -(-c_eff // self.gamma)
        self.engine = FLRoundEngine(
            self.model, self.opt, self.data,
            EngineConfig.astraea(
                clients_per_round=self.clients_per_round, gamma=self.gamma,
                local=self.local, mediator_epochs=self.mediator_epochs,
                reschedule_every_round=self.reschedule_every_round,
                pad_mediators_to=pad_m, seed=self.seed),
            aug_plan=engine_plan, device=self.device,
            init_params=self.init_params, draws=self.draws)
        self.history = self.engine.history

    @property
    def params(self):
        return self.engine.params

    @property
    def comm(self):
        return self.engine.comm

    @property
    def last_schedule_stats(self):
        return self.engine.last_schedule_stats

    def run_round(self) -> None:
        self.engine.run_round()

    def evaluate(self) -> dict:
        return self.engine.evaluate()

    def fit(self, rounds: int, eval_every: int = 10) -> list[dict]:
        return self.engine.fit(rounds, eval_every)
