"""The Astraea server: rebalance -> reschedule -> train -> aggregate.

Paper Fig. 3: clients report label histograms; the server computes the
Alg. 2 plan from the global distribution -- online (the resample + warp
runs inside each round, nothing is stored) or materialized (every client
stores its warped copies before training); each round the selected
clients are packed into mediators of <= gamma clients by Alg. 3, every
mediator trains its clients sequentially for E_m epochs, and Eq. 6
averages the mediator deltas with weights n_m / n.

The trainer presents the reference's arguments (``repro/core/astraea.py``)
where they apply to a synchronous single-device engine, plus ``row_exec``
(the engine's, ``EngineConfig.row_exec``), ``device``, ``init_params``,
``draws`` and ``loss_fn`` (see ``core/engine.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.augmentation import (AugPhase, resolve_aug_mode,
                                           resolve_engine_plan)
from repro_torch.core.draws import SeededDraws
from repro_torch.core.engine import EngineConfig, FLRoundEngine
from repro_torch.core.fl import LocalSpec
from repro_torch.data.federated import FederatedDataset
from repro_torch.device import resolve_device
from repro_torch.optim.optimizers import Optimizer


def rebalancing_phase(trainer) -> AugPhase:
    """Both trainers' Alg. 2 phase: resolves the device and the draws
    (seeded ones unless given), rebuilds the federation if materialized,
    and records the plan and storage fractions on ``trainer``."""
    trainer.device = resolve_device(trainer.device)
    if trainer.draws is None:
        trainer.draws = SeededDraws(trainer.seed + 1, trainer.device)
    phase = resolve_aug_mode(trainer.data, trainer.alpha, trainer.aug_mode,
                             draws=trainer.draws, device=trainer.device)
    trainer.data = phase.data
    trainer.augmentation_plan = phase.plan
    trainer.extra_storage_frac = phase.extra_storage_frac  # realized
    trainer.planned_extra_frac = phase.planned_extra_frac  # avoided (online)
    return phase


def charge_materialized_plan(engine: FLRoundEngine, phase: AugPhase) -> None:
    """The materialized phase broadcast the plan before the engine existed
    (online mode charges it inside the engine)."""
    if phase.mode == "materialized":
        engine.comm.plan_broadcast(engine.data.num_classes, engine.data.num_clients)


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
    aug_mode: str | None = "online"         # "online" | "materialized" | None
    # per-round adaptive rebalancing: recompute the Alg. 2 plan from the
    # selected cohort's label histograms at every reschedule (online mode
    # only; the refreshed plan is re-broadcast and metered per reschedule)
    adaptive_plan: bool = False
    reschedule_every_round: bool = False    # static client data -> schedule once
    # padded mediator count; defaults to ceil(c / gamma), Alg. 3's output size
    pad_mediators_to: int | None = None
    seed: int = 0
    row_exec: str = "vmap"                  # "vmap" (lockstep rows) | "map"
    device: object = None                   # None = the CUDA device
    init_params: dict | None = None
    draws: object = None
    loss_fn: object = None                  # optional custom local loss
    history: list[dict] = field(default_factory=list)

    def __post_init__(self):
        phase = rebalancing_phase(self)
        engine_plan, adaptive_alpha = resolve_engine_plan(
            phase, self.adaptive_plan, self.alpha)
        c_eff = min(self.clients_per_round, self.data.num_clients)
        pad_m = self.pad_mediators_to or -(-c_eff // self.gamma)
        self.engine = FLRoundEngine(
            self.model, self.opt, self.data,
            EngineConfig.astraea(
                clients_per_round=self.clients_per_round, gamma=self.gamma,
                local=self.local, mediator_epochs=self.mediator_epochs,
                reschedule_every_round=self.reschedule_every_round,
                pad_mediators_to=pad_m, seed=self.seed, row_exec=self.row_exec),
            aug_plan=engine_plan, adaptive_aug_alpha=adaptive_alpha,
            device=self.device,
            init_params=self.init_params, draws=self.draws, loss_fn=self.loss_fn)
        charge_materialized_plan(self.engine, phase)
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
