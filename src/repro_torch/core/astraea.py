"""The Astraea server: rebalance -> reschedule -> train -> aggregate.

Paper Fig. 3: clients report label histograms; the server computes the
Alg. 2 plan from the global distribution -- online (the resample + warp
runs inside each round, nothing is stored) or materialized (every client
stores its warped copies before training); each round the selected
clients are packed into mediators of <= gamma clients by Alg. 3, every
mediator trains its clients sequentially for E_m epochs, and Eq. 6
averages the mediator deltas with weights n_m / n.

The trainer presents the reference's arguments (``repro/core/astraea.py``)
-- with ``store`` (the sharded store's ``store_exchange`` and ``mesh``; the
spilled store's ``store_prefetch_depth``/``store_lru_rows``),
``async_spec`` (bounded-staleness waves, ``core/async_engine.py``),
``lora_rank``/``lora_alpha`` (the LoRA adapter exchange) and
``telemetry`` (``obs/``) -- plus
``row_exec`` (the engine's, ``EngineConfig.row_exec``), ``device``,
``init_params``, ``draws`` and ``loss_fn`` (see ``core/engine.py``).
``params`` and ``_round`` can be set, as ``checkpoint.load_trainer``
does.
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
from repro_torch.launch.mesh import resolve_fl_mesh
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


def store_config(trainer) -> dict:
    """Both trainers' client-store fields, as ``EngineConfig`` keywords."""
    return dict(store=trainer.store, store_exchange=trainer.store_exchange,
                store_prefetch_depth=trainer.store_prefetch_depth,
                store_lru_rows=trainer.store_lru_rows)


def async_runner(engine: FLRoundEngine, spec):
    """What drives the trainer's rounds: the engine itself, or with an
    ``AsyncSpec`` the bounded-staleness wave engine around it."""
    if spec is None:
        return engine
    from repro_torch.core.async_engine import AsyncRoundEngine
    return AsyncRoundEngine(engine, spec)


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
    store: str = "replicated"               # client-store placement policy
    store_exchange: str = "ragged"          # the sharded store's serve exchange
    # the mesh the sharded store spreads over and the model axis splits the
    # parameters over (None: one shard on the device)
    mesh: object = None
    # the model axis of the default 2-D (mediator, model) mesh over the
    # visible cards (launch/mesh.py::make_fl_mesh); ignored when ``mesh`` is
    # given; None = the engine's default
    model_parallel: int | None = None
    # on a mesh with a model axis: TP rows, the gather oracle or "auto"
    # (EngineConfig.tp_rows)
    tp_rows: bool | str = "auto"
    # padded mediator count; defaults to ceil(c / gamma), Alg. 3's output size
    pad_mediators_to: int | None = None
    # bounded-staleness async rounds (core/async_engine.py); None = the
    # synchronous barrier engine
    async_spec: object = None
    # spilled store: reschedules prefetched ahead; LRU rows (None = 2x c)
    store_prefetch_depth: int = 1
    store_lru_rows: int | None = None
    # LoRA adapter exchange: the rank of the mapping table built from
    # model.param_specs() (models/lora.py); None = full-delta legs
    lora_rank: int | None = None
    lora_alpha: float | None = None
    # an obs.Telemetry handle threaded into the engine (host-side spans
    # and metrics; None = the no-op stubs)
    telemetry: object = None
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
                pad_mediators_to=pad_m, seed=self.seed, row_exec=self.row_exec,
                lora_rank=self.lora_rank, lora_alpha=self.lora_alpha,
                tp_rows=self.tp_rows,
                **store_config(self)),
            aug_plan=engine_plan, adaptive_aug_alpha=adaptive_alpha,
            device=self.device,
            init_params=self.init_params, draws=self.draws, loss_fn=self.loss_fn,
            telemetry=self.telemetry, mesh=resolve_fl_mesh(self.mesh, self.model_parallel))
        charge_materialized_plan(self.engine, phase)
        self.runner = async_runner(self.engine, self.async_spec)
        self.history = self.runner.history

    @property
    def params(self):
        return self.engine.params

    @params.setter
    def params(self, value):
        self.engine.load_params(value)

    @property
    def _round(self):
        return self.engine._round

    @_round.setter
    def _round(self, value):
        self.engine._round = value

    @property
    def comm(self):
        return self.engine.comm

    @property
    def last_schedule_stats(self):
        return self.engine.last_schedule_stats

    def run_round(self) -> None:
        self.runner.run_round()

    def evaluate(self) -> dict:
        return self.runner.evaluate()

    def fit(self, rounds: int, eval_every: int = 10) -> list[dict]:
        return self.runner.fit(rounds, eval_every)
