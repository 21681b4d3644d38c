"""FedAvg (McMahan et al. 2016) -- the paper's baseline.

Each round: sample ``c`` clients, train each for E local epochs from the
same global weights, and average their weights with n_k / n (Eq. 6).  It is
the ``gamma=1`` + random-singleton-schedule + weight-aggregation
configuration of ``core.engine.FLRoundEngine``.  ``alpha`` enables the
augmentation-only ablation (Alg. 2 without mediators), online or
materialized as in ``core.astraea``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.astraea import (async_runner, charge_materialized_plan,
                                      rebalancing_phase, store_config)
from repro_torch.core.augmentation import resolve_engine_plan
from repro_torch.core.engine import EngineConfig, FLRoundEngine
from repro_torch.core.fl import LocalSpec
from repro_torch.data.federated import FederatedDataset
from repro_torch.launch.mesh import resolve_fl_mesh
from repro_torch.optim.optimizers import Optimizer


@dataclass
class FedAvgTrainer:
    model: object
    opt: Optimizer
    data: FederatedDataset
    clients_per_round: int           # c
    local: LocalSpec                 # B, E
    alpha: float | None = None       # Alg. 2 factor; None = plain FedAvg
    aug_mode: str | None = "online"  # "online" | "materialized" | None
    # recompute the plan from each round's cohort histograms (see
    # AstraeaTrainer.adaptive_plan; FedAvg reschedules every round, so the
    # plan drifts with the per-round client sample)
    adaptive_plan: bool = False
    store: str = "replicated"        # client-store placement policy
    store_exchange: str = "ragged"   # the sharded store's serve exchange
    # the mediator mesh (see AstraeaTrainer.mesh)
    mesh: object = None
    # the model axis of the default 2-D mesh (see AstraeaTrainer)
    model_parallel: int | None = None
    # on a mesh with a model axis: TP rows, the gather oracle or "auto"
    # (EngineConfig.tp_rows)
    tp_rows: bool | str = "auto"
    # padded row count; defaults to c
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
    row_exec: str = "vmap"           # "vmap" (lockstep rows) | "map"
    device: object = None            # None = the CUDA device
    init_params: dict | None = None
    draws: object = None
    loss_fn: object = None           # optional custom local loss
    history: list[dict] = field(default_factory=list)

    def __post_init__(self):
        phase = rebalancing_phase(self)
        engine_plan, adaptive_alpha = resolve_engine_plan(
            phase, self.adaptive_plan, self.alpha)
        pad_m = self.pad_mediators_to or \
            min(self.clients_per_round, self.data.num_clients)
        self.engine = FLRoundEngine(
            self.model, self.opt, self.data,
            EngineConfig.fedavg(clients_per_round=self.clients_per_round,
                                local=self.local, pad_mediators_to=pad_m,
                                seed=self.seed, row_exec=self.row_exec,
                                lora_rank=self.lora_rank, lora_alpha=self.lora_alpha,
                                tp_rows=self.tp_rows, **store_config(self)),
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

    def run_round(self) -> None:
        self.runner.run_round()

    def evaluate(self) -> dict:
        return self.runner.evaluate()

    def fit(self, rounds: int, eval_every: int = 10) -> list[dict]:
        return self.runner.fit(rounds, eval_every)
