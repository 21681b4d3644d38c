"""Staleness-weighting policies, the straggler model, and adaptive S.

The async round subsystem's "physics" live here, kept deliberately free
of any wall-clock dependence so trajectories are reproducible
bit-for-bit:

* **Staleness policies** map a wave's staleness ``s`` (how many server
  commits behind the wave's dispatch snapshot is when its contribution
  folds) to a discount factor ``lambda(s)`` applied to the wave's Eq. 6
  aggregation weights. Every policy returns **exactly 1.0 at s=0** --
  multiplying a float by the literal ``1.0`` is a bitwise no-op, which is
  what lets the ``S=0`` async trajectory reproduce the synchronous engine
  exactly (see ``core/async_engine.py``).

* **StragglerModel** assigns deterministic slowdown factors drawn once
  from a config-seeded RNG (never from time.time() or real execution
  speed), at one of two granularities selected by ``StragglerSpec.level``:

  - ``"mediator"`` (historical): factors are keyed by mediator *slot*
    index in the round schedule (slot ``i`` is the same logical mediator
    fleet slot every round -- Alg. 3 and the random schedule both emit a
    stable ``ceil(c / gamma)`` groups). A mediator's simulated duration
    is ``factor * work`` where ``work`` counts its active client slots
    times mediator epochs. Mediators sit on edge servers in the paper's
    architecture, so heterogeneity persists across reschedules and is
    independent of the engine's locality placement.
  - ``"client"``: factors are keyed by *client id* -- the same client is
    slow every round, whatever mediator Alg. 3 packs it into (the
    device-level heterogeneity the edge literature emphasizes). A
    mediator trains its clients sequentially, so its duration is
    ``epochs * sum(factor_c for c in members)``
    (``durations_for_groups``). With every client at unit speed this
    degenerates bitwise to the mediator-level model with
    ``model="none"`` -- the float sum of ``k`` ones is exactly ``k`` --
    so speed-aware wave ordering reproduces the historical
    mediator-only ordering (``scheduling.partition_waves`` sorts stably).

* **AdaptiveStaleness** derives the staleness bound ``S`` from the
  *observed* commit-lag distribution instead of a static knob: an EWMA
  over per-wave commit lags (in rounds, on the virtual clock -- never
  wall time), clamped to ``[s_min, s_max]``. The update is the
  fixed-point form ``ewma += beta * (lag - ewma)``, so a constant lag
  stream keeps the estimate bitwise unchanged and the controller
  reproduces the fixed-S trajectory exactly (property-tested in
  tests/test_async_overlap.py).

A copy of the JAX package's ``core/staleness.py`` (numpy only): the same
specs give the same factors, durations, discounts and bounds in both
packages, exactly (``tests/test_torch_async.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

POLICIES = ("constant", "polynomial", "exponential")
STRAGGLER_MODELS = ("none", "fixed", "lognormal")
STRAGGLER_LEVELS = ("mediator", "client")


def make_staleness_policy(name: str, alpha: float = 0.5
                          ) -> Callable[[int], float]:
    """Build ``lambda(s)``, the staleness discount.

    * ``constant``: 1 for all s (FedBuff-style undiscounted buffering).
    * ``polynomial``: (1 + s)^-alpha (FedAsync's polynomial family).
    * ``exponential``: exp(-alpha * s).

    All policies return exactly ``1.0`` at ``s == 0``.
    """
    if name not in POLICIES:
        raise ValueError(f"unknown staleness policy {name!r}; "
                         f"expected one of {POLICIES}")
    if alpha < 0:
        raise ValueError("policy alpha must be >= 0")
    if name == "constant":
        return lambda s: 1.0
    if name == "polynomial":
        return lambda s: 1.0 if s <= 0 else float((1.0 + s) ** -alpha)
    return lambda s: 1.0 if s <= 0 else float(math.exp(-alpha * s))


@dataclass(frozen=True)
class StragglerSpec:
    """Config for the simulated heterogeneous mediator fleet.

    * ``none``: every slot runs at unit speed (all waves tie).
    * ``fixed``: a ``straggler_frac`` fraction of slots (chosen by the
      seeded RNG) run ``slowdown``x slower -- the paper-style "one slow
      edge server" scenario the benchmarks use (4x straggler).
    * ``lognormal``: factors ~ exp(N(0, sigma)), a continuous spread.

    ``level`` picks the granularity the factors are keyed by:
    ``"mediator"`` draws one factor per schedule slot (the historical
    edge-server model), ``"client"`` draws one per client id so slow
    *devices* persist across reschedules and drag whichever mediator
    absorbs them into the late waves (see module docstring).
    """
    model: str = "none"
    straggler_frac: float = 0.25
    slowdown: float = 4.0
    sigma: float = 0.5
    seed: int = 0
    level: str = "mediator"

    def __post_init__(self):
        if self.model not in STRAGGLER_MODELS:
            raise ValueError(f"unknown straggler model {self.model!r}; "
                             f"expected one of {STRAGGLER_MODELS}")
        if not 0.0 <= self.straggler_frac <= 1.0:
            raise ValueError("straggler_frac must be in [0, 1]")
        if self.slowdown < 1.0:
            raise ValueError("slowdown must be >= 1 (it is a slowdown)")
        if self.level not in STRAGGLER_LEVELS:
            raise ValueError(f"unknown straggler level {self.level!r}; "
                             f"expected one of {STRAGGLER_LEVELS}")


def _draw_factors(spec: StragglerSpec, n: int) -> np.ndarray:
    """The one seeded factor draw shared by both keying levels."""
    rng = np.random.default_rng(spec.seed)
    factors = np.ones(n, np.float64)
    if spec.model == "fixed":
        k = int(round(spec.straggler_frac * n))
        if k > 0:
            slow = rng.choice(n, size=k, replace=False)
            factors[slow] = spec.slowdown
    elif spec.model == "lognormal":
        factors = np.exp(rng.normal(0.0, spec.sigma, n))
    return factors


class StragglerModel:
    """Deterministic slowdown factors for the simulated fleet.

    Factors are drawn once at construction from ``spec.seed``; the same
    spec and population always produce the same fleet. No wall-clock
    enters the math anywhere. Under ``level="mediator"`` the factors
    cover ``num_slots`` schedule slots and ``durations`` maps per-slot
    work; under ``level="client"`` they cover ``num_clients`` client ids
    and ``durations_for_groups`` derives each mediator's duration from
    its members' factors.
    """

    def __init__(self, spec: StragglerSpec, num_slots: int,
                 num_clients: int | None = None):
        self.spec = spec
        if spec.level == "client":
            if num_clients is None:
                raise ValueError("client-level straggler model needs "
                                 "num_clients")
            self.factors = _draw_factors(spec, num_clients)
        else:
            self.factors = _draw_factors(spec, num_slots)

    def durations(self, work: np.ndarray) -> np.ndarray:
        """Simulated training time per mediator: ``factor * work``.

        ``work`` is per-mediator (schedule order); its length must not
        exceed the modeled slot count. Mediator-level keying only --
        client-level models derive durations from the schedule's group
        membership (``durations_for_groups``).
        """
        if self.spec.level == "client":
            raise ValueError("client-level straggler model derives durations "
                             "from group membership; use "
                             "durations_for_groups(groups, epochs)")
        work = np.asarray(work, np.float64)
        if work.shape[0] > self.factors.shape[0]:
            raise ValueError(
                f"schedule has {work.shape[0]} mediators but the straggler "
                f"model covers {self.factors.shape[0]} slots")
        return self.factors[:work.shape[0]] * work

    def durations_for_groups(self, groups: Sequence[Sequence[int]],
                             epochs: int = 1) -> np.ndarray:
        """Per-mediator durations from client membership (client level).

        A mediator trains its members sequentially for ``epochs`` mediator
        epochs, so ``duration_m = epochs * sum(factor_c)`` over its
        members. With unit factors this is exactly ``epochs * len(group)``
        -- bitwise the mediator-level ``model="none"`` durations -- which
        is what keeps speed-agnostic schedules identical to the
        historical ordering (asserted in tests/test_async_overlap.py).
        """
        if self.spec.level != "client":
            raise ValueError("durations_for_groups requires level='client'")
        em = max(1, int(epochs))
        out = np.zeros(len(groups), np.float64)
        for g, members in enumerate(groups):
            ids = np.asarray(list(members), np.int64)
            if ids.size and ids.max() >= self.factors.shape[0]:
                raise ValueError(
                    f"group {g} references client {int(ids.max())} but the "
                    f"straggler model covers {self.factors.shape[0]} clients")
            out[g] = em * float(self.factors[ids].sum())
        return out


@dataclass(frozen=True)
class AdaptiveStalenessSpec:
    """Config for the adaptive staleness bound (``AdaptiveStaleness``).

    ``beta`` is the EWMA step toward each observed lag; ``init`` seeds
    the estimate (in rounds); the derived bound is
    ``clamp(ceil(ewma), s_min, s_max)``. ``s_min=s_max`` degenerates to
    the fixed-S knob.
    """
    s_min: int = 0
    s_max: int = 4
    beta: float = 0.25
    init: float = 0.0

    def __post_init__(self):
        if self.s_min < 0:
            raise ValueError("s_min must be >= 0")
        if self.s_max < self.s_min:
            raise ValueError("s_max must be >= s_min")
        if not 0.0 < self.beta <= 1.0:
            raise ValueError("beta must be in (0, 1]")
        if self.init < 0.0:
            raise ValueError("init must be >= 0")


class AdaptiveStaleness:
    """EWMA commit-lag estimator driving the staleness bound ``S``.

    ``observe(lag)`` folds one per-wave commit lag (in *rounds*, measured
    on the async engine's virtual clock -- wall time never enters) into
    the estimate with the fixed-point update ``ewma += beta*(lag - ewma)``:
    when ``lag == ewma`` the delta is exactly ``0.0`` and the estimate is
    bitwise unchanged, so a constant lag distribution holds the bound
    constant and the adaptive trajectory reproduces the fixed-S one
    bitwise. ``bound`` rounds the estimate up (a wave lagging 0.3 rounds
    on average still needs S=1 headroom to avoid blocking) and clamps to
    ``[s_min, s_max]``.
    """

    def __init__(self, spec: AdaptiveStalenessSpec):
        self.spec = spec
        self.ewma = float(spec.init)
        self.num_observed = 0

    def observe(self, lag: float) -> None:
        if lag < 0:
            raise ValueError(f"commit lag must be >= 0, got {lag}")
        self.ewma += self.spec.beta * (float(lag) - self.ewma)
        self.num_observed += 1

    @property
    def bound(self) -> int:
        # ceil with a tolerance so float dust from the EWMA (e.g. an
        # estimate of 1.0000000000000002 after mixed updates) does not
        # bump the bound a whole round
        raw = math.ceil(self.ewma - 1e-9) if self.ewma > 0 else 0
        return int(min(max(raw, self.spec.s_min), self.spec.s_max))
