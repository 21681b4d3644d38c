"""Bounded-staleness async rounds: waves, commits, stragglers.

``FLRoundEngine.run_round`` is a synchronous barrier -- the slowest
mediator gates every round.  This module wraps the engine so mediator
groups complete in **waves** and the server folds them under a bounded
staleness ``S``, as the JAX package's ``core/async_engine.py`` does (its
simulation model, commit rule, discounted Eq. 6, telemetry and
multi-process dispatcher):

* A ``StragglerModel`` (``core/staleness.py``) gives each mediator a
  seeded simulated duration, per mediator slot or per client.
* ``scheduling.partition_waves`` sorts the mediators by duration and cuts
  them into waves of ``wave_size``.  Every wave of round ``r`` starts at
  the round's virtual time ``T_r`` from the same params snapshot and ends
  at ``T_r`` plus its slowest member's duration.
* One commit per round, at ``C_r = max(end of every wave >= S rounds old,
  end of round r's fastest wave)``; it folds every wave that has ended by
  then, and ``T_{r+1} = C_r``.  A wave of round ``q`` folds with staleness
  ``s = r - q <= S``.  ``S`` is ``staleness_bound``, or with
  ``AsyncSpec.adaptive`` an EWMA of the observed commit lags.
* The fold is Eq. 6 with the weights of a stale wave discounted,
  ``w_m * float32(lambda(s))`` where ``s > 0``, over the ready rows
  reassembled in schedule order, grouped by snapshot, then the round's
  dummy rows; it is the engine's own ``fold``, so ``S = 0`` reproduces
  the synchronous engine bit for bit.

Dispatch (``AsyncSpec.dispatch``):

* ``"masked"``: every wave replays the sync round's program over all
  ``M_pad`` rows, the rows outside the wave masked to no-ops -- no new
  program, and the wave's rows bitwise the sync round's.
  ``block_each_wave=True`` makes the host wait for each wave: the blocking
  baseline.
* ``"overlapped"``: each wave runs a program over just its rows, one per
  distinct width, built (captured, on the card) once and cached
  (``engine.run_rows_sliced``); the host never waits between waves or at
  commits.  A store that places rows by locality (``sharded``:
  ``store.permutes_rows``) reads each row on the shard its position gives
  it, so its waves stay masked under overlapped dispatch (the host still
  never waits).  ``overlap_frac`` is the share of dispatches that found the
  previous wave still running on the card (a CUDA event's ``query()``);
  ``synchronize()`` -- at evaluation and in ``flush`` -- is the only host
  sync.  Under ``row_exec="vmap"`` a sliced program batches another
  width than the sync round's, so S=0 is bitwise the sync run only under
  ``"map"``, within float reordering under ``"vmap"``.

Waves hold mediator indices; a wave's rows are copied out of the
program's row buffer (at the mediators' schedule rows) into the pending
wave's own ``(n_rows, N)`` storage on the round's stream before the next
replay can overwrite them; pending rows outlive their round by up to
``S`` rounds.  Each masked wave runs the round's plan, so a sharded
store's serve exchange is charged once a wave.

**Several processes** (``dispatcher=``, a
``launch.mesh.ProcessWaveDispatcher``): the owner of wave ``(r, w)`` runs
it and publishes its rows and weights (wave 0 also the dummy tail); every
other process receives them.  Every process books the same WAN charges and
folds every wave with the same ``fedavg_agg`` launch, so the params and the
ledger do not depend on the process count.

Draws and the online warp are addressed by round and mediator, never by
wave or row, so a mediator trains on the same numbers whichever wave (or
process) runs it; the warp is one launch per round
(``engine.prepare_round``).

The folded state is the engine's ``server_state``: the weights, or under
LoRA the adapter state (each wave's rows and the commit then span the
adapter width).  With the engine's ``telemetry`` on, a round opens the
reference's spans -- ``round`` (``mode="async"``) > ``wave`` >
``dispatch_gap``, then ``commit`` -- and ``synchronize`` a
``commit_lag``; ``observe_async_round`` absorbs each round and the final
flush.  Masked dispatch closes each wave span and commit span on a device
wait; overlapped dispatch never waits there.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import scheduling
from repro_torch.core.engine import FLRoundEngine
from repro_torch.core.fl import evaluate
from repro_torch.core.staleness import (AdaptiveStaleness, AdaptiveStalenessSpec,
                                        StragglerModel, StragglerSpec,
                                        make_staleness_policy)
from repro_torch.device import to_device

DISPATCH_MODES = ("masked", "overlapped")


@dataclass(frozen=True)
class AsyncSpec:
    """Async round configuration surfaced through both trainers.

    ``staleness_bound`` is the fixed ``S`` (ignored when ``adaptive`` is
    set); ``wave_size`` is mediators per wave (``0`` = one wave, the
    synchronous barrier); ``straggler`` drives the simulated fleet;
    ``policy``/``policy_alpha`` pick the discount ``lambda``; ``dispatch``
    selects masked full-width or overlapped sliced execution;
    ``block_each_wave`` makes the masked loop the blocking baseline and
    contradicts overlapped dispatch; ``adaptive`` derives ``S`` from the
    observed commit lags (``staleness.AdaptiveStaleness``)."""
    staleness_bound: int = 0
    wave_size: int = 0
    straggler: StragglerSpec = field(default_factory=StragglerSpec)
    policy: str = "polynomial"
    policy_alpha: float = 0.5
    dispatch: str = "masked"
    block_each_wave: bool = False
    adaptive: AdaptiveStalenessSpec | None = None

    def __post_init__(self):
        if self.staleness_bound < 0:
            raise ValueError("staleness_bound must be >= 0")
        if self.dispatch not in DISPATCH_MODES:
            raise ValueError(f"unknown dispatch mode {self.dispatch!r}; "
                             f"expected one of {DISPATCH_MODES}")
        if self.block_each_wave and self.dispatch == "overlapped":
            raise ValueError("block_each_wave is the blocking baseline; it "
                             "contradicts overlapped dispatch")
        make_staleness_policy(self.policy, self.policy_alpha)  # validates


@dataclass
class _PendingWave:
    """One trained but uncommitted wave's contribution."""
    round: int
    t_done: float
    mediators: np.ndarray       # mediator indices, ascending
    values: torch.Tensor        # (n_rows, N) flat deltas / weights
    weights: torch.Tensor       # (n_rows,) Eq. 6 sizes


class AsyncRoundEngine:
    """Bounded-staleness wave executor wrapping an ``FLRoundEngine``, which
    keeps the params, store, schedule and comm meter; this class owns the
    virtual clock, the pending waves and the discounted commits."""

    def __init__(self, engine: FLRoundEngine, spec: AsyncSpec, *, dispatcher=None):
        self.engine, self.spec = engine, spec
        self.policy = make_staleness_policy(spec.policy, spec.policy_alpha)
        self._parallel_clients = engine.cfg.aggregate == "weights"
        self._pipelined = spec.dispatch == "overlapped"
        self._sliced = self._pipelined and not engine.store.permutes_rows
        self._dispatcher = dispatcher
        self._on_card = engine.device.type == "cuda"
        self._straggler: StragglerModel | None = None
        self._adaptive = AdaptiveStaleness(spec.adaptive) \
            if spec.adaptive is not None else None
        self._pending: list[_PendingWave] = []
        self._dummy: tuple | None = None    # this round's dummy-row tail
        self.virtual_time = 0.0             # async clock (commit times)
        self.sync_time = 0.0                # the barrier on the same fleet
        self.num_commits = 0
        self.commit_log: list[dict] = []
        self.last_wave_stats: dict | None = None
        self.history: list[dict] = []
        # dispatch observability (never enters the math)
        self.num_dispatches = 0
        self.num_overlapped_dispatches = 0
        self._overlap_checks = 0
        self._last_wave: torch.cuda.Event | None = None
        self.wall_commit_wait_s = 0.0       # host seconds in synchronize()
        self.num_syncs = 0
        self._round = 0

    @property
    def telemetry(self):
        """The wrapped engine's ``obs`` handle, shared by both drivers."""
        return self.engine.telemetry

    @property
    def sim_speedup(self) -> float:
        """Simulated round-time reduction against the synchronous barrier
        (1.0 before the first commit)."""
        if self.num_commits == 0:
            return 1.0
        return self.sync_time / max(self.virtual_time, 1e-12)

    @property
    def staleness_bound(self) -> int:
        """The bound of the next commit: the adaptive controller's, or the
        fixed spec knob."""
        if self._adaptive is not None:
            return self._adaptive.bound
        return self.spec.staleness_bound

    @property
    def overlap_frac(self) -> float:
        """Share of wave dispatches issued while the previous wave was still
        running on the card; 0.0 under the blocking baseline."""
        if self._overlap_checks == 0:
            return 0.0
        return self.num_overlapped_dispatches / self._overlap_checks

    # ------------------------------------------------------------------
    # one virtual round: dispatch its waves, then commit
    # ------------------------------------------------------------------
    def _durations(self, eng, slot_np, row_of, m_real) -> np.ndarray:
        spec = self.spec
        if self._straggler is None:
            # sized to the real population, so padding never dilutes the
            # straggler fraction
            self._straggler = StragglerModel(
                spec.straggler, m_real,
                num_clients=eng.data.num_clients
                if spec.straggler.level == "client" else None)
        em = max(1, eng.cfg.mediator_epochs)
        if spec.straggler.level == "client":
            return self._straggler.durations_for_groups(eng.last_groups, em)
        return self._straggler.durations(slot_np[row_of].sum(axis=1) * em)

    def run_round(self) -> None:
        spec, eng, tel = self.spec, self.engine, self.telemetry
        wan0 = eng.comm.total_bytes
        with tel.span("round", round=self._round, mode="async", dispatch=spec.dispatch,
                      staleness_bound=self.staleness_bound, wave_size=spec.wave_size,
                      policy=eng.cfg.store) as rsp:
            self._run_round_body(spec, eng, tel)
            rsp.set(wan_bytes=eng.comm.total_bytes - wan0, traces=eng.num_round_traces)
        tel.observe_async_round(self, duration_s=rsp.duration_s)

    def _run_round_body(self, spec, eng, tel) -> None:
        inp = eng.prepare_round()
        slot_np, m_real, row_of = inp.slot, inp.m_real, inp.row_of
        m_pad = slot_np.shape[0]
        waves, wstats = scheduling.partition_waves(
            self._durations(eng, slot_np, row_of, m_real), spec.wave_size)
        self.last_wave_stats = wstats
        r, t0 = self._round, self.virtual_time
        snapshot = eng.row_state()          # every wave of round r starts here
        for wi, wave in enumerate(waves):
            meds = np.sort(np.asarray(wave, np.int64))      # mediator indices
            with tel.span("wave", wave=wi, round=r, mediators=int(meds.size),
                          sim_done=float(t0 + wstats["wave_times"][wi])) as wsp:
                overlapped = self._probe_overlap()
                owner = self._dispatcher is None or \
                    self._dispatcher.owner_of(r, wi) == self._dispatcher.process_index
                if owner:
                    with tel.span("dispatch_gap", wave=wi, round=r, overlapped=overlapped):
                        vals, wts = self._dispatch(eng, inp, snapshot, row_of[meds])
                        if wi == 0:
                            # the round's dummy tail (weight exactly 0)
                            # completes the padded stack, so an S=0 commit
                            # folds the sync round's input
                            dummy_rows = to_device(inp.unperm[m_real:], eng.device)
                            self._dummy = (eng.noop_rows(snapshot, m_pad - m_real),
                                           inp.weights[dummy_rows])
                    if self._dispatcher is not None:
                        self._publish_wave(r, wi, vals, wts)
                else:
                    vals, wts = self._receive_wave(r, wi)
                if self._on_card:
                    self._last_wave = torch.cuda.Event()
                    self._last_wave.record()
                    if spec.block_each_wave:
                        self._last_wave.synchronize()   # the blocking baseline
                if not self._pipelined:
                    wsp.sync_on((vals, wts))
                clients = int(slot_np[row_of[meds]].sum())
                wave_wan0 = eng.comm.total_bytes
                # charges come from the schedule, on every process: the WAN
                # ledger is the same in every dispatch mode and process count
                if self._parallel_clients:
                    eng.comm.fedavg_wave(clients)
                else:
                    eng.comm.astraea_wave(clients, len(meds), eng.cfg.mediator_epochs)
                if eng._model_size > 1 and not eng._tp_rows:
                    # every oracle wave gathers the split weights (or the
                    # LoRA backbone): an intra-pod charge a wave
                    eng._charge_model_axis()
                if not self._sliced:
                    # a masked wave runs the round's plan: a sharded store's
                    # serve exchange once a wave (nothing for the other stores)
                    eng.charge_exchange()
                self._pending.append(_PendingWave(
                    r, t0 + wstats["wave_times"][wi], meds, vals, wts))
                wsp.set(clients=clients, wan_bytes=eng.comm.total_bytes - wave_wan0)
        eng.comm.end_round()

        # ---- commit C_r: wait for the waves the bound expires and the
        # round's fastest wave; fold everything landed by then ----
        s_bound = self.staleness_bound
        due = [p.t_done for p in self._pending if p.round <= r - s_bound]
        c_time = max(due + [t0 + wstats["wave_times"][0]])
        ready = [p for p in self._pending if p.t_done <= c_time]
        self._pending = [p for p in self._pending if p.t_done > c_time]
        if self._adaptive is not None:
            # the lags this commit realized: folded waves r - q rounds,
            # still-pending ones at least one more (virtual clock only)
            for p in ready:
                self._adaptive.observe(r - p.round)
            for p in self._pending:
                self._adaptive.observe(r - p.round + 1)
        self._fold(ready, r, c_time)
        self.virtual_time = c_time
        self.sync_time += wstats["barrier_time"]
        self._round += 1
        eng._round = self._round

    def _dispatch(self, eng, inp, snapshot, rows: np.ndarray) -> tuple:
        """Train one wave, its mediators at schedule ``rows``: ``(vals (n,
        N), wts (n,))``."""
        pick = to_device(rows, eng.device)
        if self._sliced:
            vals = eng.run_rows_sliced(inp, snapshot, rows).clone()
        else:
            vals = eng.run_rows(inp, snapshot, rows)[pick]
        return vals, inp.weights[pick]

    def _publish_wave(self, r: int, wi: int, vals, wts) -> None:
        """Ship an owned wave (wave 0 with the dummy tail) to the other
        processes; reading it to the host waits for the wave."""
        arrays = [vals, wts] + (list(self._dummy) if wi == 0 else [])
        self._dispatcher.publish(f"wave-{r}-{wi}", [a.cpu().numpy() for a in arrays])

    def _receive_wave(self, r: int, wi: int) -> tuple:
        dev = self.engine.device
        got = [torch.from_numpy(a).to(dev) for a in self._dispatcher.receive(f"wave-{r}-{wi}")]
        if wi == 0:
            self._dummy = (got[2], got[3])
        return got[0], got[1]

    def _probe_overlap(self) -> bool:
        """Whether the previously dispatched wave is still running, counted
        (observability only; never waits)."""
        self.num_dispatches += 1
        if self.num_dispatches == 1:
            return False
        self._overlap_checks += 1
        in_flight = self._last_wave is not None and not self._last_wave.query()
        self.num_overlapped_dispatches += in_flight
        return in_flight

    # ------------------------------------------------------------------
    # commits
    # ------------------------------------------------------------------
    def _fold(self, ready: list[_PendingWave], r: int, c_time: float) -> None:
        """One server commit: staleness-discounted Eq. 6 over ``ready``."""
        assert ready, "a commit always folds at least the round's fast wave"
        with self.telemetry.span("commit", round=r, sim_time=float(c_time)) as csp:
            self._fold_traced(ready, r, c_time, csp)

    def _fold_traced(self, ready, r, c_time, csp) -> None:
        parts_v, parts_w, stales = [], [], []
        for q in sorted({p.round for p in ready}):
            ws = [p for p in ready if p.round == q]
            rows = np.concatenate([p.mediators for p in ws])
            order = to_device(np.argsort(rows, kind="stable"), self.engine.device)
            vals = torch.cat([p.values for p in ws])[order]
            wts = torch.cat([p.weights for p in ws])[order]
            s = r - q
            if s > 0:       # s == 0 keeps the weights bitwise untouched
                # a float32 product, as the reference's wts * float32(lambda)
                wts = wts * float(np.float32(self.policy(s)))
            parts_v.append(vals)
            parts_w.append(wts)
            stales.extend([s] * rows.size)
        dvals, dwts = self._dummy
        if self.engine._model_size > 1 and self.engine._lora_mapping is None:
            # the reference's rule charges a commit's fold of the split
            # weights (the port folds shard by shard; a LoRA commit folds
            # the whole adapter state)
            self.engine._charge_model_axis()
        self.engine.fold(torch.cat(parts_v + [dvals]), torch.cat(parts_w + [dwts]))
        self.num_commits += 1
        self.commit_log.append({
            "round": r, "time": float(c_time),
            "folded_rows": int(sum(p.mediators.size for p in ready)),
            "staleness": stales,
            "staleness_bound": self.staleness_bound,
            "pending_after": len(self._pending),
        })
        csp.set(folded_rows=self.commit_log[-1]["folded_rows"],
                staleness_max=max(stales) if stales else 0,
                pending_after=len(self._pending))
        if not self._pipelined:
            csp.sync_on(self.engine.state_at_rest())

    def synchronize(self) -> float:
        """Wait for every enqueued wave and commit to finish on the card:
        the only host sync of overlapped dispatch (``fit`` calls it at
        evaluation, ``flush`` at the end).  Returns the seconds waited,
        which ``wall_commit_wait_s`` sums (observability only)."""
        t0 = time.perf_counter()
        with self.telemetry.span("commit_lag", round=self._round,
                                 pending=len(self._pending)) as sp:
            if self._on_card:
                torch.cuda.synchronize(self.engine.device)
            waited = time.perf_counter() - t0
            sp.set(waited_s=waited)
        self.wall_commit_wait_s += waited
        self.num_syncs += 1
        return waited

    def flush(self) -> None:
        """Fold every still-pending wave (end of training), each discounted
        by its staleness ``s = r_final - q <= S``.  A no-op when nothing is
        pending."""
        if not self._pending:
            if self.num_commits:
                self.synchronize()
            return
        c_time = max(p.t_done for p in self._pending)
        ready, self._pending = self._pending, []
        self._fold(ready, self._round, c_time)
        self.virtual_time = max(self.virtual_time, c_time)
        self.synchronize()
        # the flush commit lands after the last round's absorption: one
        # more metrics snapshot brings its staleness into the registry
        self.telemetry.observe_async_round(self)

    # ------------------------------------------------------------------
    # driving
    # ------------------------------------------------------------------
    def evaluate(self) -> dict:
        """Test-set metrics now, with the async history keys."""
        eng = self.engine
        m = evaluate(eng.model, eng.merged_params(), eng._test_x, eng._test_y)
        stales = [s for c in self.commit_log for s in c["staleness"]]
        m.update(round=self._round, traffic_mb=eng.comm.megabytes,
                 sim_time=self.virtual_time, sync_sim_time=self.sync_time,
                 sim_speedup=self.sim_speedup, commits=self.num_commits,
                 overlap_frac=self.overlap_frac,
                 staleness_bound=self.staleness_bound,
                 staleness_mean=float(np.mean(stales)) if stales else 0.0,
                 staleness_max=int(max(stales)) if stales else 0)
        if eng.last_schedule_stats and "kld_mean" in eng.last_schedule_stats:
            m["mediator_kld_mean"] = eng.last_schedule_stats["kld_mean"]
        return m

    def fit(self, rounds: int, eval_every: int = 10) -> list[dict]:
        for i in range(rounds):
            last = i == rounds - 1      # robust to repeated fit() calls
            self.run_round()
            if last:
                self.flush()
            if self._round % eval_every == 0 or last:
                self.synchronize()      # evaluation is a pipeline sync point
                self.history.append(self.evaluate())
        return self.history
