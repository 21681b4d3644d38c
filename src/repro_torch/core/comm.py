"""Communication-traffic accounting (paper §IV-C).

A copy of the JAX package's ``core/comm.py`` (plain Python): the port's
WAN ledger must equal the reference's byte for byte.

FedAvg: each communication round moves the model down to and back up from
every selected client: ``2 c |w|``.

Astraea: mediators sit on the FL/MEC server, so the *WAN* traffic per
synchronization round is model down/up per online client per mediator epoch
plus server<->mediator exchange: ``2 |w| (ceil(c / gamma) + c)`` with the
client leg repeated ``E_m`` times when E_m > 1 (the paper's Table III varies
E_m at fixed formula; we account the client leg per mediator epoch, which
reproduces the Med1..Med4 ordering).

``|w|`` is parameter count x 4 bytes (fp32, as in the paper's TF models).

Two accounting granularities share one ledger:

* per **round** (``fedavg_round`` / ``astraea_round``) -- the synchronous
  engine's unit;
* per **wave** (``fedavg_wave`` / ``astraea_wave``) -- the async engine
  charges each wave for its own clients' legs and its own mediators'
  server exchange. Because a round's waves partition both its clients and
  its mediators, the per-wave charges for one round sum to exactly the
  per-round formula (asserted in tests/test_comm.py).

``end_round`` snapshots the cumulative total into ``round_log`` so every
synchronization round leaves an auditable WAN-bytes trail (the paper's 82%
Table III claim is a ratio of these ledgers).

Alg. 2's one-off server->client plan broadcast (``plan_broadcast``) is
charged at initialization whenever augmentation is enabled -- a few hundred
bytes against megabyte model legs, but the ledger stays complete.  With
per-round adaptive plans the engine re-broadcasts the refreshed plan to
each reschedule's cohort, one ``plan_broadcast`` charge per reschedule.

**Two ledgers, never mixed.** ``total_bytes`` is the WAN ledger: traffic
that crosses the client<->server boundary, the quantity the paper's 82%
claim is a ratio of.  ``intra_pod_bytes`` is the datacenter ledger,
fed by three server-side sources, each with its own breakdown counter:

* ``model_axis_round`` -- the 2-D mesh's tensor-parallel param gather
  (``model_axis_tp_bytes``);
* ``store_stream`` -- the host->device copy the streaming client stores
  (``host``/``spilled``) make once per reschedule
  (``store_stream_bytes``);
* ``store_exchange`` -- the sharded store's per-round serve-slice
  exchange over the mediator interconnect (``store_exchange_bytes``);
  ragged mode charges the exact occupied slices, gather mode the full
  fixed-capacity all_gather.

Client placement and model parallelism are server-side deployment
details -- they move bytes over the pod interconnect or the host link,
not the WAN -- so none of them may inflate ``total_bytes`` (asserted in
tests/test_comm.py: the WAN ledger is invariant to store policy).

**Adapter-exchange mode.** With ``adapter_payload_bytes`` set (the engine
installs it from the LoRA mapping table, ``models/lora.py``), every model-
exchange leg ships the adapter state instead of the full tensors: the
same round/wave entry points charge ``legs * adapter_payload_bytes`` onto
``total_bytes`` and the ``wan_adapter_bytes`` breakdown, while
``wan_adapter_full_equiv_bytes`` accrues what those legs WOULD have cost
full-size -- so ``adapter_reduction_ratio`` (adapter/full, the scrapeable
Prometheus gauge) needs no external bookkeeping.  Without it the legs
charge full model bytes onto ``wan_full_delta_bytes``, the historical
behavior.  All counters stay integer-valued floats well below 2**53, so
the split is exact, not approximate.
"""
from __future__ import annotations

from dataclasses import dataclass, field
import math


@dataclass
class CommMeter:
    num_params: int
    bytes_per_param: int = 4
    total_bytes: float = 0.0            # WAN ledger (client <-> server)
    intra_pod_bytes: float = 0.0        # datacenter ledger (model-axis TP
    #                                     + client-store stream/exchange)
    # bytes of ONE model-exchange leg under LoRA adapter exchange; None =
    # full-delta exchange (every leg costs model_bytes)
    adapter_payload_bytes: float | None = None
    # WAN breakdown (wan_full_delta + wan_adapter sum to the exchange
    # share of total_bytes; plan broadcasts ride outside the split)
    wan_full_delta_bytes: float = 0.0
    wan_adapter_bytes: float = 0.0
    # full-size counterfactual of the adapter legs (ratio denominator)
    wan_adapter_full_equiv_bytes: float = 0.0
    # intra-pod breakdown (each sums into intra_pod_bytes)
    model_axis_tp_bytes: float = 0.0
    store_stream_bytes: float = 0.0
    store_exchange_bytes: float = 0.0
    # cumulative total_bytes after each synchronization round (one entry
    # per round, appended by the engine via end_round)
    round_log: list = field(default_factory=list)

    @property
    def model_bytes(self) -> float:
        return self.num_params * self.bytes_per_param

    @property
    def megabytes(self) -> float:
        return self.total_bytes / 2 ** 20

    @property
    def intra_pod_megabytes(self) -> float:
        return self.intra_pod_bytes / 2 ** 20

    # ---- intra-pod accounting (2-D mediator x model mesh) ----
    def model_axis_round(self, num_devices: int, model_size: int) -> None:
        """One round's tensor-parallel collectives on the pod interconnect:
        every device all-gathers the ``(model_size - 1) / model_size`` of
        the parameters it does not hold (the §8 gather; the reshard on the
        way out is a local slice, zero traffic).  Charged on the intra-pod
        ledger ONLY -- the WAN ledger behind the paper's traffic claims
        must be invariant to the server's model-parallel layout."""
        if model_size <= 1:
            return
        moved = (num_devices * self.model_bytes
                 * (model_size - 1) / model_size)
        self.model_axis_tp_bytes += moved
        self.intra_pod_bytes += moved

    def store_stream(self, nbytes: float) -> None:
        """Host->device streaming by a host/spilled client store, charged
        once per reschedule (the store reports the exact padded buffer
        bytes it device_put).  Intra-pod ledger only: placement policy
        must never move the WAN ledger."""
        self.store_stream_bytes += nbytes
        self.intra_pod_bytes += nbytes

    def store_exchange(self, nbytes: float) -> None:
        """Serve-slice exchange by the sharded client store over the
        mediator interconnect, charged every time the round program
        executes the current plan (per round, or per async wave)."""
        self.store_exchange_bytes += nbytes
        self.intra_pod_bytes += nbytes

    # ---- one-off accounting ----
    def plan_broadcast(self, num_entries: int, num_clients: int,
                       bytes_per_entry: int = 4) -> None:
        """Alg. 2 server->client broadcast of the per-class augmentation
        plan: a ``(num_classes,)`` int32 array down to every client, once
        at initialization.  Tiny next to a single model leg, but the WAN
        ledger is only auditable if every message is on it."""
        self.total_bytes += num_entries * bytes_per_entry * num_clients

    # ---- model-exchange legs (the one WAN charging primitive) ----
    def _exchange(self, legs: float) -> None:
        """Charge ``legs`` model-exchange legs on the WAN ledger, routed by
        payload mode: full tensors (``wan_full_delta_bytes``) or the LoRA
        adapter state (``wan_adapter_bytes``, with the full-size
        counterfactual accrued for the reduction ratio)."""
        if self.adapter_payload_bytes is None:
            moved = legs * self.model_bytes
            self.wan_full_delta_bytes += moved
        else:
            moved = legs * self.adapter_payload_bytes
            self.wan_adapter_bytes += moved
            self.wan_adapter_full_equiv_bytes += legs * self.model_bytes
        self.total_bytes += moved

    @property
    def adapter_reduction_ratio(self) -> float | None:
        """Adapter-vs-full WAN reduction: bytes actually shipped by the
        adapter legs over their full-size counterfactual (None before any
        adapter leg is charged)."""
        if self.wan_adapter_full_equiv_bytes == 0:
            return None
        return self.wan_adapter_bytes / self.wan_adapter_full_equiv_bytes

    # ---- per-round accounting (synchronous engine) ----
    def fedavg_round(self, c: int) -> None:
        self._exchange(2 * c)

    def astraea_round(self, c: int, gamma: int, mediator_epochs: int = 1) -> None:
        num_mediators = math.ceil(c / gamma)
        self._exchange(2 * c * mediator_epochs)     # client legs
        self._exchange(2 * num_mediators)           # server<->mediator legs

    # ---- per-wave accounting (async engine) ----
    def fedavg_wave(self, clients: int) -> None:
        """One async FedAvg wave: model down+up for this wave's clients."""
        self._exchange(2 * clients)

    def astraea_wave(self, clients: int, mediators: int,
                     mediator_epochs: int = 1) -> None:
        """One async Astraea wave: client legs for this wave's clients plus
        the server<->mediator exchange for this wave's mediators."""
        self._exchange(2 * clients * mediator_epochs)
        self._exchange(2 * mediators)

    # ---- per-round ledger ----
    def end_round(self) -> None:
        """Snapshot the cumulative WAN bytes at a round boundary."""
        self.round_log.append(self.total_bytes)

    # ---- telemetry export ----
    def ledger_totals(self) -> dict:
        """Every cumulative ledger and breakdown, keyed by the suffix the
        metrics registry publishes it under (``astraea_<key>``).  The obs
        layer mirrors these with ``Counter.set_total`` so each Prometheus
        sample equals the ledger value exactly -- keep this the single
        place that enumerates the meter's cumulative surfaces."""
        return {
            "wan_bytes_total": self.total_bytes,
            "wan_full_delta_bytes_total": self.wan_full_delta_bytes,
            "wan_adapter_bytes_total": self.wan_adapter_bytes,
            "wan_adapter_full_equiv_bytes_total":
                self.wan_adapter_full_equiv_bytes,
            "intra_pod_bytes_total": self.intra_pod_bytes,
            "model_axis_tp_bytes_total": self.model_axis_tp_bytes,
            "store_stream_bytes_total": self.store_stream_bytes,
            "store_exchange_bytes_total": self.store_exchange_bytes,
        }
