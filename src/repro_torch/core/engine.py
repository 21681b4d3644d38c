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
selections, schedules and WAN ledger equal the reference's.  With
``adaptive_aug_alpha`` set, every reschedule recomputes the Alg. 2 plan
from the selected cohort's raw counts, charges its broadcast to the cohort
and packs Alg. 3 by the refreshed post-augmentation counts.

Rows run one of two ways (``EngineConfig.row_exec``, the reference's
name):

* ``"vmap"`` (default): every row in lockstep (``fl.client_update_rows``,
  ``mediator.mediator_update_rows``).  The round's local training reads
  static buffers -- the weights, the ``(M_pad, gamma, pad)`` client data
  and the round's draws, filled before it runs -- and writes each row's
  output into one flat ``(M_pad, N)`` buffer.  On a CUDA device it is
  captured once as a CUDA graph and replayed every round; a failed
  capture raises.  ``num_round_traces`` counts how often this round
  program was built: once while ``M_pad``, gamma and pad stay fixed.
* ``"map"``: rows one after another through ``client_update`` /
  ``mediator_update``, each writing its row of the same buffer; a dummy
  row is skipped (left zero), an empty slot runs with its zero mask and
  draws nothing (``draws.EmptySlotDraws``).  The oracle.

The path through the kernels, outside any graph: Alg. 3 is one
``kld_greedy_picks`` launch per reschedule; the online Alg. 2 warp is one
``affine_warp`` launch per round over every scheduled slot; Eq. 6 is one
``fedavg_agg`` launch per round (``fedavg_agg_flat``) over the flat
buffer.

The client data live in a ``ClientStore`` (``core/client_store.py``,
``EngineConfig.store``): replicated on the device, or streamed from host
RAM (``"host"``) or a disk/lazy tier (``"spilled"``) once per reschedule
into a ``min(K, c)``-row device buffer, the copy charged to the intra-pod
ledger, or partitioned over the ``mediator`` axis of ``mesh``
(``"sharded"``, ``launch/mesh.py``), whose serve exchange
(``EngineConfig.store_exchange``) is charged to the intra-pod ledger every
round.  ``M_pad`` is rounded up to a multiple of the mesh's shard count.
The sharded store places each mediator on the shard that holds most of its
clients (``store.place``, ``scheduling.place_mediators``): schedule row
``r`` then holds mediator ``row_to_group[r]``, whose draws it asks for, and
the rows and weights are put back in mediator order (``unperm``) before
Eq. 6, so every placement sums the same rows in the same order.  The
engine also takes a *streaming federation* -- ``data`` without
``client_images`` but with the row-source protocol
(``data.synthetic.StreamingFederation``) -- for the host and spilled
stores, so the device footprint is fixed by ``c``, never by ``K``.  With
a prefetching store and a reschedule every round, ``ensure_schedule``
pre-draws the next ``store_prefetch_depth`` selections (the rng is called
in the same order at any depth) and hands them to ``store.prefetch``.

A round is three steps, shared with the async engine
(``core/async_engine.py``):

* ``prepare_round``: the schedule, the gather, the Eq. 6 sizes and the
  warp -- once per round, whatever waves later run its rows;
* ``run_rows`` (the round program over every ``M_pad`` row, rows outside
  a wave masked to no-ops) or ``run_rows_sliced`` (a program over just a
  wave's rows, one per distinct width, built once and cached; each
  counts in ``num_round_traces``): the local training;
* ``fold``: Eq. 6 over a stack of rows and the delta or weights fold, one
  function for the sync round and the async commit, so an async run at
  staleness 0 stays bitwise the sync one.

**LoRA adapter exchange** (``EngineConfig.lora_rank``, the reference's):
the model's ``param_specs`` give the adapter mapping table
(``models/lora.py``).  ``params`` is then the frozen backbone and the
round trains and folds the adapter state, ``server_state``: the flat
``(M, N)`` row buffer, Eq. 6 and the fold run over its entries (N the
adapter width), the row programs train it through ``lora.MergedModel``
(the backbone and the frozen A bases are static buffers the captured graph
reads), and each WAN leg carries ``lora.exchange_nbytes``.  At
``lora.full_rank`` every entry is dense and the round is the full-delta
round bit for bit; rank 0 trains and averages nothing.

**Rows on their mesh positions** (the reference's ``mediator_shard_map``):
the ``M_pad`` schedule rows split into one contiguous block a mediator row
of the mesh (``row_positions``), after placement; block ``i`` trains on
mediator row ``i``'s devices (``model_devices(mesh, i)``: its home, the
first, under the gather oracle, every model column under TP rows).  The
store serves each block its slots on its home (``ClientStore.serve``: the
sharded store by its exchange on the devices, the others by a copy from
the engine's device), each block's Alg. 2 warp is one launch on its home,
and under ``"vmap"`` each row has its own round program of width ``M_pad /
n`` with its static buffers on its devices (on the card its own CUDA graph;
every row's graph is replayed before any is waited on).  The rows come
back to the engine's device in mediator order (``unperm``) and Eq. 6 is
one launch over the ``(M_pad, N)`` stack there, as the reference's
``eq6_aggregate`` replicates its stack first: the reduction order, and so
``fold``, never depend on the mesh.  Sliced async waves
(``run_rows_sliced``) and the process dispatcher still train on mediator
row 0's devices.

**The 2-D ``(mediator, model)`` mesh** (``launch/mesh.py::make_fl_mesh``,
the reference's §8 contract): the parameters are split over the ``model``
axis by the rule tables (``launch/sharding.py::placements`` over the
model's ``param_specs``: output channels and features, never a
contraction dimension) and replicated over ``mediator``; at rest each
position holds its shards (``sharding.ModelShards``), ``params`` gathers
them whole, and ``store.stats()`` reports the bytes a position holds and
the model axis.  Client data and schedules partition over the mediator
axis only (``M_pad`` rounds up to the mediator count).  Two ways to run
the rows (``EngineConfig.tp_rows``):

* the gather oracle (``False``; ``"auto"`` off the card): at round start
  the shards are all-gathered into the round's weights (before the graph
  replay under ``"vmap"``), the rows and Eq. 6 run as on the 1-D mesh, and
  ``fold`` adds each shard's slice of the aggregate to it
  (``sharding.fold_shards``).  The gather moves exact bytes and the fold
  is elementwise, so the trajectory is the 1-D one bit for bit.
* TP rows (``True``; ``"auto"`` on the card): the rows train the shards
  (``models/cnn.py::TensorParallel``): each position computes its output
  channels from the whole input, the activations are all-gathered, the
  input gradient all-reduced; the whole replica is never formed, in the
  rows or at the fold.  Each row's shard deltas land at their columns of
  the flat row buffer, so Eq. 6 and ``fold`` are the oracle's.  Under LoRA
  the backbone stays split and the adapter state whole
  (``lora.merge_shards``).  The reference refuses ``True`` on the CPU (an
  XLA-CPU crash the port does not have); the port runs it there.

Only ``params`` (evaluation, checkpoints, the oracle's round start)
gathers the shards.

The model-axis gather is charged to the intra-pod ledger
(``comm.model_axis_round``) by the reference's rule; the WAN ledger does
not change with the layout.

**Telemetry** (``telemetry=``, ``obs/``): the reference's spans around the
phases -- ``round`` around ``run_round``; ``plan_refresh``,
``reschedule``, ``pack`` and ``store_stream`` in ``prepare_round``;
``aggregate`` around the rows and the fold, waiting for the new state --
never inside the round program, and ``observe_round`` after each round.
Off by default; on, it changes no bit and builds no program.
"""
from __future__ import annotations

import gc
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import scheduling
from repro_torch.core.augmentation import augmentation_plan, online_augment_rows
from repro_torch.core.client_store import EXCHANGES, POLICIES, build_client_store
from repro_torch.core.comm import CommMeter
from repro_torch.core.draws import EmptySlotDraws, RoundDraws, SeededDraws
from repro_torch.core.fl import (LocalSpec, LossFn, client_update, client_update_rows,
                                 evaluate)
from repro_torch.core.mediator import mediator_update, mediator_update_rows
from repro_torch.data.federated import FederatedDataset
from repro_torch.device import resolve_device, to_device
from repro_torch.kernels import ops
from repro_torch.launch import sharding as shard_lib
from repro_torch.launch.mesh import (AbstractMesh, mediator_devices, model_axis_size,
                                     model_devices)
from repro_torch.launch.model_axis import shard_key
from repro_torch.models import lora as lora_lib
from repro_torch.models.cnn import Params, TensorParallel, count_params
from repro_torch.models.cnn import init_params as seeded_params
from repro_torch.obs.telemetry import as_telemetry
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
    row_exec: str = "vmap"                  # "vmap" (lockstep) | "map" (loop)
    store: str = "replicated"               # client-store placement policy
    store_exchange: str = "ragged"          # the sharded store's serve exchange
    # spilled store: reschedules pre-drawn and prefetched ahead, and its
    # host LRU row cache in rows (None = twice the capacity)
    store_prefetch_depth: int = 1
    store_lru_rows: int | None = None
    # LoRA adapter exchange: the rank of the mapping table built from
    # model.param_specs() (models/lora.py); None = full-delta exchange, 0 =
    # a frozen backbone; at lora.full_rank every entry is dense
    lora_rank: int | None = None
    lora_alpha: float | None = None         # merge scale; None = rank (1.0)
    # on a mesh with a model axis: train the rows tensor-parallel over the
    # parameter shards (True), gather them whole first (False: the oracle),
    # or "auto" (TP rows on a CUDA device); a 1-D mesh is always the oracle
    tp_rows: bool | str = "auto"

    def __post_init__(self):
        if self.row_exec not in ("vmap", "map"):
            raise ValueError(f"unknown row_exec {self.row_exec!r}")
        if self.store not in POLICIES:
            raise ValueError(f"unknown client-store policy {self.store!r}; "
                             f"expected one of {POLICIES}")
        if self.store_exchange not in EXCHANGES:
            raise ValueError(f"unknown store_exchange {self.store_exchange!r}; "
                             f"expected one of {EXCHANGES}")
        if self.store_prefetch_depth < 1:
            raise ValueError("store_prefetch_depth must be >= 1")
        if self.store_lru_rows is not None and self.store_lru_rows < 0:
            raise ValueError("store_lru_rows must be >= 0")
        if self.schedule not in ("kld", "random"):
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if self.aggregate not in ("delta", "weights"):
            raise ValueError(f"unknown aggregate {self.aggregate!r}")
        if self.aggregate == "weights" and self.gamma != 1:
            raise ValueError("weight aggregation implies gamma=1 (FedAvg)")
        if self.pad_mediators_to is not None and self.pad_mediators_to < 1:
            raise ValueError("pad_mediators_to must be >= 1")
        if self.lora_rank is not None and self.lora_rank < 0:
            raise ValueError("lora_rank must be >= 0")
        if self.lora_alpha is not None and self.lora_rank is None:
            raise ValueError("lora_alpha requires lora_rank")
        if self.tp_rows not in (True, False, "auto"):
            raise ValueError(f"tp_rows must be True, False or 'auto', got {self.tp_rows!r}")

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


@dataclass
class RoundInputs:
    """One round's prepared inputs (``FLRoundEngine.prepare_round``):
    the ``(M_pad, gamma)`` slot mask and real row count, ``parts``: each
    mediator row's block of the (augmented) client data ``(xs, ys, ms)``
    (``(M_pad / n, gamma, pad, ...)``, the masks scaled by the slot mask)
    on its home, and the Eq. 6 sizes ``weights (M_pad,)`` on the engine's
    device, all in schedule-row order; ``row_to_group (M_pad,)`` the
    mediator on each row (-1 a dummy) and ``unperm (M_pad,)`` the rows in
    mediator order, the dummies last."""
    rnd: int
    slot: np.ndarray
    m_real: int
    parts: list
    weights: torch.Tensor
    row_to_group: np.ndarray
    unperm: np.ndarray

    def whole(self, device: torch.device) -> tuple:
        """Every row's ``(xs, ys, ms)`` on ``device``."""
        if len(self.parts) == 1:
            return tuple(a.to(device) for a in self.parts[0])
        return tuple(torch.cat([p[a].to(device) for p in self.parts]) for a in range(3))

    @property
    def address(self) -> np.ndarray:
        """The draw address of each row: its mediator, or for a dummy row
        its own position (its mask is zero, so its draws change nothing)."""
        return np.where(self.row_to_group >= 0, self.row_to_group,
                        np.arange(self.row_to_group.size))

    @property
    def row_of(self) -> np.ndarray:
        """``(m_real,)``: the schedule row of each mediator."""
        return self.unperm[:self.m_real]


class FLRoundEngine:
    """Single-device round executor (see module docstring).

    ``init_params`` (a state-dict-keyed dict) replaces the seeded He init;
    ``draws`` replaces the seeded ``torch.Generator`` draws
    (``core/draws.py``); ``loss_fn(model, params, x, y, mask, keep)``
    replaces the masked cross-entropy of local training (``core/fl.py``);
    ``adaptive_aug_alpha`` refreshes ``aug_plan`` at every reschedule (see
    the module docstring); ``telemetry`` is an ``obs.Telemetry`` (None:
    off); ``mesh`` a ``launch.mesh.AbstractMesh`` with devices, which the
    sharded store puts its shards on (None: one shard on ``device``)."""

    def __init__(self, model, opt: Optimizer, data: FederatedDataset,
                 cfg: EngineConfig, *, aug_plan: np.ndarray | None = None,
                 adaptive_aug_alpha: float | None = None,
                 device: str | torch.device | None = None,
                 init_params: Params | None = None,
                 draws: RoundDraws | None = None,
                 loss_fn: LossFn | None = None,
                 telemetry=None, mesh: AbstractMesh | None = None):
        self.model, self.opt, self.data, self.cfg = model, opt, data, cfg
        self.loss_fn = loss_fn
        # host-side spans and metrics around -- never inside -- the round
        # program: on or off, the same bits and the same programs
        self.telemetry = as_telemetry(telemetry)
        if adaptive_aug_alpha is not None and aug_plan is None:
            raise ValueError("adaptive_aug_alpha requires an initial aug_plan")
        self._adaptive_alpha = adaptive_aug_alpha
        self.device = dev = resolve_device(device)
        if mesh is None:
            mesh = AbstractMesh(("mediator",), (1,), (dev,))
        mediator_devices(mesh)                  # raises for a mesh without devices
        if any(d.type != dev.type for d in mesh.devices):
            raise ValueError(f"mesh devices {mesh.devices} are not {dev.type} devices")
        self.mesh = mesh
        self._msize = mesh.shape["mediator"]
        self._model_size = model_axis_size(mesh)
        # the port dimension each parameter splits along over the model
        # axis (None: replicated); None when nothing splits (a 1-D mesh, or
        # a model without param_specs)
        specs = getattr(model, "param_specs", None)
        self._dims = shard_lib.placements(specs(), mesh) \
            if self._model_size > 1 and specs is not None else None
        self._shards: shard_lib.ModelShards | None = None
        # the model column of each shard key a TP tree holds
        self._shard_col = {shard_key(k, j): j for k, dim in (self._dims or {}).items()
                           if dim is not None for j in range(self._model_size)}
        capacity = min(cfg.clients_per_round, data.num_clients)
        store_kw = dict(device=dev, capacity=capacity,
                        prefetch_depth=cfg.store_prefetch_depth,
                        lru_rows=cfg.store_lru_rows, mesh=mesh,
                        exchange=cfg.store_exchange)
        if hasattr(data, "client_images"):
            sizes = [x.shape[0] for x in data.client_images]
            self.pad = _pad_multiple(max(sizes), cfg.local.batch_size)
            self.store = build_client_store(cfg.store, *data.padded(self.pad),
                                            **store_kw)
        else:
            # a streaming federation: rows fetched or synthesized on demand,
            # never materialized, so only the O(c) stores can serve it
            if cfg.store not in ("host", "spilled"):
                raise ValueError(f"streaming federations require the 'host' or "
                                 f"'spilled' client store, got {cfg.store!r}")
            if data.pad % cfg.local.batch_size:
                raise ValueError(f"streaming federation pad {data.pad} is not a "
                                 f"multiple of batch_size {cfg.local.batch_size}")
            self.pad = data.pad
            self.store = build_client_store(cfg.store, source=data, **store_kw)
        self.store.telemetry = self.telemetry
        self._test_x = torch.from_numpy(np.asarray(data.test_images, np.float32)).to(dev)
        self._test_y = torch.from_numpy(np.asarray(data.test_labels)).to(dev)
        self._raw_counts = data.client_counts()
        self._counts = self._raw_counts
        self._rng = np.random.default_rng(cfg.seed)
        self._pending_sels: deque = deque()     # pre-drawn selections
        if init_params is None:
            init = seeded_params(model, cfg.seed, dev)
        else:
            init = {k: torch.as_tensor(v, dtype=torch.float32).to(dev).contiguous()
                    for k, v in init_params.items()}
        self.params = init
        self.store.note_param_residency(
            self._shards.position_bytes() if self._shards is not None
            else sum(v.nbytes for v in init.values()),
            self._model_size if self._dims is not None else 1)
        self.comm = CommMeter(count_params(init))
        self._tp_rows = self._resolve_tp_rows()
        self.draws = draws if draws is not None else SeededDraws(cfg.seed + 1, dev)
        # LoRA: self.params is the frozen backbone; the round trains and
        # folds the adapter state, and a WAN leg carries only that state
        self._lora_mapping: dict | None = None
        self._lora_a: dict | None = None
        self.adapters: dict | None = None
        if cfg.lora_rank is not None:
            if not hasattr(model, "param_specs"):
                raise ValueError("lora_rank requires a model with param_specs (the "
                                 "adapter mapping table is built from them)")
            mapping = lora_lib.build_mapping(model.param_specs(), cfg.lora_rank,
                                             cfg.lora_alpha)
            self._lora_mapping = mapping
            self._lora_a = lora_lib.init_adapter_A(cfg.seed + lora_lib.A_SALT, mapping, dev)
            self.adapters = lora_lib.init_adapter_state(mapping, self.params)
            self.comm.adapter_payload_bytes = lora_lib.exchange_nbytes(
                mapping, self.comm.bytes_per_param)
            self._layout = lora_lib.flat_layout(mapping, self.adapters, init)
        else:
            self._layout = ops.FlatLayout(init)

        self._plan = None
        self.last_plan: np.ndarray | None = None
        if aug_plan is not None:
            plan_np = np.asarray(aug_plan)
            if plan_np.shape != (data.num_classes,):
                raise ValueError(
                    f"aug_plan shape {plan_np.shape} != ({data.num_classes},)")
            self._install_plan(plan_np)
            # adaptive refreshes re-broadcast to each cohort (_pack_schedule)
            self.comm.plan_broadcast(plan_np.size, data.num_clients)
        self.history: list[dict] = []
        self.last_schedule_stats: dict | None = None
        self.last_groups: list[list[int]] | None = None
        self._schedule: tuple | None = None
        self._round = 0
        self._rows: torch.Tensor | None = None      # the (M_pad, N) row outputs
        self._programs: list[_RoundProgram] = []     # one a mediator row
        self._wave_programs: dict[int, _RoundProgram] = {}   # width -> sliced
        self.num_round_traces = 0                    # round programs built
        self.num_schedule_packs = 0                  # host packing events
        # one entry per round program built: "initial" for a width's first
        # program, "retrace" for one built after it for that width
        self.trace_log: list[dict] = []

    @property
    def params(self) -> Params:
        """The weights (the frozen backbone under LoRA), whole on the
        engine's device: on a model axis the shards all-gathered."""
        if self._shards is None:
            return self._params
        return shard_lib.gather_params(self._shards, self.device)

    @params.setter
    def params(self, value: Params) -> None:
        if self._dims is None:
            self._params = value
        else:
            self._shards = shard_lib.shard_params(value, self._dims, self.mesh)

    @property
    def _program(self) -> "_RoundProgram | None":
        """Mediator row 0's round program (the only one on a 1-D mesh of one
        position)."""
        return self._programs[0] if self._programs else None

    def row_positions(self) -> list[tuple[torch.device, ...]]:
        """The devices of each mediator row of the mesh, in order: its
        model columns (``model_devices(mesh, i)``), its home the first.
        Schedule row block ``i`` (``M_pad / n`` rows) trains there."""
        return [model_devices(self.mesh, i) for i in range(self._msize)]

    def _leaf_device(self, key: str, devices: tuple) -> torch.device:
        """Where a row trained on ``devices`` keeps leaf ``key``: a shard
        on its model column's device, anything else on the row's home."""
        return devices[self._shard_col.get(key, 0)]

    def _on_row(self, tree: Params, devices: tuple) -> Params:
        """``tree`` on a row's devices (the mediator axis replicates it;
        nothing moves for a row on the tree's own devices)."""
        return {k: v.to(self._leaf_device(k, devices)) for k, v in tree.items()}

    def _resolve_tp_rows(self) -> bool:
        """``cfg.tp_rows`` against the mesh: TP rows only where parameters
        split over a model axis; ``"auto"`` turns them on on a CUDA device.
        ``True`` runs them on the CPU too (the reference raises there, for
        a crash of XLA's CPU partitioner)."""
        mode = self.cfg.tp_rows
        if mode is False or self._dims is None:
            return False
        on = mode is True or self.device.type == "cuda"
        if on and self.cfg.row_exec == "vmap" and self.device.type == "cuda" \
                and any(len(set(devs)) > 1 for devs in self.row_positions()):
            raise ValueError("tp_rows under row_exec='vmap' captures one CUDA graph a "
                             "mediator row on one card; a row's model columns on several "
                             "cards need row_exec='map'")
        return on

    def _tp_tree(self) -> Params:
        """The shards the TP rows train: model column ``j``'s slice of a
        split leaf under ``shard_key(name, j)``, a replicated leaf whole."""
        tree = {}
        for k, dim in self._dims.items():
            if dim is None:
                tree[k] = self._shards.column(0)[k]
            else:
                for j in range(self._model_size):
                    tree[shard_key(k, j)] = self._shards.column(j)[k]
        return tree

    def row_state(self) -> Params:
        """The tree the rows train from: the adapter state under LoRA, the
        shards under TP rows, else the whole weights (on a model axis,
        gathered: the oracle's round-start gather)."""
        if self._lora_mapping is not None:
            return self.adapters
        if self._tp_rows:
            return self._tp_tree()
        return self.params

    def _row_views(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """Views of a flat row buffer ``flat (..., N)`` keyed like
        ``row_state()``: under TP rows (without LoRA) each shard's slice of
        its leaf's columns."""
        views = self._layout.views(flat)
        if not self._tp_rows or self._lora_mapping is not None:
            return views
        lead, t = flat.dim() - 1, self._model_size
        out = {}
        for k, v in views.items():
            dim = self._dims[k]
            if dim is None:
                out[k] = v
                continue
            size = v.shape[lead + dim] // t
            for j in range(t):
                out[shard_key(k, j)] = v.narrow(lead + dim, j * size, size)
        return out

    def _charge_model_axis(self) -> None:
        """One model-axis gather of the weights on the intra-pod ledger, at
        the reference's size (every position gathers what it lacks)."""
        self.comm.model_axis_round(self._msize * self._model_size, self._model_size)

    @property
    def server_state(self) -> Params:
        """What the round trains and folds: the adapter state under LoRA,
        the weights otherwise."""
        return self.adapters if self._lora_mapping is not None else self.params

    @server_state.setter
    def server_state(self, value: Params) -> None:
        if self._lora_mapping is not None:
            self.adapters = value
        else:
            self.params = value

    def lora_args(self) -> tuple:
        """The frozen operands of a LoRA round: the backbone (its shards
        under TP rows) and the A bases (empty without a mapping)."""
        if self._lora_mapping is None:
            return ()
        return (self._tp_tree() if self._tp_rows else self.params), self._lora_a

    @torch.no_grad()
    def merged_params(self) -> Params:
        """Weights ready to evaluate: the adapter state merged into the
        backbone under LoRA, the weights otherwise."""
        if self._lora_mapping is None:
            return self.params
        return lora_lib.merge_params(self.params, self._lora_a, self.adapters,
                                     self._lora_mapping)

    def load_lora_a(self, a_tree: dict) -> None:
        """Replace the frozen A bases (the reference's, say) with ``a_tree``:
        the same paths and shapes, moved to this engine's device."""
        if self._lora_a is None or set(a_tree) != set(self._lora_a):
            raise ValueError(f"A paths {sorted(a_tree)} != the mapping's "
                             f"{sorted(self._lora_a or {})}")
        new = {k: torch.as_tensor(a_tree[k], dtype=torch.float32).to(self.device)
               .contiguous() for k in self._lora_a}
        bad = [k for k in new if new[k].shape != self._lora_a[k].shape]
        if bad:
            raise ValueError(f"A shapes differ from the mapping's at {bad}")
        self._lora_a = new

    def _row_model(self, frozen: tuple | None = None, devices: tuple | None = None):
        """The model the rows on ``devices`` (mediator row 0's if None)
        train: through the TP layers over those model columns under TP
        rows, and through the adapter state under LoRA, merged into the
        frozen operands ``frozen`` (``lora_args()`` if None)."""
        model = self.model
        if devices is None:
            devices = self.row_positions()[0]
        if self._tp_rows:
            model = TensorParallel(model, self._dims, devices, devices[0])
        if self._lora_mapping is None:
            return model
        backbone, a_tree = self.lora_args() if frozen is None else frozen
        if self._tp_rows:
            return lora_lib.MergedModel(model, backbone, a_tree, self._lora_mapping,
                                        dims=self._dims, t=self._model_size)
        return lora_lib.MergedModel(model, backbone, a_tree, self._lora_mapping)

    def _note_trace(self, fn: str, width: int, position: int | None = None) -> None:
        """Count a round program built and record why, as the reference's
        ``_note_trace`` does for its traces; ``position`` names the mediator
        row of a mesh of several."""
        self.num_round_traces += 1
        first = not any(t["fn"] == fn and t["width"] == width
                        and t.get("position") == position for t in self.trace_log)
        entry = {"fn": fn, "width": width, "round": self._round,
                 "trace_index": self.num_round_traces,
                 "reason": "initial" if first else "retrace"}
        if position is not None:
            entry["position"] = position
        self.trace_log.append(entry)

    def load_params(self, params: Params) -> None:
        """Replace the weights with ``params`` (the same keys and shapes),
        moved to this engine's device and dtypes."""
        if set(params) != set(self.params):
            raise ValueError(f"params keys {sorted(params)} != the model's "
                             f"{sorted(self.params)}")
        new = {k: torch.as_tensor(params[k]).to(device=self.device, dtype=p.dtype)
               .contiguous() for k, p in self.params.items()}
        bad = [k for k in new if new[k].shape != self.params[k].shape]
        if bad:
            raise ValueError(f"params shapes differ from the model's at {bad}")
        self.params = new

    def _install_plan(self, plan_np: np.ndarray) -> None:
        """(Re)place the Alg. 2 plan and rescale the Alg. 3 counts: Alg. 3
        packs by the expected post-augmentation histograms."""
        plan_np = np.asarray(plan_np)
        self.last_plan = plan_np
        self._plan = torch.as_tensor(plan_np, dtype=torch.float32, device=self.device)
        self._counts = self._raw_counts * (1.0 + plan_np.astype(np.float64))

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
        tel = self.telemetry
        if self._adaptive_alpha is not None:
            # the plan of the cohort this round trains on, re-broadcast to it
            with tel.span("plan_refresh", cohort=len(sel)):
                plan_np = augmentation_plan(self._raw_counts[sel].sum(axis=0),
                                            self._adaptive_alpha)
                self._install_plan(plan_np)
                self.comm.plan_broadcast(plan_np.size, len(sel))
        with tel.span("reschedule", cohort=len(sel), schedule=self.cfg.schedule) as rsp:
            groups = self._groups_for(sel)
            if self.last_schedule_stats:
                rsp.set(kld_mean=self.last_schedule_stats.get("kld_mean"),
                        num_mediators=len(groups))
        self.last_groups = groups
        m_real = len(groups)
        m_pad = self.cfg.pad_mediators_to or m_real
        if m_pad < m_real:
            raise ValueError(f"pad_mediators_to={m_pad} smaller than the "
                             f"schedule ({m_real} mediators)")
        m_pad = _pad_multiple(m_pad, self._msize)
        with tel.span("pack", m_real=m_real, m_pad=m_pad, policy=self.store.policy) as psp:
            row_to_group = self.store.place(groups, m_pad)
            idx = np.zeros((m_pad, self.cfg.gamma), np.int64)
            slot = np.zeros((m_pad, self.cfg.gamma), np.float32)
            row_of = np.zeros(m_real, np.int64)
            for r, g in enumerate(row_to_group):
                if g >= 0:
                    row_of[g] = r
                    idx[r, :len(groups[g])] = groups[g]
                    slot[r, :len(groups[g])] = 1.0
            unperm = np.concatenate([row_of, np.flatnonzero(row_to_group < 0)])
            with tel.span("store_stream", policy=self.store.policy) as ssp:
                data, index = self.store.plan(idx, slot)
                ssp.set(bytes=self.store.last_stream_bytes)
                ssp.sync_on(data)
            if self.store.last_stream_bytes:
                # host->device streaming is pod-side traffic: the intra-pod
                # ledger only, so the WAN bytes stay invariant to placement
                self.comm.store_stream(self.store.last_stream_bytes)
            placement = getattr(self.store, "last_placement_stats", None)
            if placement:
                # the store's placement keys under a store_ namespace, so
                # they never overwrite the scheduler's
                self.last_schedule_stats = {
                    **(self.last_schedule_stats or {}),
                    **{f"store_{k}": v for k, v in placement.items()}}
            psp.set(stream_bytes=self.store.last_stream_bytes)
        self.num_schedule_packs += 1
        return data, index, slot, m_real, row_to_group, unperm

    def ensure_schedule(self) -> tuple:
        """(Re)draw the selection and (re)pack the schedule if this round
        needs one: every round for FedAvg, once for Astraea.  With a
        prefetching store and a reschedule every round, the next
        selections are pre-drawn, up to the store's depth ahead, and staged
        in the background; round r's selection is still the (r+1)-th
        ``choice`` call, so the depth never changes a trajectory."""
        cfg = self.cfg
        c = min(cfg.clients_per_round, self.data.num_clients)
        if cfg.reschedule_every_round or self._schedule is None:
            if self._pending_sels:
                sel = self._pending_sels.popleft()
            else:
                sel = self._rng.choice(self.data.num_clients, size=c, replace=False)
            self._schedule = self._pack_schedule(sel)
            if cfg.reschedule_every_round and hasattr(self.store, "prefetch"):
                while len(self._pending_sels) < self.store.prefetch_depth:
                    nxt = self._rng.choice(self.data.num_clients, size=c,
                                           replace=False)
                    self._pending_sels.append(nxt)
                    self.store.prefetch(nxt)
        return self._schedule

    # ------------------------------------------------------------------
    # the round
    # ------------------------------------------------------------------
    def _augment(self, xs, ys, weights, address, plan):
        """Online Alg. 2 over every (row, slot) batch of a block in one warp
        launch on its device.  ``xs (R, pad, H, W, C)``, ``ys``/``weights
        (R, pad)`` with rows ordered (schedule row, slot); schedule row
        ``r`` of the block draws at ``address[r]``; ``plan`` on the block's
        device.  The draws come from the engine's source and move to the
        block's device."""
        gamma = 1 if self.cfg.aggregate == "weights" else self.cfg.gamma
        dev = xs.device
        draws = [self.draws.augment(self._round, int(address[i // gamma]), i % gamma,
                                    weights[i].to(self.device))
                 for i in range(ys.shape[0])]
        idx, u, mats, trans = (torch.stack([d[j] for d in draws]).to(dev) for j in range(4))
        return online_augment_rows(xs, ys, plan, idx, u,
                                   mats.reshape(-1, 2, 2), trans.reshape(-1, 2))

    def _row_buffer(self, m_pad: int) -> torch.Tensor:
        """The ``(m_pad, N)`` float32 buffer the rows' outputs land in (Eq.
        6 reads it whole), allocated when ``m_pad`` changes."""
        if self._rows is None or self._rows.shape[0] != m_pad:
            self._rows = torch.zeros((m_pad, self._layout.total),
                                     dtype=torch.float32, device=self.device)
        return self._rows

    def prepare_round(self) -> RoundInputs:
        """Round ``_round``'s schedule, gathered client data, Eq. 6 sizes
        and -- with a plan -- its online warp, each mediator row's block on
        its home (one warp launch a row over its scheduled slots)."""
        data, index, slot_np, m_real, row_to_group, unperm = self.ensure_schedule()
        m_pad, gamma = slot_np.shape
        homes = [devs[0] for devs in self.row_positions()]
        step = m_pad // len(homes)
        inp = RoundInputs(self._round, slot_np, m_real, [], None, row_to_group, unperm)
        weights = []
        for i, ((xs, ys, mask), home) in enumerate(
                zip(self.store.serve(data, index, homes), homes)):
            rows = slice(i * step, (i + 1) * step)
            ms = mask * to_device(slot_np[rows], home)[..., None]
            plan = None if self._plan is None else self._plan.to(home)
            mult = ms if plan is None else ms * (1.0 + plan[ys.long()])
            weights.append(mult.sum(dim=(1, 2)))            # Eq. 6 sizes
            if plan is not None:
                flat = (step * gamma, self.pad)
                ax, ay = self._augment(xs.reshape(flat + xs.shape[3:]), ys.reshape(flat),
                                       mult.reshape(flat), inp.address[rows], plan)
                xs, ys = ax.reshape(xs.shape), ay.reshape(ys.shape)
            inp.parts.append((xs, ys, ms))
        inp.weights = torch.cat([w.to(self.device) for w in weights])
        return inp

    def _map_row(self, inp: RoundInputs, model, params, r: int, out: torch.Tensor,
                 data: tuple, draws) -> None:
        """Schedule row ``r`` through ``client_update`` / ``mediator_update``
        of ``model`` (``_row_model()``) from ``params`` on its client data
        ``data = (x, y, mask)`` (``(gamma, pad, ...)``) with ``draws`` (the
        round's, on the row's device), into the flat row ``out``."""
        cfg = self.cfg
        at = int(inp.address[r])
        x, y, m = data
        if cfg.aggregate == "weights":
            res = client_update(model, self.opt, cfg.local, params, x[0], y[0], m[0],
                                draws.client(inp.rnd, at, 0, 0), self.loss_fn)
        else:
            res = mediator_update(
                model, self.opt, cfg.local, cfg.mediator_epochs, params, x, y, m,
                lambda e, s: draws.client(inp.rnd, at, e, s)
                if inp.slot[r, s] > 0 else EmptySlotDraws(x.device),
                loss_fn=self.loss_fn)
        for k, v in self._row_views(out).items():
            v.copy_(res[k])

    def _draws_on(self, device: torch.device):
        """The round's draws on ``device`` (the source's own where they
        already land there)."""
        return self.draws if device == self.device else _DrawsOn(self.draws, device)

    def run_rows(self, inp: RoundInputs, params,
                 rows: np.ndarray | None = None) -> torch.Tensor:
        """Local training of schedule ``rows`` (all real rows if None) from
        ``params``, into the ``(M_pad, N)`` row buffer on the engine's
        device, which is returned.  Mediator row ``i`` of the mesh trains
        schedule row block ``i`` on its devices.  Under ``"vmap"`` each
        block is a round program, built (and on the card captured) once per
        ``M_pad``, the rows outside ``rows`` run as no-ops (zero masks);
        every block's program runs before any block's rows are read back.
        Under ``"map"`` each real row in ``rows`` runs alone and every other
        row of the buffer is zero."""
        m_pad = inp.slot.shape[0]
        buf = self._row_buffer(m_pad)
        real = inp.row_to_group >= 0
        member = real.copy()
        if rows is not None:
            member[:] = False
            member[rows] = True
        positions = self.row_positions()
        n = len(positions)
        step = m_pad // n
        lora_args = self.lora_args()
        if self.cfg.row_exec == "map":
            buf.zero_()
            for i, devices in enumerate(positions):
                todo = [r for r in range(i * step, (i + 1) * step) if member[r] and real[r]]
                if not todo:
                    continue
                frozen = tuple(self._on_row(t, devices) for t in lora_args)
                model = self._row_model(frozen or None, devices)
                tree, draws = self._on_row(params, devices), self._draws_on(devices[0])
                xs, ys, ms = inp.parts[i]
                for r in todo:
                    j = r - i * step
                    self._map_row(inp, model, tree, r, buf[r], (xs[j], ys[j], ms[j]), draws)
            return buf
        progs = self._programs
        fresh = len(progs) != n or progs[0].m != step
        if fresh:
            progs = self._programs = []
            for i, devices in enumerate(positions):
                out = buf[i * step:(i + 1) * step] if devices[0] == self.device else \
                    torch.zeros((step, self._layout.total), dtype=torch.float32,
                                device=devices[0])
                progs.append(_RoundProgram(self, out, devices))
                self._note_trace("round_fn", step, i if n > 1 else None)
        warmed = set()
        for i, prog in enumerate(progs):
            block = slice(i * step, (i + 1) * step)
            xs, ys, ms = inp.parts[i]
            if rows is not None:
                ms = ms * to_device(member[block].astype(np.float32), ms.device)[:, None, None]
            prog.load(params, xs, ys, ms, (inp.slot[block] > 0) & member[block, None],
                      inp.rnd, row_ids=inp.address[block], frozen=lora_args)
            if fresh and self.device.type == "cuda":
                prog.capture(warm=prog.device not in warmed)
                warmed.add(prog.device)
        for prog in progs:
            prog.run()
        for i, prog in enumerate(progs):
            if prog.device != self.device:
                buf[i * step:(i + 1) * step].copy_(prog.rows)
        return buf

    def run_rows_sliced(self, inp: RoundInputs, params,
                        rows: np.ndarray) -> torch.Tensor:
        """Local training of just the real schedule ``rows`` from
        ``params`` (a store that keeps schedule order only), on mediator
        row 0's devices: ``(len(rows), N)``, row ``i`` the output of
        schedule row ``rows[i]``, whose draws it asks for.  Under
        ``"vmap"`` it is a round program of that width, built (and on the
        card captured) at its first use and cached for the engine's life;
        the result is its static row buffer, which the next call of that
        width overwrites.  Under ``"map"`` the rows run one by one into a
        fresh buffer."""
        if self.store.permutes_rows:
            raise ValueError(f"the {self.store.policy!r} store reads each row on the "
                             f"shard its position gives it; run its waves masked")
        rows = np.asarray(rows, np.int64)
        n = int(rows.size)
        devices = self.row_positions()[0]
        xs, ys, ms = inp.whole(self.device)
        if self.cfg.row_exec == "map":
            out = torch.empty((n, self._layout.total), dtype=torch.float32,
                              device=self.device)
            frozen = tuple(self._on_row(t, devices) for t in self.lora_args())
            model = self._row_model(frozen or None, devices)
            tree, draws = self._on_row(params, devices), self._draws_on(devices[0])
            for i, r in enumerate(rows):
                r = int(r)
                data = tuple(a[r].to(devices[0]) for a in (xs, ys, ms))
                self._map_row(inp, model, tree, r, out[i], data, draws)
            return out
        prog = self._wave_programs.get(n)
        fresh = prog is None
        if fresh:
            prog = _RoundProgram(self, torch.zeros((n, self._layout.total),
                                                   dtype=torch.float32,
                                                   device=devices[0]), devices)
            self._wave_programs[n] = prog
            self._note_trace("wave_fn", n)
        pick = to_device(rows, self.device)
        prog.load(params, xs[pick], ys[pick], ms[pick],
                  inp.slot[rows] > 0, inp.rnd, row_ids=inp.address[rows],
                  frozen=self.lora_args())
        if fresh and self.device.type == "cuda":
            prog.capture()
        prog.run()
        return prog.rows.to(self.device)

    def programs(self) -> dict:
        """The round programs built, by width (``M_pad / n`` for a mediator
        row's, ``round@i`` on a mesh of several rows; a wave's width for a
        sliced one): their static buffer bytes and their graphs' pool bytes
        (0 off the card)."""
        rounds = [("round", p) for p in self._programs] if len(self._programs) < 2 else \
            [(f"round@{i}", p) for i, p in enumerate(self._programs)]
        progs = rounds + [(f"wave[{w}]", p) for w, p in sorted(self._wave_programs.items())]
        return {name: {"width": p.m, "buffer_bytes": p.buffer_bytes,
                       "graph_pool_bytes": p.pool_bytes} for name, p in progs}

    def noop_rows(self, state, n: int) -> torch.Tensor:
        """``n`` copies of a no-op row's output (an all-zero mask under
        Adam): zero deltas, or the trained tree ``state`` itself -- what the
        round program writes for a dummy row.  Their Eq. 6 weight is 0."""
        out = torch.zeros((n, self._layout.total), dtype=torch.float32,
                          device=self.device)
        if self.cfg.aggregate == "weights":
            for k, v in self._row_views(out).items():
                v.copy_(state[k].expand_as(v))
        return out

    def in_mediator_order(self, inp: RoundInputs, rows: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
        """The round's ``(M_pad, N)`` rows and Eq. 6 weights with a placing
        store's permutation undone: mediators in order, dummies last."""
        if not self.store.permutes_rows:
            return rows, inp.weights
        order = to_device(inp.unperm, self.device)
        return rows[order], inp.weights[order]

    def charge_exchange(self) -> None:
        """One execution of the sharded store's serve exchange, on the
        intra-pod ledger and the timeline (nothing for other stores)."""
        nbytes = self.store.exchange_bytes_per_round
        if nbytes:
            self.comm.store_exchange(nbytes)
            self.telemetry.instant("store_exchange", bytes=nbytes)

    def fold(self, rows: torch.Tensor, weights: torch.Tensor) -> None:
        """Eq. 6 over the stack ``rows (M, N)`` with ``weights (M,)`` (one
        ``fedavg_agg`` launch; none for an empty adapter state), folded
        into ``server_state``: the aggregate replaces it (FedAvg) or is
        added to it (Astraea).  The one tail of the sync round and the
        async commit."""
        agg = ops.fedavg_agg_flat(rows, weights, self._layout)
        add = self.cfg.aggregate != "weights"
        if self._shards is not None and self._lora_mapping is None:
            # on a model axis each shard takes its slice, never gathered
            self._shards = shard_lib.fold_shards(self._shards, agg, add)
        elif add:
            state = self.server_state
            self.server_state = {k: state[k] + agg[k] for k in state}
        else:
            self.server_state = agg

    def state_at_rest(self):
        """The folded state as held: the adapter state under LoRA, each
        position's shards on a model axis (nothing gathered), else the
        weights.  What a span waits on."""
        if self._lora_mapping is not None:
            return self.adapters
        return self._shards.positions if self._shards is not None else self._params

    def run_round(self) -> None:
        cfg, tel = self.cfg, self.telemetry
        c = min(cfg.clients_per_round, self.data.num_clients)
        wan0 = self.comm.total_bytes
        with tel.span("round", round=self._round, cohort=c, schedule=cfg.schedule,
                      policy=cfg.store) as rsp:
            inp = self.prepare_round()
            with tel.span("aggregate", mediators=inp.m_real) as asp:
                self.fold(*self.in_mediator_order(inp, self.run_rows(inp, self.row_state())))
                asp.sync_on(self.state_at_rest())
            if cfg.aggregate == "weights":
                self.comm.fedavg_round(c)
            else:
                self.comm.astraea_round(c, cfg.gamma, cfg.mediator_epochs)
            if self._model_size > 1 and (self._lora_mapping is None or not self._tp_rows):
                # the intra-pod ledger only, by the reference's rule: TP rows
                # with LoRA gather nothing (the backbone stays split, the
                # adapters are whole); the oracle gathers the weights or the
                # backbone once a round (``row_state`` / ``lora_args``), TP
                # rows move activations and input gradients instead
                self._charge_model_axis()
            self.charge_exchange()
            self.comm.end_round()
            self._round += 1
            rsp.set(wan_bytes=self.comm.total_bytes - wan0, traces=self.num_round_traces)
        tel.observe_round(self, duration_s=rsp.duration_s)

    def evaluate(self) -> dict:
        """Test-set metrics now, with the history keys."""
        m = evaluate(self.model, self.merged_params(), self._test_x, self._test_y)
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



# one capture stream a card: ``torch.cuda.graph``'s default is one stream
# for the process, on the card current at its first use, so a program on
# another card would record nothing and run its body eagerly once
_CAPTURE_STREAMS: dict = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


class _RoundProgram:
    """The lockstep round's local training over fixed ``(M, gamma, pad)``
    rows (``M`` the padded mediator count, or a wave's width).  It reads only its static buffers -- the stacked weights
    ``p0``, the client data ``x``/``y``/``mask`` and the draws ``perms``
    ``(M, gamma, E_m, E, pad)`` and ``keeps`` (per dropout site ``(M,
    gamma, E_m, E, pad / B, *site)``) -- and writes each row's output (the
    new weights for FedAvg, the delta for Astraea) into the engine's ``(M,
    N)`` row buffer.  ``load`` fills the buffers before each round; on a
    CUDA device ``capture`` records the body once as a CUDA graph and
    ``run`` replays it.  It holds no reference to its engine, so a
    finished engine frees its graph at once rather than whenever the
    garbage collector runs (which may be inside another capture).  It
    trains on one mediator row's ``devices`` (its home the first, where the
    client data, the draws and ``rows`` live; a TP row's shards each on its
    model column's device)."""

    def __init__(self, engine: FLRoundEngine, rows: torch.Tensor, devices: tuple):
        cfg, dev = engine.cfg, devices[0]
        self.opt, self.loss_fn = engine.opt, engine.loss_fn
        self.local, self.draws, self.device = cfg.local, engine.draws, dev
        self.graph = None
        self.pool_bytes = 0           # the captured graph's private pool
        self.m, self.gamma = rows.shape[0], cfg.gamma
        self.weights_out = cfg.aggregate == "weights"
        self.mediator_epochs = 1 if self.weights_out else cfg.mediator_epochs
        self.lead = (self.m, self.gamma, self.mediator_epochs, cfg.local.epochs)
        self.sites = engine.model.dropout_sites(cfg.local.batch_size)
        self.pad = engine.pad
        shape = (self.m, self.gamma, engine.pad)
        # each leaf on its own device: a shard on its model column's
        where = engine._leaf_device
        self.p0 = {k: torch.zeros((self.m,) + p.shape, dtype=p.dtype,
                                  device=where(k, devices))
                   for k, p in engine.row_state().items()}
        # under LoRA the rows train the adapter state through the frozen
        # backbone and A bases, static buffers filled by ``load``
        self.frozen = tuple({k: torch.empty_like(v, device=where(k, devices))
                             for k, v in tree.items()} for tree in engine.lora_args())
        self.model = engine._row_model(self.frozen or None, devices)
        (x_shape, x_dtype), (_, y_dtype), _ = engine.store.row_specs
        self.x = torch.zeros(shape + tuple(x_shape[1:]), device=dev,
                             dtype=torch.from_numpy(np.zeros(0, x_dtype)).dtype)
        self.y = torch.zeros(shape, device=dev,
                             dtype=torch.from_numpy(np.zeros(0, y_dtype)).dtype)
        self.mask = torch.zeros(shape, dtype=torch.float32, device=dev)
        # an inactive (row, slot) keeps whatever indices it holds: its mask
        # is zero, so any valid permutation gives the same no-op
        self.perms = torch.zeros(self.lead + (engine.pad,), dtype=torch.int64,
                                 device=dev)
        self.keeps = [torch.ones(self.lead + (engine.pad // cfg.local.batch_size,)
                                 + tuple(site), dtype=torch.bool, device=dev)
                      for site, _ in self.sites]
        self.rows = rows
        self.out = engine._row_views(rows)

    def load(self, params, xs, ys, ms, active: np.ndarray, rnd: int,
             row_ids: np.ndarray | None = None, frozen: tuple = ()) -> None:
        """Fill the static buffers for round ``rnd``: the trained tree
        broadcast to every row, the frozen LoRA operands (``frozen``, the
        engine's ``lora_args()``), the (augmented) client data, and the
        draws of every active ``(row, slot)`` at the addresses ``"map"``
        asks for -- row ``r`` of the program is schedule row ``row_ids[r]``
        (``r`` itself if None), so a mediator draws the same numbers in any
        wave."""
        for k, p in params.items():
            self.p0[k].copy_(p.expand_as(self.p0[k]))
        for buf, tree in zip(self.frozen, frozen):
            for k, v in buf.items():
                v.copy_(tree[k])
        self.x.copy_(xs)
        self.y.copy_(ys)
        self.mask.copy_(ms)
        steps = self.keeps[0].shape[4]
        for r, s in zip(*np.nonzero(active)):
            row = int(r) if row_ids is None else int(row_ids[r])
            for e in range(self.mediator_epochs):
                d = self.draws.client(rnd, row, e, int(s))
                for ep in range(self.lead[3]):
                    self.perms[r, s, e, ep].copy_(d.permutation(ep, self.pad))
                    for buf, k in zip(self.keeps,
                                      d.epoch_keep_masks(ep, steps, self.sites)):
                        buf[r, s, e, ep].copy_(k)

    def _body(self) -> None:
        if self.weights_out:
            out = client_update_rows(
                self.model, self.opt, self.local, self.p0, self.x[:, 0],
                self.y[:, 0], self.mask[:, 0], self.perms[:, 0, 0],
                [k[:, 0, 0] for k in self.keeps], self.loss_fn)
        else:
            out = mediator_update_rows(
                self.model, self.opt, self.local, self.mediator_epochs, self.p0,
                self.x, self.y, self.mask, self.perms, self.keeps, self.loss_fn)
        for k, v in self.out.items():
            v.copy_(out[k])

    def capture(self, warm: bool = True) -> None:
        """Record ``_body`` as a CUDA graph after one eager run of it on a
        side stream (so the libraries set themselves up outside the
        capture; ``warm=False`` skips that run where a program of the same
        shapes was just run and captured on the same card).  The capture is relaxed and runs with the cyclic garbage
        collector off: a library that still sets something up (cuDNN
        building a plan it had not cached, an allocation), or an object the
        collector frees, may call the CUDA runtime mid-capture, which a
        strict capture turns into a failure (the card tests met such
        failures, now and then, at ``cinic_cnn``'s width).  Reading a
        device value or synchronizing the stream still fails the capture,
        and then this raises: the round never falls back to eager."""
        with torch.cuda.device(self.device):
            self._capture(warm)

    def _capture(self, warm: bool) -> None:
        dev = self.device
        if warm:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._body()
            torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        # what the graph's private memory pool reserves: the capture's
        # reservation, the warm-up's cached blocks released before it
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        try:
            with torch.cuda.graph(graph, stream=_capture_stream(dev),
                                  capture_error_mode="relaxed"):
                gc.disable()
                self._body()
        except RuntimeError as err:
            raise RuntimeError("capturing the round's local training as a CUDA "
                               "graph failed (row_exec='vmap' has no eager "
                               "fallback on the card; row_exec='map' runs "
                               "eagerly)") from err
        finally:
            if collecting:
                gc.enable()
        self.graph = graph
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved

    @property
    def buffer_bytes(self) -> int:
        """Device bytes of the static buffers the program reads and writes."""
        frozen = [t for tree in self.frozen for t in tree.values()]
        return sum(t.nbytes for t in (*self.p0.values(), *frozen, self.x, self.y,
                                      self.mask, self.perms, *self.keeps, self.rows))

    def run(self) -> None:
        if self.graph is None:
            self._body()
        else:
            with torch.cuda.device(self.device):
                self.graph.replay()


class _DrawsOn:
    """A round's draws (``RoundDraws``) handed to rows that train on
    another device than the source draws on: each client update's
    permutations and keep-masks moved there."""

    def __init__(self, draws, device: torch.device):
        self.draws, self.device = draws, device

    def client(self, *address):
        return _ClientDrawsOn(self.draws.client(*address), self.device)


class _ClientDrawsOn:
    def __init__(self, inner, device: torch.device):
        self.inner, self.device = inner, device

    def permutation(self, epoch, n):
        return self.inner.permutation(epoch, n).to(self.device)

    def epoch_keep_masks(self, epoch, steps, sites):
        return [k.to(self.device) for k in self.inner.epoch_keep_masks(epoch, steps, sites)]
