"""Meshes and the multi-process runtime of the mediator axis
(``repro/launch/mesh.py``).

The reference's production target is a pod of TPU chips:

  single pod: (data=16, model=16)            -- 256 devices
  multi pod:  (pod=2, data=16, model=16)     -- 512 devices

Here a mesh is an ``AbstractMesh``: axis names and their sizes, which the
sharding rules (``launch/sharding.py``) and the dry run
(``launch/dryrun.py``) read, and optionally ``devices``, one
``torch.device`` per mesh position, which the FL round engine and the
sharded client store place their shards on.  ``make_mediator_mesh(4,
devices=(cuda:0,) * 4)`` is four logical shards on one card.

Several processes (``init_distributed``) join one ``torch.distributed``
``TCPStore`` and a ``gloo`` process group.  Nothing crosses processes but
host-side payloads, as in the reference: ``ProcessWaveDispatcher`` shards
the async engine's waves over processes, each wave run by one owner on its
``process_local_mesh`` and its result published through the store.

The ``(mediator, model)`` mesh of the FL round engine (``make_fl_mesh``)
lays its positions out row-major: position ``i * t + j`` is model column
``j`` of mediator row ``i``.  As in the reference, the model axis's
collectives stay inside one process (``launch/model_axis.py``): positions
are logical places for shards, several of them may name one card, and a
collective between positions on two cards is a peer copy.
"""
from __future__ import annotations

import io
import math
import os
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch

@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names in order, their sizes, and optionally its
    devices, one ``torch.device`` per position in row-major order."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    devices: tuple[torch.device, ...] | None = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) or any(s < 1 for s in self.sizes):
            raise ValueError(f"bad mesh {self.axis_names} {self.sizes}")
        if self.devices is not None:
            # a card named without an index is the current card, so that
            # positions compare equal to the devices the engine resolves
            devs = tuple(torch.device("cuda", torch.cuda.current_device())
                         if torch.device(d).type == "cuda" and torch.device(d).index is None
                         else torch.device(d) for d in self.devices)
            if len(devs) != self.size:
                raise ValueError(f"mesh of {self.size} positions given {len(devs)} devices")
            if len({d.type for d in devs}) != 1:
                raise ValueError(f"mesh devices of mixed types: {devs}")
            object.__setattr__(self, "devices", devs)

    @property
    def shape(self) -> dict[str, int]:
        """``{axis: size}`` in axis order, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def make_host_mesh() -> AbstractMesh:
    """The degenerate one-device mesh: one card, or the CPU."""
    return AbstractMesh(("data", "model"), (1, 1))


def _visible_cards() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _card_devices(n: int, what: str) -> tuple[torch.device, ...]:
    """The first ``n`` visible cards, one a position: more positions than
    cards need ``devices`` spelled out, else this raises rather than
    doubling positions up silently."""
    cards = _visible_cards()
    if n < 1:
        raise RuntimeError("no CUDA device is visible; pass devices (e.g. "
                           "(torch.device('cpu'),) * n) for a mesh of logical positions")
    if n > cards:
        raise ValueError(f"{what} on {cards} visible card(s): pass devices "
                         f"explicitly for logical positions")
    return tuple(torch.device("cuda", i) for i in range(n))


def make_mediator_mesh(n: int | None = None, devices=None) -> AbstractMesh:
    """The 1-D ``mediator`` mesh of the FL round engine.  ``n`` defaults to
    the visible card count, one card a shard.  More shards than cards --
    four logical shards on one card, or on the CPU -- need ``devices``
    spelled out (``(torch.device("cuda", 0),) * 4``); without them such an
    ``n`` raises rather than doubling shards up silently."""
    if devices is not None:
        devices = tuple(torch.device(d) for d in devices)
        if n is not None and n != len(devices):
            raise ValueError(f"make_mediator_mesh({n}) given {len(devices)} devices")
        return AbstractMesh(("mediator",), (len(devices),), devices)
    n = _visible_cards() if n is None else int(n)
    return AbstractMesh(("mediator",), (n,),
                        _card_devices(n, f"make_mediator_mesh({n})"))


def make_fl_mesh(*, mediator: int | None = None, model: int = 1,
                 devices=None) -> AbstractMesh:
    """The FL round engine's 2-D ``(mediator, model)`` mesh
    (``repro/launch/mesh.py::make_fl_mesh``): the mediator axis carries the
    mediator rows, the model axis shards each row's parameters by the rule
    tables (``launch/sharding.py``).  ``devices`` gives one device a
    position in row-major order (``(cuda:0,) * 4`` is a 2 x 2 mesh on one
    card); without it the positions take the visible cards, one each, and
    ``mediator=None`` spreads them over the mediator axis, which the card
    count must allow.  ``model=1`` is the 1-D mesh's program with a
    size-1 model axis."""
    model = int(model)
    if model < 1:
        raise ValueError(f"model axis size must be >= 1, got {model}")
    if devices is not None:
        devices = tuple(torch.device(d) for d in devices)
        if len(devices) % model:
            raise ValueError(f"{len(devices)} devices are not divisible by a model "
                             f"axis of {model}")
        if mediator is None:
            mediator = len(devices) // model
        if mediator * model != len(devices):
            raise ValueError(f"a {mediator} x {model} mesh given {len(devices)} devices")
        return AbstractMesh(("mediator", "model"), (int(mediator), model), devices)
    if mediator is None:
        cards = _visible_cards()
        if cards % model or cards < model:
            raise ValueError(f"{cards} visible card(s) are not divisible by a model "
                             f"axis of {model}")
        mediator = cards // model
    n = int(mediator) * model
    return AbstractMesh(("mediator", "model"), (int(mediator), model),
                        _card_devices(n, f"make_fl_mesh(mediator={mediator}, model={model})"))


def default_fl_mesh(model_parallel: int = 1) -> AbstractMesh:
    """The engine's default mesh: the 1-D mediator mesh over the visible
    cards, or with ``model_parallel > 1`` the 2-D mesh over them (the card
    count must be a multiple of it)."""
    if model_parallel <= 1:
        return make_mediator_mesh()
    return make_fl_mesh(model=model_parallel)


def resolve_fl_mesh(mesh, model_parallel: int | None):
    """The trainers' mesh: an explicit ``mesh`` wins; else a
    ``model_parallel`` knob builds ``default_fl_mesh``; else None (the
    engine's one-shard default)."""
    if mesh is not None or model_parallel is None:
        return mesh
    return default_fl_mesh(model_parallel)


def mediator_devices(mesh: AbstractMesh) -> tuple[torch.device, ...]:
    """The devices along the ``mediator`` axis: model column 0's on a 2-D
    mesh (the client axis of a sharded store partitions over the mediator
    rows and is replicated along each row's model columns)."""
    if mesh.devices is None:
        raise ValueError(f"mesh {mesh.shape} carries no devices; build it with "
                         f"make_mediator_mesh / make_fl_mesh or pass devices")
    return mesh.devices[::model_axis_size(mesh)]


def model_devices(mesh: AbstractMesh, row: int = 0) -> tuple[torch.device, ...]:
    """The devices of mediator row ``row``'s model columns, in order."""
    if mesh.devices is None:
        raise ValueError(f"mesh {mesh.shape} carries no devices")
    t = model_axis_size(mesh)
    return mesh.devices[row * t:(row + 1) * t]


@dataclass(frozen=True)
class MediatorSharding:
    """The client axis of a sharded store split into contiguous blocks over
    the ``mediator`` axis: shard ``d`` on ``devices[d]`` owns clients
    ``[d * k_local, (d + 1) * k_local)``."""
    devices: tuple[torch.device, ...]
    k_local: int

    @property
    def num_shards(self) -> int:
        return len(self.devices)

    def owner(self, cid: int) -> int:
        return cid // self.k_local

    def rows(self, shard: int) -> slice:
        return slice(shard * self.k_local, (shard + 1) * self.k_local)


def mediator_sharding(mesh: AbstractMesh, num_clients: int) -> MediatorSharding:
    """How ``num_clients`` rows split over ``mesh``'s mediator axis: ``K``
    padded up to a multiple of the shard count, ``K_pad / n`` rows a
    shard."""
    devices = mediator_devices(mesh)
    n = len(devices)
    return MediatorSharding(devices, -(-int(num_clients) // n))


def model_axis_size(mesh: AbstractMesh) -> int:
    """Size of the tensor-parallel ``model`` axis (1 without one)."""
    return mesh.shape.get("model", 1)


def data_axes(mesh: AbstractMesh) -> tuple[str, ...]:
    """Mesh axes that carry the batch: ("pod", "data") or ("data",)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def ring_permutation(n: int, step: int) -> list[tuple[int, int]]:
    """The step-``s`` rotation over an ``n``-device axis as ``(source,
    dest)`` pairs: at hop ``s`` shard ``o`` sends to ``(o + s) % n``, so
    every hop is a full permutation (the ragged client-store exchange's
    decomposition of its all-to-all)."""
    if not 0 < step < n:
        raise ValueError(f"ring step must be in (0, {n}), got {step}")
    return [(o, (o + step) % n) for o in range(n)]


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------

@dataclass
class _World:
    store: object
    rank: int
    size: int


_WORLD: _World | None = None
JOIN_TIMEOUT_S = 120


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Join the processes of a run: a ``torch.distributed.TCPStore`` at the
    coordinator's ``host:port`` (rank 0 hosts it) and a ``gloo`` process
    group over it.  The arguments fall back to torchrun's environment
    (``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); where a launcher
    already hosts the store (``TORCHELASTIC_USE_AGENT_STORE=True``, as
    torchrun sets), every rank joins it as a client.  A single-process
    setting is a no-op returning False; joining again is a no-op returning
    True."""
    global _WORLD
    if coordinator is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1") or "1")
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0") or "0")
    if not coordinator or num_processes <= 1:
        return False
    if _WORLD is not None:
        return True
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside [0, {num_processes})")
    import torch.distributed as dist
    host, port = coordinator.rsplit(":", 1)
    hosted = os.environ.get("TORCHELASTIC_USE_AGENT_STORE") == "True"
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0 and not hosted,
                          timeout=timedelta(seconds=JOIN_TIMEOUT_S))
    dist.init_process_group("gloo", store=store, rank=process_id,
                            world_size=num_processes,
                            timeout=timedelta(seconds=JOIN_TIMEOUT_S))
    _WORLD = _World(store, process_id, num_processes)
    return True


def coordination_client():
    """The joined run's ``TCPStore``, or None in a single-process run: the
    host-side key-value store and barrier the wave dispatcher exchanges
    payloads through."""
    return None if _WORLD is None else _WORLD.store


def process_local_mesh(model: int = 1, *, device=None) -> AbstractMesh:
    """This process's own mesh: the 1-D one-device mediator mesh, or with
    ``model > 1`` a ``1 x model`` mesh whose positions all sit on this
    process's device (the model axis's collectives stay in the process, as
    the reference's do).  ``device`` names the device (two processes
    sharing one card both pass ``cuda:0``); None takes the card of
    torchrun's ``LOCAL_RANK`` (0 without it), and raises without a card."""
    from repro_torch.device import resolve_device
    model = int(model)
    if model < 1:
        raise ValueError(f"model axis size must be >= 1, got {model}")
    if device is None:
        index = int(os.environ.get("LOCAL_RANK", "0") or "0")
        cards = _visible_cards()
        device = f"cuda:{index % cards}" if cards else None
    dev = resolve_device(device)
    if model == 1:
        return make_mediator_mesh(devices=(dev,))
    return make_fl_mesh(mediator=1, model=model, devices=(dev,) * model)


class ProcessWaveDispatcher:
    """Round-robin wave ownership and the host-side payload exchange.

    The async engine asks ``owner_of`` which process runs wave ``w`` of
    round ``r``; that process runs it and ``publish``-es the result, every
    other one ``receive``-s it.  Ownership is a pure function of ``(r,
    w)``, so the processes agree on it without talking, and each books the
    same WAN charges.  Payloads are framed with ``np.savez`` (ordered,
    dtype- and shape-preserving) and read with ``allow_pickle=False``,
    under keys ``<namespace>/<tag>`` that are never reused (a second
    workload in the same run takes a namespace of its own); a read that
    waits past ``timeout_s`` raises."""

    def __init__(self, client=None, *, process_index: int | None = None,
                 num_processes: int | None = None, timeout_s: float = 120.0,
                 namespace: str = "astraea"):
        self.client = client if client is not None else coordination_client()
        if self.client is None:
            raise ValueError("ProcessWaveDispatcher needs a joined run "
                             "(call init_distributed first) or a store")
        self.process_index = _WORLD.rank if process_index is None else int(process_index)
        self.num_processes = _WORLD.size if num_processes is None else int(num_processes)
        if self.num_processes < 1 or not 0 <= self.process_index < self.num_processes:
            raise ValueError(f"process {self.process_index} of {self.num_processes}")
        self.timeout = timedelta(seconds=timeout_s)
        self.num_published = 0
        self.num_received = 0
        self.namespace = namespace
        self._tags: set[str] = set()

    def owner_of(self, round_idx: int, wave_idx: int) -> int:
        """The waves of a round spread over the processes, the offset
        rotating every round so short rounds do not leave the high ranks
        idle."""
        return (int(round_idx) + int(wave_idx)) % self.num_processes

    def publish(self, tag: str, arrays) -> None:
        if tag in self._tags:
            raise ValueError(f"payload tag {tag!r} already published")
        self._tags.add(tag)
        buf = io.BytesIO()
        np.savez(buf, *[np.asarray(a) for a in arrays])
        self.client.set(f"{self.namespace}/{tag}", buf.getvalue())
        self.num_published += 1

    def receive(self, tag: str) -> list[np.ndarray]:
        key = f"{self.namespace}/{tag}"
        self.client.wait([key], self.timeout)
        with np.load(io.BytesIO(self.client.get(key)), allow_pickle=False) as z:
            out = [z[f"arr_{i}"] for i in range(len(z.files))]
        self.num_received += 1
        return out

    def barrier(self, name: str) -> None:
        """Every process waits here until all have arrived (or raises after
        the timeout); each ``name`` is used once."""
        key = f"{self.namespace}/barrier/{name}"
        if self.client.add(key, 1) == self.num_processes:
            self.client.set(f"{key}/open", b"1")
        self.client.wait([f"{key}/open"], self.timeout)
