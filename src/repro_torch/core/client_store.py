"""Client data placement: where the packed ``(K, pad, ...)`` federation lives.

The round engine never touches raw client arrays; it talks to a
``ClientStore`` that owns the packed per-client rows and turns a host-side
schedule (``idx (M_pad, gamma)`` client ids + 0/1 ``slot`` mask) into
per-slot device tensors.  Three placement policies, as in the JAX
package's ``core/client_store.py``:

===========  ====================  =========================================
policy       device bytes          traffic
===========  ====================  =========================================
replicated   K * slice             none (gathers are device-local)
host         U_cap * slice         per RESCHEDULE, host->device copy of the
             (U_cap = min(K, c))   <= c unique scheduled clients
spilled      U_cap * slice         the ``host`` stream, but the federation
             (+ an LRU row cache   lives in a disk/mmap tier (or a lazy
             on the host, default  per-client synthesizer); up to
             2 * U_cap rows)       ``prefetch_depth`` future reschedules'
                                   clients are read on background threads
                                   while the card computes, and rows reused
                                   across schedules come from the LRU cache
===========  ====================  =========================================

The fourth policy, ``sharded`` (``ShardedStore``), partitions the client
axis over the ``mediator`` axis of a mesh (``launch/mesh.py``): shard
``d`` holds clients ``[d * K_local, (d + 1) * K_local)`` in its own buffer
on its mesh device -- ``K / n`` rows a device -- and each round moves the
scheduled clients that a row reads from another shard between the shards
(the serve exchange, run on the devices), charged to the intra-pod ledger.

The round engine trains each mediator row of its mesh on that row's
devices and asks ``serve`` for each row's block of slots on its home: the
sharded store serves them from its shards and the exchange's receive
buffers; the other stores gather on the engine's device and copy each
block to its row (the reference replicates them over the mediator axis).

On the card the streaming stores keep two pinned host staging buffers and
one compact device buffer of ``U_cap`` rows, all allocated once.  A
reschedule fills a staging buffer on the host and copies it into the
device buffer with ``non_blocking=True`` on a copy stream; the copy first
waits for the work already enqueued on the round's stream (which may still
read the device buffer), and the round's stream then waits on the copy's
event -- no host sync.  A staging buffer is refilled only after the event
of its previous copy (two reschedules back) has completed.  On the CPU the
same copies run in order.

All policies are bit-identical: gathers and copies move exact values, and
an inactive slot (mask zero) is a no-op whichever row it gathers.  The
spill tier's prefetch changes *when* bytes move, never which bytes: a
prefetched stage and a synchronous read take the same path.  Every
host->device copy is reported through ``last_stream_bytes``; the engine
charges it to the intra-pod ledger (``CommMeter.store_stream``), never to
the WAN ledger.
"""
from __future__ import annotations

import os
import tempfile
import threading
from collections import deque

import numpy as np
import torch

from repro_torch.core import scheduling
from repro_torch.device import to_device
from repro_torch.launch.mesh import mediator_sharding, ring_permutation
from repro_torch.obs.telemetry import NULL_TELEMETRY

POLICIES = ("replicated", "sharded", "host", "spilled")
EXCHANGES = ("ragged", "gather")


def _bytes(*arrays) -> int:
    return int(sum(a.nbytes for a in arrays))


# --------------------------------------------------------------------------
# Row sources: where the packed federation physically lives.  The streaming
# stores read batches of client rows through this protocol -- ``num_clients``,
# ``row_specs`` (trailing shape + dtype per x/y/mask array),
# ``nbytes_per_client`` and ``rows(ids)`` -- so the same store code serves
# RAM arrays, a disk/mmap spill tier, or a lazy synthesizer
# (``data.synthetic.StreamingFederation``).
# --------------------------------------------------------------------------

class PackedClients:
    """The packed ``(K, pad, ...)`` federation held in host RAM."""

    def __init__(self, xs, ys, mask):
        self._arrays = (np.asarray(xs), np.asarray(ys), np.asarray(mask))

    @property
    def num_clients(self) -> int:
        return int(self._arrays[0].shape[0])

    @property
    def row_specs(self) -> tuple:
        return tuple((a.shape[1:], a.dtype) for a in self._arrays)

    @property
    def nbytes_per_client(self) -> int:
        return _bytes(*(a[:1] for a in self._arrays))

    def rows(self, ids: np.ndarray) -> tuple:
        return tuple(a[ids] for a in self._arrays)


class MmapClients:
    """Disk/mmap tier: the packed federation spilled to per-array memmaps.

    Construction writes each packed array once; row reads fancy-index the
    memmaps, touching only the requested clients' pages."""

    def __init__(self, xs, ys, mask, spill_dir: str | None = None):
        self.spill_dir = spill_dir or tempfile.mkdtemp(prefix="astraea-spill-")
        os.makedirs(self.spill_dir, exist_ok=True)
        self._maps = []
        for name, a in (("x", xs), ("y", ys), ("m", mask)):
            a = np.asarray(a)
            mm = np.memmap(os.path.join(self.spill_dir, f"clients_{name}.mmap"),
                           dtype=a.dtype, mode="w+", shape=a.shape)
            mm[:] = a
            mm.flush()
            self._maps.append(mm)

    @property
    def num_clients(self) -> int:
        return int(self._maps[0].shape[0])

    @property
    def row_specs(self) -> tuple:
        return tuple((a.shape[1:], a.dtype) for a in self._maps)

    @property
    def nbytes_per_client(self) -> int:
        return _bytes(*(a[:1] for a in self._maps))

    def rows(self, ids: np.ndarray) -> tuple:
        return tuple(np.asarray(a[ids]) for a in self._maps)


class ClientStore:
    """The engine-facing contract.

    * ``plan(idx, slot)``: schedule-time remapping, once per reschedule;
      returns ``(data, index)``, the device arrays and the device gather
      index ``(M_pad, gamma)`` into them.
    * ``slot_data(data, index)``: the ``(M_pad, gamma, pad, ...)`` x / y /
      mask slot tensors (the mask not yet scaled by the slot mask) on the
      engine's device.
    * ``serve(data, index, homes)``: the same slots as ``len(homes)``
      equal blocks of schedule rows, block ``i`` on ``homes[i]``.
    * ``row_specs``: each array's per-client shape and numpy dtype.
    * ``last_stream_bytes``: what the latest ``plan`` copied host->device.
    * ``telemetry``: the ``obs`` handle the engine installs (the spilled
      store marks each prefetch hit or miss with a ``store_prefetch``
      instant); the no-op one by default.
    """

    policy: str
    # whether ``place`` puts mediators on rows other than their schedule
    # order (the engine then undoes it before Eq. 6)
    permutes_rows = False
    last_stream_bytes: int = 0
    # what every execution of the current plan moves between shards
    exchange_bytes_per_round: int = 0
    telemetry = NULL_TELEMETRY
    # (parameter bytes a mesh position holds, model axis the parameters are
    # split over), set by the engine that adopts the store; None before
    param_residency: tuple[int, int] | None = None

    def note_param_residency(self, per_device_bytes: int, model_axis: int = 1) -> None:
        """Record the engine's parameter residency so ``stats()`` covers the
        whole device-memory picture (the reference's)."""
        self.param_residency = (int(per_device_bytes), int(model_axis))

    def place(self, groups: list[list[int]], m_pad: int) -> np.ndarray:
        """``row_to_group (m_pad,)``: the mediator on each schedule row, -1
        for a dummy row.  Schedule order unless the store places by
        locality."""
        row_to_group = np.full(m_pad, -1, np.int64)
        row_to_group[:len(groups)] = np.arange(len(groups))
        return row_to_group

    def plan(self, idx: np.ndarray, slot: np.ndarray):
        raise NotImplementedError

    @staticmethod
    def slot_data(data, index):
        x_all, y_all, m_all = data
        return x_all[index], y_all[index], m_all[index]

    def serve(self, data, index, homes) -> list[tuple]:
        """Each mediator row's block of the round's slots on its home: the
        slots gathered on the engine's device, each block copied to its row
        (nothing moves for a row on the engine's device)."""
        slots = self.slot_data(data, index)
        step = slots[0].shape[0] // len(homes)
        return [tuple(a[i * step:(i + 1) * step].to(home) for a in slots)
                for i, home in enumerate(homes)]

    def per_device_bytes(self) -> int:
        raise NotImplementedError

    def stats(self) -> dict:
        """Residency and traffic with one key set for every policy (a
        policy without a feature reports 0 or None), the reference's
        ``ClientStore.stats``: ``per_device_param_bytes`` and ``model_axis``
        are the adopting engine's parameter bytes a mesh position holds and
        the model axis they split over (None before an engine adopts the
        store)."""
        ppb, axis = self.param_residency or (None, None)
        return {
            "policy": self.policy,
            "per_device_bytes": self.per_device_bytes(),
            "per_device_param_bytes": ppb,
            "model_axis": axis,
            "exchange": getattr(self, "exchange", None),
            "exchange_bytes_per_round": self.exchange_bytes_per_round,
            "streamed_bytes": getattr(self, "_streamed_bytes", 0),
            "num_streams": getattr(self, "num_streams", 0),
            "prefetch_hits": getattr(self, "prefetch_hits", 0),
            "prefetch_misses": getattr(self, "prefetch_misses", 0),
            "prefetch_depth": getattr(self, "prefetch_depth", 0),
            "cache_hit_rows": getattr(self, "cache_hit_rows", 0),
            "tier_rows": getattr(self, "tier_rows", 0),
            "lru_rows": getattr(self, "lru_rows", 0),
            "lru_evictions": getattr(self, "lru_evictions", 0),
            "spill_dir": getattr(getattr(self, "_src", None), "spill_dir", None),
        }


class ReplicatedStore(ClientStore):
    """The whole packed federation resident on the device."""

    policy = "replicated"

    def __init__(self, xs, ys, mask, device: torch.device):
        self._arrays = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                             for a in (xs, ys, mask))
        self.row_specs = tuple((tuple(a.shape[1:]), np.asarray(a).dtype)
                               for a in (xs, ys, mask))
        self.device = device

    def plan(self, idx, slot):
        return self._arrays, to_device(idx, self.device)

    def per_device_bytes(self) -> int:
        return _bytes(*self._arrays)


class ShardPlan(tuple):
    """One reschedule's sharded plan: the host arrays ``(route, loc, lpos,
    rpos)`` -- the reference's plan tensors, byte for byte -- and, for a
    store with devices, ``dev`` (the slot block's shape and each shard's
    gather list, for ``slot_data``) and ``exchange`` (the device exchange's
    index lists, for ``serve``); None without devices."""
    dev = None
    exchange = None


class ShardedStore(ClientStore):
    """The client axis partitioned over the ``mediator`` axis of ``mesh``.

    ``K`` is padded to a multiple of the shard count ``n`` with zero-mask
    dummy clients; shard ``d`` keeps its ``K_local = K_pad / n`` rows in a
    buffer of its own on ``mesh.devices[d]``.  Mediator row ``r`` of an
    ``(M_pad, gamma)`` schedule reads on shard ``r // (M_pad / n)``, where
    ``place`` (``scheduling.place_mediators``) put it by locality.

    ``plan`` (host numpy, once per reschedule, the reference's arithmetic)
    splits each active slot into a *local* read from its row's shard at
    ``lpos`` or a *remote* read at ``rpos`` of the rows the reference's
    exchange ships to that shard, and fills the send lists ``route``:

    * ``ragged`` (default): per (owner, reader) pair, the clients that
      reader's rows read from that owner, deduplicated per pair, at most
      ``R = min(M_local * gamma, K_local)``; at hop ``s = 1 .. n-1`` of
      ``ring_permutation(n, s)`` shard ``o`` sends its list for reader
      ``(o + s) % n``, which lands at ``(s - 1) * R`` of the reader's
      buffer.  Charged the occupied slots.
    * ``gather``: one globally deduplicated serve list a shard, at most
      ``F = min(M_pad * gamma, K_local)``, sent to every shard (the
      reference's all-gather), landing at ``owner * F``.  Charged
      ``n * F * (n - 1)`` slices, occupied or not.

    The plan and its ``exchange_bytes_per_round`` are what the engine
    charges to the intra-pod ledger.  ``serve`` runs that exchange on the
    devices, where mediator row ``i`` trains on shard ``i``'s device: each
    sender's list (its occupied rows under ``ragged``, its whole padded
    serve buffer under ``gather``) is gathered on its owner and copied into
    the reader's receive buffer (``(n - 1) * R`` or ``n * F`` rows) at the
    plan's offset, hop by hop of the ring; each row block then reads its
    local slots from its own shard at ``lpos`` and its remote ones from its
    receive buffer at ``rpos``.  The bytes copied between positions are
    counted where they move (``last_moved_bytes``, ``moved_bytes``) and
    equal ``exchange_bytes_per_round``.  An inactive slot reads its shard's
    row 0, as the reference's plan says (its mask is zero).
    ``slot_data`` -- every row's slots on the engine's device -- gathers
    each shard's slots on their owner and copies them straight there.
    Copies move exact values, so every placement and both exchanges give
    the replicated store's active slots bit for bit."""

    policy = "sharded"
    permutes_rows = True
    exchange = "gather"         # a plan-only store built without devices

    def __init__(self, xs, ys, mask, mesh, *, device: torch.device,
                 exchange: str = "ragged"):
        if exchange not in EXCHANGES:
            raise ValueError(f"unknown exchange {exchange!r}; expected one of {EXCHANGES}")
        self.exchange = exchange
        arrays = tuple(np.asarray(a) for a in (xs, ys, mask))
        sharding = mediator_sharding(mesh, arrays[0].shape[0])
        self._n, self._k_local = sharding.num_shards, sharding.k_local
        k_pad = self._n * self._k_local
        arrays = tuple(np.concatenate([a, np.zeros((k_pad - a.shape[0],) + a.shape[1:],
                                                   a.dtype)]) for a in arrays)
        self._slice_nbytes = _bytes(*(a[:1] for a in arrays))
        self.row_specs = tuple((tuple(a.shape[1:]), a.dtype) for a in arrays)
        self.device = device
        self._devices = sharding.devices
        self._shards = [tuple(torch.from_numpy(np.ascontiguousarray(a[sharding.rows(d)]))
                              .to(dev) for a in arrays)
                        for d, dev in enumerate(self._devices)]
        self.last_placement_stats: dict | None = None
        self.last_moved_bytes = 0         # the latest serve's exchange bytes
        self.moved_bytes = 0              # every serve's

    def owner(self, cid: int) -> int:
        return cid // self._k_local

    def place(self, groups, m_pad):
        row_to_group, stats = scheduling.place_mediators(
            groups, self._n, m_pad // self._n, self.owner)
        self.last_placement_stats = stats
        return row_to_group

    @staticmethod
    def _group_positions(keys: np.ndarray, num_groups: int) -> np.ndarray:
        """Each element's position within its key's group, in input order
        inside every group."""
        perm = np.argsort(keys, kind="stable")
        counts = np.bincount(keys, minlength=num_groups)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        pos = np.empty(keys.size, np.int64)
        pos[perm] = np.arange(keys.size) - np.repeat(starts, counts)
        return pos

    def plan(self, idx, slot):
        m_pad, gamma = idx.shape
        m_local = max(1, m_pad // self._n)
        # row-major active slots: the first-encounter order the serve lists
        # are filled in
        rr, gg = np.nonzero(slot > 0)
        cids = idx[rr, gg].astype(np.int64)
        owners = cids // self._k_local
        readers = rr // m_local
        remote = owners != readers
        loc = np.ones((m_pad, gamma), bool)       # inactive slots: local row 0
        lpos = np.zeros((m_pad, gamma), np.int32)
        rpos = np.zeros((m_pad, gamma), np.int32)
        lpos[rr[~remote], gg[~remote]] = (cids[~remote] % self._k_local).astype(np.int32)
        loc[rr[remote], gg[remote]] = False
        fill = None
        if self.exchange == "gather":
            route, occupied, capacity = self._plan_gather(
                m_pad, gamma, rr, gg, cids, remote, rpos)
            self.exchange_bytes_per_round = capacity * (self._n - 1) * self._slice_nbytes
        else:
            route, occupied, capacity, fill = self._plan_ragged(
                m_local, gamma, rr, gg, cids, owners, readers, remote, rpos)
            self.exchange_bytes_per_round = occupied * self._slice_nbytes
        if self.last_placement_stats is not None:
            self.last_placement_stats["serve_capacity"] = int(capacity)
            self.last_placement_stats["serve_occupied"] = int(occupied)
            self.last_placement_stats["exchange"] = self.exchange
        plan = ShardPlan((route, loc, lpos, rpos))
        shards = getattr(self, "_shards", None)
        if shards is not None:
            plan.dev = self._gather_lists(idx)
            plan.exchange = self._exchange_lists(route, fill, loc, lpos, rpos)
        return shards, plan

    def _plan_gather(self, m_pad, gamma, rr, gg, cids, remote, rpos):
        """Globally deduplicated serve lists of the all-gather."""
        f = max(1, min(m_pad * gamma, self._k_local))
        serve = np.zeros((self._n, f), np.int32)
        rc = cids[remote]
        occupied = 0
        if rc.size:
            uq, first, inv = np.unique(rc, return_index=True, return_inverse=True)
            enc = np.argsort(first, kind="stable")    # first-encounter order
            u_cid = uq[enc]
            u_own = u_cid // self._k_local
            j = self._group_positions(u_own, self._n)  # per-owner fill order
            serve[u_own, j] = (u_cid % self._k_local).astype(np.int32)
            enc_rank = np.empty(uq.size, np.int64)
            enc_rank[enc] = np.arange(uq.size)
            pos = u_own * f + j                        # rpos = owner * F + fill
            rpos[rr[remote], gg[remote]] = pos[enc_rank[inv]].astype(np.int32)
            occupied = int(uq.size)
        return serve, occupied, self._n * f

    def _plan_ragged(self, m_local, gamma, rr, gg, cids, owners, readers, remote, rpos):
        """Per (owner, reader) send lists of the ring: a client read on two
        reader shards ships to both, and lands in the reader's buffer at
        ``(hop - 1) * R + pair_fill``."""
        n = self._n
        r_cap = max(1, min(m_local * gamma, self._k_local))
        send = np.zeros((n, max(n - 1, 1), r_cap), np.int32)
        fill = np.zeros((n, max(n - 1, 1)), np.int64)    # each send list's length
        rc = cids[remote]
        occupied = 0
        if rc.size:
            k_pad = n * self._k_local
            code = (owners[remote] * n + readers[remote]) * k_pad + rc
            uq, first, inv = np.unique(code, return_index=True, return_inverse=True)
            enc = np.argsort(first, kind="stable")
            u_code = uq[enc]
            u_pair = u_code // k_pad
            u_cid = u_code % k_pad
            u_own = u_pair // n
            u_hop = (u_pair % n - u_own) % n           # reader = owner + hop
            j = self._group_positions(u_pair, n * n)
            if int(j.max(initial=-1)) >= r_cap:         # a pair holds <= R clients
                raise AssertionError("ragged pair capacity overflow")
            send[u_own, u_hop - 1, j] = (u_cid % self._k_local).astype(np.int32)
            np.add.at(fill, (u_own, u_hop - 1), 1)
            enc_rank = np.empty(uq.size, np.int64)
            enc_rank[enc] = np.arange(uq.size)
            pos = (u_hop - 1) * r_cap + j              # reader-local rpos
            rpos[rr[remote], gg[remote]] = pos[enc_rank[inv]].astype(np.int32)
            occupied = int(uq.size)
        return send, occupied, n * max(n - 1, 1) * r_cap, fill

    def _exchange_lists(self, route, fill, loc, lpos, rpos) -> tuple:
        """The device exchange's index lists, once a reschedule: the sends
        ``(owner, reader, rows on the owner's device, receive offset,
        count)`` in ring order (``ragged``: hop by hop, each pair's
        occupied rows; ``gather``: each owner's whole padded serve buffer to
        every other shard), the receive buffers' rows, and each shard's
        reads ``(local rows, remote slot positions, their receive rows)`` on
        its device."""
        n, devs = self._n, self._devices
        sends = []
        if self.exchange == "gather":
            f = route.shape[1]
            for o in range(n):
                rows = to_device(route[o].astype(np.int64), devs[o])
                sends += [(o, (o + s) % n, rows, o * f, f) for s in range(1, n)]
            capacity = n * f
        else:
            r_cap = route.shape[2]
            for s in range(1, n):
                for o, r in ring_permutation(n, s):
                    count = int(fill[o, s - 1])
                    if count:
                        sends.append((o, r, to_device(route[o, s - 1, :count].astype(np.int64),
                                                      devs[o]), (s - 1) * r_cap, count))
            capacity = max(n - 1, 1) * r_cap
        m_local = loc.shape[0] // n
        reads = []
        for i, dev in enumerate(devs):
            block = slice(i * m_local, (i + 1) * m_local)
            at = np.flatnonzero(~loc[block].reshape(-1))
            reads.append((to_device(lpos[block].reshape(-1).astype(np.int64), dev),
                          to_device(at, dev),
                          to_device(rpos[block].reshape(-1)[at].astype(np.int64), dev)))
        return sends, capacity, reads, loc.shape

    def _gather_lists(self, idx: np.ndarray) -> tuple:
        """The slot block's shape and, for each shard that owns a slot, the
        rows it serves (on its device) and their flat slot positions (on
        the engine's device)."""
        flat = idx.reshape(-1).astype(np.int64)
        owners = flat // self._k_local
        lists = []
        for d, dev in enumerate(self._devices):
            at = np.nonzero(owners == d)[0]
            if at.size:
                lists.append((d, to_device(flat[at] % self._k_local, dev),
                              to_device(at, self.device)))
        return idx.shape, lists

    def slot_data(self, data, plan):
        shape, lists = plan.dev
        out = []
        for a, (row_shape, _) in enumerate(self.row_specs):
            block = torch.empty((shape[0] * shape[1],) + row_shape, dtype=data[0][a].dtype,
                                device=self.device)
            for d, rows, at in lists:
                block.index_copy_(0, at, data[d][a].index_select(0, rows).to(self.device))
            out.append(block.reshape(tuple(shape) + row_shape))
        return tuple(out)

    def serve(self, data, plan, homes) -> list[tuple]:
        """Shard ``i``'s row block of slots on its own device, by the
        exchange on the devices (class docstring); rows placed anywhere but
        on the shards' devices take the base class's copies from the
        engine's device."""
        if tuple(homes) != tuple(self._devices):
            return super().serve(data, plan, homes)
        sends, capacity, reads, (m_pad, gamma) = plan.exchange
        recv = [tuple(torch.empty((capacity,) + shape, dtype=data[0][a].dtype, device=dev)
                      for a, (shape, _) in enumerate(self.row_specs))
                for dev in self._devices]
        moved = 0
        for owner, reader, rows, at, count in sends:
            for a in range(len(self.row_specs)):
                recv[reader][a][at:at + count].copy_(data[owner][a].index_select(0, rows))
            moved += count * self._slice_nbytes
        self.last_moved_bytes = moved
        self.moved_bytes += moved
        out = []
        m_local = m_pad // self._n
        for i, (local, at, rpos) in enumerate(reads):
            block = []
            for a, (shape, _) in enumerate(self.row_specs):
                slots = data[i][a].index_select(0, local)
                if at.numel():
                    slots.index_copy_(0, at, recv[i][a].index_select(0, rpos))
                block.append(slots.reshape((m_local, gamma) + tuple(shape)))
            out.append(tuple(block))
        return out

    def per_device_bytes(self) -> int:
        return _bytes(*self._shards[0])


class HostStore(ClientStore):
    """Host-RAM federation; each reschedule's unique clients streamed to
    the device into a fixed ``U_cap``-row compact buffer (the gather index
    remapped into it), so shapes never change with the schedule."""

    policy = "host"

    def __init__(self, xs, ys, mask, device: torch.device, capacity: int, *,
                 source=None):
        self._src = source if source is not None else PackedClients(xs, ys, mask)
        self._cap = max(1, min(self._src.num_clients, capacity))
        self.device = device
        self.row_specs = tuple((tuple(s), np.dtype(d)) for s, d in self._src.row_specs)
        shapes = [((self._cap,) + s, torch.from_numpy(np.zeros(0, d)).dtype)
                  for s, d in self.row_specs]
        self._dev = tuple(torch.zeros(s, dtype=d, device=device) for s, d in shapes)
        on_card = device.type == "cuda"
        # two staging sets, alternated: one may still be copying out while
        # the host fills the other
        self._staging = [tuple(torch.zeros(s, dtype=d, pin_memory=on_card)
                               for s, d in shapes) for _ in range(2)]
        self._copied = [None, None]        # each staging set's last copy event
        self._turn = 0
        self._copy_stream = torch.cuda.Stream(device) if on_card else None
        self._streamed_bytes = 0
        self.num_streams = 0

    def _staged_rows(self, uniq: np.ndarray, out: tuple) -> None:
        """Fill the staging arrays ``out`` (capacity rows) with ``uniq``'s
        rows, zeros past them (the spill tier overrides this with its
        cache/prefetch path)."""
        rows = self._src.rows(uniq) if uniq.size else None
        for i, buf in enumerate(out):
            if rows is not None:
                buf[:uniq.size] = rows[i]
            buf[uniq.size:] = 0

    def plan(self, idx, slot):
        uniq = np.unique(idx[slot > 0])
        if uniq.size > self._cap:
            raise ValueError(f"schedule touches {uniq.size} unique clients; "
                             f"{self.policy} store capacity is {self._cap}")
        # compact remap by binary search over the sorted uniques; inactive
        # slots read row 0 (their mask is zero)
        idx_c = np.where(slot > 0, np.searchsorted(uniq, idx), 0)
        turn = self._turn
        self._turn ^= 1
        if self._copied[turn] is not None:
            self._copied[turn].synchronize()    # its previous copy is done
        staging = self._staging[turn]
        self._staged_rows(uniq, tuple(t.numpy() for t in staging))
        if self._copy_stream is None:
            for dst, src in zip(self._dev, staging):
                dst.copy_(src)
        else:
            compute = torch.cuda.current_stream(self.device)
            # the device buffer may still be read by enqueued rounds
            self._copy_stream.wait_stream(compute)
            with torch.cuda.stream(self._copy_stream):
                for dst, src in zip(self._dev, staging):
                    dst.copy_(src, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._copy_stream)
            compute.wait_event(done)
            self._copied[turn] = done
        moved = _bytes(*self._dev)
        self._streamed_bytes += moved
        self.last_stream_bytes = moved
        self.num_streams += 1
        return self._dev, to_device(idx_c, self.device)

    def per_device_bytes(self) -> int:
        return self._cap * self._src.nbytes_per_client


class _RowLRU:
    """Fixed-capacity per-client-id row cache with LRU eviction.

    Rows live in preallocated host buffers; lookups and inserts are
    vectorized over the resident ids.  Main thread only: the prefetch
    workers never touch the cache (cached rows are copied out before a
    background stage starts), so no lock is needed."""

    def __init__(self, rows: int, specs):
        self.capacity = int(rows)
        n = max(self.capacity, 1)
        self._bufs = tuple(np.zeros((n,) + tuple(shape), dtype)
                           for shape, dtype in specs)
        self._ids = np.full(n, -1, np.int64)      # -1 = empty slot
        self._last_used = np.zeros(n, np.int64)
        self._tick = 0
        self.evictions = 0

    def lookup(self, uniq: np.ndarray, out: tuple) -> np.ndarray:
        """Copy cached rows for ``uniq`` into ``out`` (position-aligned with
        ``uniq``); returns the hit mask.  Hits get their recency bumped."""
        if self.capacity == 0 or uniq.size == 0:
            return np.zeros(uniq.size, bool)
        order = np.argsort(self._ids, kind="stable")
        sorted_ids = self._ids[order]
        pos = np.minimum(np.searchsorted(sorted_ids, uniq), sorted_ids.size - 1)
        hit = sorted_ids[pos] == uniq
        slots = order[pos[hit]]
        where = np.flatnonzero(hit)
        for buf, cbuf in zip(out, self._bufs):
            buf[where] = cbuf[slots]
        self._tick += 1
        self._last_used[slots] = self._tick
        return hit

    def insert(self, ids: np.ndarray, rows: tuple) -> None:
        """Insert rows for ``ids`` (unique), evicting the least recently
        used; ids already resident are skipped (a deep prefetch pipeline
        can stage one client twice -- same bytes)."""
        if self.capacity == 0 or ids.size == 0:
            return
        fresh = np.flatnonzero(~np.isin(ids, self._ids))
        n = min(fresh.size, self.capacity)
        if n == 0:
            return
        fresh = fresh[:n]
        victims = np.argsort(self._last_used, kind="stable")[:n]
        self.evictions += int((self._ids[victims] >= 0).sum())
        self._ids[victims] = ids[fresh]
        self._tick += 1
        self._last_used[victims] = self._tick
        for cbuf, rbuf in zip(self._bufs, rows):
            cbuf[victims] = rbuf[fresh]


class SpilledHostStore(HostStore):
    """Disk/mmap-tier federation with an LRU row cache and pipelined
    prefetch (the reference's ``SpilledHostStore``).

    * **LRU row cache**: ``lru_rows`` client rows (default ``2 * U_cap``)
      kept in host RAM by client id; reused clients are copied from RAM
      instead of re-read from the tier (``stats()["lru_evictions"]``).
    * **Pipelined prefetch**: ``prefetch(ids)`` stages a future
      reschedule's clients into numpy arrays on a daemon thread, up to
      ``prefetch_depth`` stages in flight; the engine fills the queue with
      its pre-drawn selections.  ``plan`` consumes stages in FIFO order:
      it joins the front stage's thread before using its rows (and so
      before the device copy starts), and discards a stage whose ids do
      not match (``prefetch_misses``), reading synchronously through the
      same path instead.
    """

    policy = "spilled"

    def __init__(self, xs, ys, mask, device: torch.device, capacity: int, *,
                 source=None, spill_dir: str | None = None, prefetch_depth: int = 1,
                 lru_rows: int | None = None):
        if prefetch_depth < 1:
            raise ValueError("prefetch_depth must be >= 1")
        if lru_rows is not None and lru_rows < 0:
            raise ValueError("lru_rows must be >= 0")
        if source is None:
            source = MmapClients(xs, ys, mask, spill_dir)
        super().__init__(None, None, None, device, capacity, source=source)
        self.prefetch_depth = int(prefetch_depth)
        self.lru_rows = int(lru_rows) if lru_rows is not None else 2 * self._cap
        self._lru = _RowLRU(self.lru_rows, self.row_specs)
        # FIFO of background stages: (thread, uniq, box, bufs, cached, miss)
        self._prefetched: deque = deque()
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self.cache_hit_rows = 0
        self.tier_rows = 0

    @property
    def lru_evictions(self) -> int:
        return self._lru.evictions

    def _stage(self, uniq: np.ndarray) -> tuple:
        """Allocate a stage's arrays and serve the LRU hits (main thread):
        ``(bufs, cached_rows, miss_positions)``."""
        bufs = tuple(np.zeros((self._cap,) + shape, dtype)
                     for shape, dtype in self.row_specs)
        hit = self._lru.lookup(uniq, bufs)
        return bufs, int(hit.sum()), np.flatnonzero(~hit)

    def _read_tier(self, uniq: np.ndarray, bufs: tuple, miss: np.ndarray) -> None:
        if miss.size:
            for buf, rows in zip(bufs, self._src.rows(uniq[miss])):
                buf[miss] = rows

    def prefetch(self, ids: np.ndarray) -> None:
        """Queue a background stage of a future reschedule's clients."""
        uniq = np.unique(np.asarray(ids))
        if uniq.size > self._cap:
            return                        # plan() will raise; nothing to stage
        bufs, cached, miss = self._stage(uniq)
        box: dict = {}

        def work():
            self._read_tier(uniq, bufs, miss)
            box["done"] = True

        thread = threading.Thread(target=work, daemon=True,
                                  name="astraea-spill-prefetch")
        thread.start()
        self._prefetched.append((thread, uniq, box, bufs, cached, miss))

    def _staged_rows(self, uniq: np.ndarray, out: tuple) -> None:
        staged = None
        while self._prefetched and staged is None:
            thread, pre_uniq, box, bufs, cached, miss = self._prefetched.popleft()
            thread.join()
            if box.get("done") and np.array_equal(pre_uniq, uniq):
                staged = (bufs, cached, miss)
                self.prefetch_hits += 1
                self.telemetry.instant("store_prefetch", hit=True, rows=int(uniq.size))
            else:
                self.prefetch_misses += 1
                self.telemetry.instant("store_prefetch", hit=False, rows=int(uniq.size))
        if staged is None:
            bufs, cached, miss = self._stage(uniq)
            self._read_tier(uniq, bufs, miss)
            staged = (bufs, cached, miss)
        bufs, cached, miss = staged
        self.cache_hit_rows += cached
        self.tier_rows += int(miss.size)
        if miss.size:                     # tier reads feed the LRU
            self._lru.insert(uniq[miss], tuple(b[miss] for b in bufs))
        for dst, src in zip(out, bufs):
            np.copyto(dst, src)


def build_client_store(policy: str, xs=None, ys=None, mask=None, *,
                       device: torch.device, capacity: int | None = None,
                       spill_dir: str | None = None, source=None,
                       prefetch_depth: int = 1,
                       lru_rows: int | None = None, mesh=None,
                       exchange: str = "ragged") -> ClientStore:
    """The packed client store under ``policy`` (module docstring) on
    ``device``; the sharded one keeps its shards on ``mesh``'s devices,
    assembles the round's slots on ``device`` and runs the ``exchange``.
    ``xs/ys/mask`` are the packed host arrays; the streaming policies
    (``host``/``spilled``) take ``source`` instead, a row source that is
    never materialized as one array (the million-client path)."""
    if policy not in POLICIES:
        raise ValueError(f"unknown client-store policy {policy!r}; "
                         f"expected one of {POLICIES}")
    if source is not None and policy not in ("host", "spilled"):
        raise ValueError(f"client-store policy {policy!r} needs the packed "
                         "arrays; streaming row sources require the 'host' "
                         "or 'spilled' policy")
    if policy == "replicated":
        return ReplicatedStore(xs, ys, mask, device)
    if policy == "sharded":
        if mesh is None:
            raise ValueError("the 'sharded' client store needs a mesh with devices")
        return ShardedStore(xs, ys, mask, mesh, device=device, exchange=exchange)
    if capacity is None:
        capacity = source.num_clients if source is not None else xs.shape[0]
    if policy == "host":
        return HostStore(xs, ys, mask, device, capacity, source=source)
    return SpilledHostStore(xs, ys, mask, device, capacity, source=source,
                            spill_dir=spill_dir, prefetch_depth=prefetch_depth,
                            lru_rows=lru_rows)
