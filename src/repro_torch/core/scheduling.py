"""Algorithm 3 -- mediator based multi-client rescheduling.

A mediator repeatedly absorbs the unassigned client whose label histogram
brings its merged distribution closest to uniform (min
``D_KL(P_m + P_k || P_u)``) until it holds ``gamma`` clients; then a fresh
mediator opens, until no client is left.

Two implementations, one tie-break (the first minimum, i.e. the lowest
client id among equal scores):

* ``impl="batched"`` -- the whole pass in one call to
  ``kernels.ops.kld_greedy_picks``: the cluster CUDA kernel for a CUDA
  device, its plain PyTorch masked-argmin loop on the CPU.
* ``impl="loop"`` -- the paper's per-step Alg. 3: a Python loop with a
  numpy argmin on the host that scores each step with one
  ``kernels.ops.kld_score`` call on the unassigned rows (the CUDA kernel
  on a CUDA device, ``distribution.merged_kld_scores`` on the CPU, where
  it is the oracle).  The kernel scores with the greedy pass's device
  function, so on integer histograms both forms give the same picks.

Scores are f32 over integer counts.  Clients whose histograms are
permutations of each other tie in real arithmetic but may round apart in
f32, differently on different devices and libraries; ``first_divergence``
tells such float ties from real disagreements.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import distribution as dist
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

IMPLS = ("batched", "loop")


@dataclass
class Mediator:
    """One mediator's schedule: ordered client ids + merged label counts."""
    clients: list[int] = field(default_factory=list)
    counts: np.ndarray | None = None

    def kld_to_uniform(self) -> float:
        return float(dist.kld_to_uniform(torch.as_tensor(self.counts,
                                                         dtype=torch.float32)))


def _groups(client_counts: np.ndarray, picks: np.ndarray, gamma: int
            ) -> list[Mediator]:
    return [Mediator(clients=[int(c) for c in picks[s:s + gamma]],
                     counts=client_counts[picks[s:s + gamma]].sum(0))
            for s in range(0, picks.shape[0], gamma)]


def reschedule(client_counts: np.ndarray, gamma: int, *, impl: str = "batched",
               device: str | torch.device | None = None) -> list[Mediator]:
    """Alg. 3: partition clients into mediators of size <= gamma.

    ``client_counts (K, C)`` are the clients' label histograms.  ``device``
    is where the scores are computed (the card unless ``"cpu"``): the
    batched pass runs there whole; the loop keeps its argmin on the host,
    moves the counts to ``device`` once and launches one ``kld_score`` per
    absorbed client there.  Every client appears in exactly one
    mediator."""
    if impl not in IMPLS:
        raise ValueError(f"unknown reschedule impl {impl!r}; expected one of {IMPLS}")
    client_counts = np.asarray(client_counts, np.float64)
    num_clients, num_classes = client_counts.shape
    if num_clients == 0:
        return []
    dev = resolve_device(device)
    counts = torch.as_tensor(client_counts, dtype=torch.float32, device=dev)
    if impl == "batched":
        picks = ops.kld_greedy_picks(counts, int(gamma)).cpu().numpy()
        return _groups(client_counts, picks.astype(np.int64), gamma)
    unassigned = list(range(num_clients))
    mediators: list[Mediator] = []
    while unassigned:
        med = Mediator(counts=np.zeros(num_classes))
        while unassigned and len(med.clients) < gamma:
            rows = torch.as_tensor(unassigned, dtype=torch.int64, device=dev)
            scores = ops.kld_score(
                torch.as_tensor(med.counts, dtype=torch.float32, device=dev),
                counts[rows]).cpu().numpy()
            cid = unassigned.pop(int(np.argmin(scores)))
            med.clients.append(cid)
            med.counts = med.counts + client_counts[cid]
        mediators.append(med)
    return mediators


def mediator_client_scores(mediators: list[Mediator], client_counts: np.ndarray,
                           device: str | torch.device | None = None) -> np.ndarray:
    """The Alg. 3 score of every (mediator, client) pair, ``(M, K)``: how
    far each client would move each mediator's merged histogram from
    uniform.  A diagnostic sweep (placement, rebalancing what-ifs) in one
    ``kernels.ops.kld_score_matrix`` call on ``device``."""
    dev = resolve_device(device)
    meds = np.stack([np.asarray(m.counts, np.float64) for m in mediators]) \
        if mediators else np.zeros((0, np.shape(client_counts)[1]))
    out = ops.kld_score_matrix(
        torch.as_tensor(meds, dtype=torch.float32, device=dev),
        torch.as_tensor(np.asarray(client_counts, np.float64), dtype=torch.float32,
                        device=dev))
    return out.cpu().numpy()


def picks_of(mediators: list[Mediator]) -> np.ndarray:
    """The absorption order behind a schedule."""
    return np.asarray([c for m in mediators for c in m.clients], np.int64)


def _scores_f64(med: np.ndarray, counts: np.ndarray) -> np.ndarray:
    merged = med[None, :] + counts
    p = merged / np.maximum(merged.sum(-1, keepdims=True), 1e-300)
    c = counts.shape[1]
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(p > 0, p * (np.log(p) + np.log(c)), 0.0)
    return terms.sum(-1)


def first_divergence(client_counts: np.ndarray, gamma: int, picks_a,
                     picks_b) -> dict | None:
    """Compare two absorption orders of the same greedy pass.

    Returns ``None`` if they are equal; otherwise the first step where they
    differ, the two candidates there, their float64 scores against the
    shared mediator state, and ``tie`` -- whether those scores agree to
    1e-9 relative (a float tie, where either pick is correct)."""
    counts = np.asarray(client_counts, np.float64)
    a, b = np.asarray(picks_a, np.int64), np.asarray(picks_b, np.int64)
    if a.shape != b.shape:
        raise ValueError(f"pick lists differ in length: {a.shape} vs {b.shape}")
    diff = np.flatnonzero(a != b)
    if diff.size == 0:
        return None
    step = int(diff[0])
    open_from = step - step % gamma
    med = counts[a[open_from:step]].sum(0) if step > open_from \
        else np.zeros(counts.shape[1])
    sa, sb = _scores_f64(med, counts[[a[step], b[step]]])
    tie = bool(abs(sa - sb) <= 1e-9 * max(abs(sa), abs(sb), 1e-300))
    return {"step": step, "a": int(a[step]), "b": int(b[step]),
            "score_a": float(sa), "score_b": float(sb), "tie": tie}


def random_schedule(num_clients: int, gamma: int, client_counts: np.ndarray,
                    seed: int = 0) -> list[Mediator]:
    """Control: arbitrary grouping (what plain FedAvg round batching does)."""
    client_counts = np.asarray(client_counts, np.float64)
    order = np.random.default_rng(seed).permutation(num_clients)
    return [Mediator(clients=[int(i) for i in order[s:s + gamma]],
                     counts=client_counts[order[s:s + gamma]].sum(0))
            for s in range(0, num_clients, gamma)]


def partition_waves(durations: np.ndarray, wave_size: int
                    ) -> tuple[list[list[int]], dict]:
    """Straggler-aware wave placement for the async round engine.

    Sorts mediators by simulated duration (stable, so ties keep schedule
    order) and chunks them into waves of ``wave_size`` -- co-scheduling
    slow mediators into the *late* waves so the fast waves are never
    blocked behind a straggler. A wave completes when its slowest member
    does, so sorted chunking minimizes the sum of wave completion times
    over all contiguous partitions of a fixed wave size.

    This composes with *client*-level heterogeneity without any code
    here changing: a ``StragglerSpec(level="client")`` model derives
    each mediator's duration as the sum of its members' factors
    (``StragglerModel.durations_for_groups``), so a slow *device* drags
    whichever mediator Alg. 3 packed it into toward the late waves --
    speed-aware wave placement stacks on top of KLD-greedy packing
    rather than perturbing it. With all clients at unit speed the
    durations tie everywhere and the stable sort reproduces the
    historical mediator-only ordering bitwise.

    Args:
      durations: ``(M,)`` simulated per-mediator training times
        (schedule order; see ``core/staleness.py``).
      wave_size: mediators per wave; ``<= 0`` means one wave holding the
        whole fleet (the synchronous barrier, degenerate case).

    Returns:
      ``(waves, stats)``: ``waves`` is a list of schedule-index lists in
      completion order (fastest wave first); ``stats`` reports per-wave
      completion times, the synchronous barrier time (max duration), and
      ``blocked_time_saved`` -- the reduction in summed wave completion
      times vs chunking in arbitrary (schedule) order, i.e. what
      co-scheduling the stragglers bought.
    """
    durations = np.asarray(durations, np.float64)
    m = int(durations.shape[0])
    if m == 0:
        raise ValueError("cannot partition zero mediators into waves")
    ws = wave_size if wave_size and wave_size > 0 else m
    order = np.argsort(durations, kind="stable")
    waves = [[int(i) for i in order[s:s + ws]] for s in range(0, m, ws)]
    wave_times = [float(durations[w].max()) for w in waves]
    naive_times = [float(durations[s:s + ws].max()) for s in range(0, m, ws)]
    stats = {
        "num_waves": len(waves),
        "wave_times": wave_times,
        "barrier_time": float(durations.max()),
        "blocked_time_saved": float(sum(naive_times) - sum(wave_times)),
    }
    return waves, stats


def place_mediators(groups: list[list[int]], num_shards: int,
                    rows_per_shard: int, owner) -> tuple[np.ndarray, dict]:
    """Locality-aware placement of mediators onto the rows of a sharded
    client store (``core/client_store.py::ShardedStore``).

    A mediator's gather is free for the clients its own shard holds and
    costs an exchange slot for every other one.  Each mediator goes to the
    shard owning most of its clients, at most ``rows_per_shard`` to a
    shard, greedily in descending *regret* (best shard's count minus the
    runner-up's), so the mediators with the most to lose pick first.  Ties
    go to the lower mediator index, then the lower shard index.

    ``groups`` are the mediators' client ids in schedule order; ``owner``
    maps a client id to its shard.  Returns ``(row_to_group, stats)``:
    ``row_to_group (num_shards * rows_per_shard,)`` gives the mediator on
    each row (-1 a dummy row; rows ``[d * rows_per_shard, (d + 1) *
    rows_per_shard)`` belong to shard ``d``, in mediator order), and
    ``stats`` counts the local and cross-shard client fetches."""
    m = len(groups)
    m_pad = num_shards * rows_per_shard
    if m > m_pad:
        raise ValueError(f"{m} mediators do not fit {num_shards}x"
                         f"{rows_per_shard} shard rows")
    counts = np.zeros((m, num_shards), np.int64)
    for g, clients in enumerate(groups):
        for cid in clients:
            counts[g, owner(cid)] += 1

    def regret(g: int) -> int:
        row = np.sort(counts[g])
        return int(row[-1] - (row[-2] if num_shards > 1 else 0))

    capacity = [rows_per_shard] * num_shards
    shard_of = np.zeros(m, np.int64)
    local = 0
    for g in sorted(range(m), key=lambda g: -regret(g)):
        prefs = np.argsort(-counts[g], kind="stable")
        s = next(int(s) for s in prefs if capacity[s] > 0)
        capacity[s] -= 1
        shard_of[g] = s
        local += int(counts[g, s])
    row_to_group = np.full(m_pad, -1, np.int64)
    next_row = [d * rows_per_shard for d in range(num_shards)]
    for g in range(m):
        d = int(shard_of[g])
        row_to_group[next_row[d]] = g
        next_row[d] += 1
    total = int(sum(len(c) for c in groups))
    stats = {"local_fetches": local, "remote_fetches": total - local,
             "total_fetches": total, "num_shards": num_shards}
    return row_to_group, stats


def schedule_stats(mediators: list[Mediator]) -> dict[str, float]:
    """Fig. 7 metrics: distribution of D_KL(P_m || P_u) over mediators."""
    klds = np.array([m.kld_to_uniform() for m in mediators])
    return {
        "kld_mean": float(klds.mean()),
        "kld_median": float(np.median(klds)),
        "kld_max": float(klds.max()),
        "kld_min": float(klds.min()),
        "num_mediators": len(mediators),
    }
