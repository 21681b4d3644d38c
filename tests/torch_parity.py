"""Shared helpers of the ``test_torch_*`` parity tests.

``JaxDraws`` replays the reference's ``jax.random`` key tree and hands the
draws to the port as torch tensors, through the port's draw interface
(``repro_torch/core/draws.py``):

* round keys: ``split(fold_in(PRNGKey(seed + 1), round), m_real)[row]``
  (``repro/core/engine.py::_round_keys``);
* Astraea rows: ``split(split(row_key, E_m)[e], gamma)[slot]`` per client
  (``repro/core/mediator.py``); FedAvg rows use the row key itself;
* a client update: ``split(key, E)[e]`` -> ``perm_key, *step_keys``;
  ``permutation(perm_key, pad)``; per step ``split(step_key, n_sites)``
  and ``bernoulli(d_i, 1 - rate_i, shape_i)`` for each dropout site
  (``repro/core/fl.py``, ``repro/models/cnn.py``: two sites at 0.5 in
  ``emnist_cnn``, three at 0.25 / 0.25 / 0.5 in ``cinic_cnn``);
* online augmentation: ``fold_in(row_key, AUG_SALT)``, split over the
  slots for Astraea, then ``k_sel, k_flag, k_warp = split(key, 3)``
  (``repro/core/augmentation.py::online_augment_batch``);
* materialized augmentation: client ``i``'s key ``fold_in(fold_in(
  PRNGKey(seed), 17), i)``, its shuffle seed ``randint(key, (), 0,
  2**31 - 1)`` and its warps ``_affine_params`` of ``split(key,
  next_pow2(n))[:n]`` (``repro/core/augmentation.py::rebalance_client``).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import augmentation as jaug
from repro.core import fl as jfl
from repro.core import scheduling as jsched
from repro.core.comm import CommMeter as JCommMeter
from repro.core.mediator import make_mediator_update
from repro.models import cnn as jcnn
from repro.models import transformer as jtransformer
from repro.models.layers import LogicalParam
from repro.optim import adam as jadam

from repro.core.augmentation import AUG_SALT, _affine_params, _next_pow2, warp_params
from repro_torch.convert import params_to_jax
from repro_torch.models.cnn import cinic_cnn, emnist_cnn, init_params


@functools.partial(jax.jit, static_argnames=("epochs", "n", "bsz", "sites"))
def _client_draws(key, *, epochs, n, bsz, sites):
    """Per-epoch permutations ``(E, n)`` and, per dropout site ``(shape,
    rate)``, the keep-masks of every step ``(E, n // bsz, *shape)``."""
    nb = n // bsz

    def keep_masks(step_key):
        ds = jax.random.split(step_key, len(sites))
        return tuple(jax.random.bernoulli(d, 1.0 - rate, shape)
                     for d, (shape, rate) in zip(ds, sites))

    def one_epoch(ekey):
        perm_key, *step_keys = jax.random.split(ekey, nb + 1)
        perm = jax.random.permutation(perm_key, n)
        return perm, jax.vmap(keep_masks)(jnp.stack(step_keys))

    outs = [one_epoch(k) for k in jax.random.split(key, epochs)]
    perms = jnp.stack([o[0] for o in outs])
    keeps = tuple(jnp.stack([o[1][i] for o in outs]) for i in range(len(sites)))
    return perms, keeps


@functools.partial(jax.jit, static_argnames=("n",))
def aug_draws(key, w, *, n):
    k_sel, k_flag, k_warp = jax.random.split(key, 3)
    logits = jnp.where(w > 0, jnp.log(jnp.maximum(w, 1e-30)), -jnp.inf)
    idx = jax.random.categorical(k_sel, logits, shape=(n,))
    idx = jnp.where(jnp.any(w > 0), idx, 0)
    u = jax.random.uniform(k_flag, (n,))
    mats, trans = warp_params(k_warp, n)
    return idx, u, mats, trans


@functools.partial(jax.jit, static_argnames=("m_real", "e_m", "gamma", "fedavg"))
def _keys(seed, rnd, row, e, slot, *, m_real, e_m, gamma, fedavg):
    """(client key, augmentation key) of one address of the round."""
    base = jax.random.fold_in(jax.random.PRNGKey(seed + 1), rnd)
    row_key = jax.random.split(base, m_real)[row]
    aug_key = jax.random.fold_in(row_key, AUG_SALT)
    if fedavg:
        return row_key, aug_key
    client_key = jax.random.split(jax.random.split(row_key, e_m)[e], gamma)[slot]
    return client_key, jax.random.split(aug_key, gamma)[slot]


def reference_params(num_classes: int, image_size: int, seed: int = 0):
    """He-normal CNN params in the reference's pytree layout (numpy), for
    feeding both packages the same weights without compiling ``init``."""
    return params_to_jax(init_params(emnist_cnn(num_classes, image_size), seed))


def cinic_reference_params(num_classes: int, image_size: int, width: int,
                           seed: int = 0):
    """``cinic_cnn`` params (3 channels) in the reference's layout."""
    return params_to_jax(init_params(cinic_cnn(num_classes, image_size, 3, width),
                                     seed))


def _sites_key(sites):
    return tuple((tuple(shape), float(rate)) for shape, rate in sites)


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


class JaxClientDraws:
    """One client update's permutations and keep-masks, drawn up front."""

    def __init__(self, key, *, epochs: int, batch: int, n: int, sites):
        self.sites = _sites_key(sites)
        perms, keeps = _client_draws(key, epochs=epochs, n=n, bsz=batch,
                                     sites=self.sites)
        self._perms = np.asarray(perms)
        self._keeps = [np.asarray(k) for k in keeps]

    def permutation(self, epoch, n):
        assert n == self._perms.shape[1]
        return _t(self._perms[epoch], np.int64)

    def epoch_keep_masks(self, epoch, steps, sites):
        assert _sites_key(sites) == self.sites and steps == self._keeps[0].shape[1]
        return [_t(k[epoch]) for k in self._keeps]


class JaxDraws:
    """The reference's draws for one trainer run (see module docstring).
    ``mode`` is ``"astraea"`` or ``"fedavg"``; ``m_real`` is the number of
    real mediator rows per round (the split count of the round keys)."""

    def __init__(self, *, seed: int, mode: str, m_real: int, gamma: int,
                 mediator_epochs: int, local_epochs: int, batch: int,
                 model, pad: int):
        self.seed, self.mode, self.m_real, self.gamma = seed, mode, m_real, gamma
        self.mediator_epochs, self.local_epochs = mediator_epochs, local_epochs
        self.batch, self.pad = batch, pad
        self.sites = model.dropout_sites(batch)

    def _keys(self, rnd, row, e, slot):
        return _keys(self.seed, rnd, row, e, slot, m_real=self.m_real,
                     e_m=self.mediator_epochs, gamma=self.gamma,
                     fedavg=self.mode == "fedavg")

    def client(self, rnd, row, mediator_epoch, slot):
        return JaxClientDraws(self._keys(rnd, row, mediator_epoch, slot)[0],
                              epochs=self.local_epochs, batch=self.batch,
                              n=self.pad, sites=self.sites)

    def rebalance(self, client, n):
        return rebalance_draws(self.seed, client, n)

    def augment(self, rnd, row, slot, weights):
        key = self._keys(rnd, row, 0, slot)[1]
        w = jnp.asarray(weights.cpu().numpy(), jnp.float32)
        idx, u, mats, trans = aug_draws(key, w, n=int(w.shape[0]))
        return (_t(idx, np.int64), _t(u, np.float32), _t(mats, np.float32),
                _t(trans, np.float32))


def rebalance_draws(seed: int, client: int, n: int):
    """The reference's materialized Alg. 2 draws of one client (see the
    module docstring): ``(shuffle seed, mats (n, 2, 2), trans (n, 2))``."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), 17), client)
    return rebalance_draws_of_key(key, n)


def rebalance_draws_of_key(key, n: int):
    """``rebalance_client(key, ...)``'s draws for ``n`` augmentations."""
    shuffle_seed = int(jax.random.randint(key, (), 0, 2 ** 31 - 1))
    if n == 0:
        return shuffle_seed, torch.zeros(0, 2, 2), torch.zeros(0, 2)
    keys = jax.random.split(key, _next_pow2(n))[:n]
    mats, trans = jax.vmap(lambda k: _affine_params(
        k, shift=3.0, rot=0.3, shear=0.2, zoom=0.15))(keys)
    return shuffle_seed, _t(mats, np.float32), _t(trans, np.float32)


class JaxRebalanceDraws:
    """Only the materialized draws, for ``resolve_aug_mode``/trainers seeded
    like the reference's ``resolve_aug_mode(..., seed)``."""

    def __init__(self, seed: int):
        self.seed = seed

    def rebalance(self, client, n):
        return rebalance_draws(self.seed, client, n)


def float64_tie_free(counts: np.ndarray, gamma: int, rel: float = 1e-9) -> bool:
    """True when every step of the float64 greedy pass has a unique
    minimum (the runner-up is more than ``rel`` away)."""
    counts = np.asarray(counts, np.float64)
    k, c = counts.shape
    left = list(range(k))
    med = np.zeros(c)
    fill = 0
    while left:
        merged = med[None, :] + counts[left]
        p = merged / np.maximum(merged.sum(-1, keepdims=True), 1e-300)
        with np.errstate(divide="ignore", invalid="ignore"):
            s = np.where(p > 0, p * (np.log(p) + np.log(c)), 0.0).sum(-1)
        order = np.argsort(s, kind="stable")
        if len(left) > 1 and abs(s[order[1]] - s[order[0]]) <= rel * abs(s[order[0]]):
            return False
        pick = left.pop(int(order[0]))
        med = med + counts[pick]
        fill += 1
        if fill == gamma:
            med, fill = np.zeros(c), 0
    return True


# ---------------------------------------------------------------- whole slice
#
# The reference trainers route Eq. 6 through a mesh-sharded ``tensordot``
# that JAX 0.9.0 rejects (``ShardingTypeError`` at ``core/engine.py:245``
# -> ``core/fl.py:95``), so the loops below compose the parts that run
# unsharded: selection through ``np.random.default_rng(seed).choice``,
# ``scheduling.reschedule`` (the jitted batched pass, equal to
# ``impl="loop"``), the round keys of ``engine._round_keys``,
# ``online_augment_batch`` with the map_coordinates warp, jitted
# ``make_mediator_update`` / ``make_client_update``,
# ``fl.weighted_average`` and ``CommMeter``.

@jax.jit
def _stack_average(outs, weights):
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *outs)
    return jfl.weighted_average(stacked, jnp.stack(weights))


@jax.jit
def _fold_deltas(params, deltas, weights):
    return jax.tree.map(lambda p, d: p + d, params, _stack_average(deltas, weights))


def _round_keys(seed, rnd, m_real):
    return jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed + 1), rnd),
                            m_real)


def padded_size(fed, batch: int) -> int:
    n = max(x.shape[0] for x in fed.client_images)
    return -(-n // batch) * batch


def max_param_diff(port_params, tree) -> float:
    back = params_to_jax(port_params)
    return max(float(np.max(np.abs(back[l][k] - np.asarray(tree[l][k]))))
               for l in tree for k in tree[l])


def _reference_eval(jmodel, params, fed, rnd, comm, stats=None) -> dict:
    """The engine's history entry (``repro/core/engine.py::fit``)."""
    m = jfl.evaluate(jmodel, params, fed.test_images, fed.test_labels)
    m.update(round=rnd, traffic_mb=comm.megabytes)
    if stats is not None:
        m["mediator_kld_mean"] = stats["kld_mean"]
    return m


def reference_astraea(jmodel, params, fed, *, clients: int, gamma: int, batch: int,
                      epochs: int, mediator_epochs: int, alpha: float, rounds: int,
                      seed: int, eval_every: int | None = None, adaptive: bool = False,
                      reschedule_every_round: bool = False, out: dict | None = None,
                      opt=None):
    """The reference's Astraea rounds (online Alg. 2, Alg. 3 once or every
    round, Eq. 6 over mediator deltas); ``opt`` is the reference optimizer
    of local training (default ``adam(1e-3)``).  ``adaptive`` recomputes the plan
    from each reschedule's cohort and re-broadcasts it to the cohort
    (``repro/core/engine.py::_pack_schedule``).  Returns ``(params,
    groups, comm, sched_counts, plan)`` of the last reschedule; ``out``,
    if given, receives ``history`` (evaluations every ``eval_every``
    rounds and at the last, the engine's keys), ``plans`` and
    ``groups`` (one per reschedule)."""
    pad = padded_size(fed, batch)
    xs, ys, mask = fed.padded(pad)
    raw = fed.client_counts()
    plan = jaug.augmentation_plan(raw.sum(0), alpha)
    augment = adaptive or plan.any()
    rng = np.random.default_rng(seed)
    med_update = make_mediator_update(jmodel, opt or jadam(1e-3),
                                      jfl.LocalSpec(batch, epochs), mediator_epochs)

    @jax.jit
    def row_program(params, x, y, m, key, jplan):
        # the engine's per-row program: online Alg. 2 per slot, then the
        # mediator update; Eq. 6 weight = expected post-augmentation size
        if not augment:
            return med_update(params, x, y, m, key), m.sum()
        aks = jax.random.split(jax.random.fold_in(key, jaug.AUG_SALT), gamma)
        ax, ay = jax.vmap(lambda k, xx, yy, mm: jaug.online_augment_batch(
            k, xx, yy, mm, jplan, impl="reference"))(aks, x, y, m)
        weight = (m * (1.0 + jplan.astype(jnp.float32)[y])).sum()
        return med_update(params, ax, ay, m, key), weight

    comm = JCommMeter(jcnn.count_params(params))
    if augment:
        comm.plan_broadcast(plan.size, fed.num_clients)
    record = {"history": [], "plans": [], "groups": []}
    for rnd in range(rounds):
        if rnd == 0 or reschedule_every_round:
            sel = rng.choice(fed.num_clients, size=clients, replace=False)
            if adaptive:
                plan = jaug.augmentation_plan(raw[sel].sum(0), alpha)
                comm.plan_broadcast(plan.size, len(sel))
            sched_counts = raw[sel] * (1.0 + plan)
            meds = jsched.reschedule(sched_counts, gamma, impl="batched")
            groups = [[int(sel[i]) for i in m.clients] for m in meds]
            stats = jsched.schedule_stats(meds)
            jplan = jnp.asarray(plan, jnp.int32)
            record["plans"].append(plan)
            record["groups"].append(groups)
        keys = _round_keys(seed, rnd, len(groups))
        deltas, weights = [], []
        for r, g in enumerate(groups):
            idx = np.zeros(gamma, np.int64)
            slot = np.zeros(gamma, np.float32)
            idx[:len(g)], slot[:len(g)] = g, 1.0
            delta, weight = row_program(params, xs[idx], ys[idx],
                                        mask[idx] * slot[:, None], keys[r], jplan)
            deltas.append(delta)
            weights.append(weight)
        params = _fold_deltas(params, deltas, weights)
        comm.astraea_round(clients, gamma, mediator_epochs)
        comm.end_round()
        if eval_every and ((rnd + 1) % eval_every == 0 or rnd + 1 == rounds):
            record["history"].append(_reference_eval(jmodel, params, fed, rnd + 1,
                                                     comm, stats))
    if out is not None:
        out.update(record)
    return params, groups, comm, sched_counts, plan


def reference_fedavg(jmodel, params, fed, *, clients: int, batch: int, epochs: int,
                     rounds: int, seed: int, loss_fn=None, eval_every: int | None = None,
                     out: dict | None = None):
    """The reference's FedAvg rounds (a fresh selection every round, Eq. 6
    over client weights).  Returns ``(params, selections, comm)``; ``out``,
    if given, receives ``history`` (evaluations every ``eval_every`` rounds
    and at the last)."""
    pad = padded_size(fed, batch)
    xs, ys, mask = fed.padded(pad)
    update = jax.jit(jfl.make_client_update(jmodel, jadam(1e-3),
                                            jfl.LocalSpec(batch, epochs),
                                            loss_fn=loss_fn))
    rng = np.random.default_rng(seed)
    comm = JCommMeter(jcnn.count_params(params))
    selections, history = [], []
    for rnd in range(rounds):
        sel = rng.choice(fed.num_clients, size=clients, replace=False)
        selections.append([[int(k)] for k in sel])
        keys = _round_keys(seed, rnd, clients)
        outs = [update(params, xs[k], ys[k], mask[k], keys[r])
                for r, k in enumerate(sel)]
        params = _stack_average(outs, [jnp.float32(mask[k].sum()) for k in sel])
        comm.fedavg_round(clients)
        comm.end_round()
        if eval_every and ((rnd + 1) % eval_every == 0 or rnd + 1 == rounds):
            history.append(_reference_eval(jmodel, params, fed, rnd + 1, comm))
    if out is not None:
        out["history"] = history
    return params, selections, comm


def reference_async(jmodel, params, fed, *, kind: str, clients: int, batch: int,
                    epochs: int, rounds: int, seed: int, staleness_bound: int = 0,
                    wave_size: int = 0, straggler=None, policy: str = "polynomial",
                    policy_alpha: float = 0.5, adaptive=None, gamma: int = 1,
                    mediator_epochs: int = 1, alpha: float | None = None):
    """The reference's bounded-staleness async rounds
    (``repro/core/async_engine.py``) as a mesh-free loop over the
    reference's own parts: ``staleness.StragglerModel`` /
    ``make_staleness_policy`` / ``AdaptiveStaleness``,
    ``scheduling.partition_waves``, ``CommMeter``'s wave charges and the
    update closures of ``reference_astraea`` (``kind="astraea"``, Alg. 3
    once, online Alg. 2 with ``alpha``) and ``reference_fedavg``
    (``kind="fedavg"``, a fresh selection every round, no plan).  Every
    wave of a round trains from the round's snapshot; one commit per round
    folds the waves landed by then, a wave of round ``q`` at commit ``r``
    with its Eq. 6 weights times ``float32(lambda(r - q))`` where that is
    positive; the last round flushes.  ``straggler`` and ``adaptive`` are
    the reference's ``StragglerSpec`` / ``AdaptiveStalenessSpec``.  Returns
    ``(params, comm, commit_log)``, each log entry the round and the
    staleness of every folded row."""
    from repro.core.staleness import (AdaptiveStaleness, StragglerModel,
                                      StragglerSpec, make_staleness_policy)
    pad = padded_size(fed, batch)
    xs, ys, mask = fed.padded(pad)
    raw = fed.client_counts()
    lam = make_staleness_policy(policy, policy_alpha)
    ctrl = AdaptiveStaleness(adaptive) if adaptive is not None else None
    comm = JCommMeter(jcnn.count_params(params))
    if kind == "astraea":
        plan = jaug.augmentation_plan(raw.sum(0), alpha)
        jplan = jnp.asarray(plan, jnp.int32)
        comm.plan_broadcast(plan.size, fed.num_clients)
        med_update = make_mediator_update(jmodel, jadam(1e-3),
                                          jfl.LocalSpec(batch, epochs), mediator_epochs)

        @jax.jit
        def row_program(p, x, y, m, key):
            aks = jax.random.split(jax.random.fold_in(key, jaug.AUG_SALT), gamma)
            ax, ay = jax.vmap(lambda k, xx, yy, mm: jaug.online_augment_batch(
                k, xx, yy, mm, jplan, impl="reference"))(aks, x, y, m)
            weight = (m * (1.0 + jplan.astype(jnp.float32)[y])).sum()
            return med_update(p, ax, ay, m, key), weight

        fold = _fold_deltas
    else:
        update = jax.jit(jfl.make_client_update(jmodel, jadam(1e-3),
                                                jfl.LocalSpec(batch, epochs)))
        fold = lambda p, outs, wts: _stack_average(outs, wts)   # noqa: E731
    rng = np.random.default_rng(seed)
    straggler_model, pending, log = None, [], []
    vtime = 0.0

    def commit(ready, r):
        outs, wts, stales = [], [], []
        for q in sorted({p["round"] for p in ready}):
            ws = [p for p in ready if p["round"] == q]
            rows = np.concatenate([p["rows"] for p in ws])
            order = np.argsort(rows, kind="stable")
            vals = [v for p in ws for v in p["vals"]]
            w = [x for p in ws for x in p["wts"]]
            s = r - q
            for i in order:
                wt = jnp.float32(w[i])
                outs.append(vals[i])
                wts.append(wt * jnp.float32(lam(s)) if s > 0 else wt)
            stales.extend([s] * rows.size)
        log.append({"round": r, "staleness": stales})
        return fold(params, outs, wts)

    for rnd in range(rounds):
        if kind == "fedavg" or rnd == 0:
            sel = rng.choice(fed.num_clients, size=clients, replace=False)
            if kind == "astraea":
                meds = jsched.reschedule(raw[sel] * (1.0 + plan), gamma, impl="batched")
                groups = [[int(sel[i]) for i in m.clients] for m in meds]
            else:
                groups = [[int(k)] for k in sel]
        keys = _round_keys(seed, rnd, len(groups))
        outs, weights = [], []
        for r, g in enumerate(groups):
            if kind == "astraea":
                idx = np.zeros(gamma, np.int64)
                slot = np.zeros(gamma, np.float32)
                idx[:len(g)], slot[:len(g)] = g, 1.0
                out, weight = row_program(params, xs[idx], ys[idx],
                                          mask[idx] * slot[:, None], keys[r])
            else:
                out = update(params, xs[g[0]], ys[g[0]], mask[g[0]], keys[r])
                weight = mask[g[0]].sum()
            outs.append(out)
            weights.append(weight)
        if straggler_model is None:
            straggler_model = StragglerModel(straggler or StragglerSpec(), len(groups))
        work = np.array([len(g) for g in groups], np.float64) * max(1, mediator_epochs)
        waves, wst = jsched.partition_waves(straggler_model.durations(work), wave_size)
        t0 = vtime
        for wi, wave in enumerate(waves):
            rows = np.sort(np.asarray(wave, np.int64))
            n_clients = sum(len(groups[i]) for i in rows)
            if kind == "astraea":
                comm.astraea_wave(n_clients, len(rows), mediator_epochs)
            else:
                comm.fedavg_wave(n_clients)
            pending.append({"round": rnd, "t_done": t0 + wst["wave_times"][wi],
                            "rows": rows, "vals": [outs[i] for i in rows],
                            "wts": [weights[i] for i in rows]})
        comm.end_round()
        bound = ctrl.bound if ctrl is not None else staleness_bound
        due = [p["t_done"] for p in pending if p["round"] <= rnd - bound]
        c_time = max(due + [t0 + wst["wave_times"][0]])
        ready = [p for p in pending if p["t_done"] <= c_time]
        pending = [p for p in pending if p["t_done"] > c_time]
        if ctrl is not None:
            for p in ready:
                ctrl.observe(rnd - p["round"])
            for p in pending:
                ctrl.observe(rnd - p["round"] + 1)
        params = commit(ready, rnd)
        vtime = c_time
    if pending:
        params = commit(pending, rounds)
    return params, comm, log


def reference_lora(jmodel, params, fed, *, kind: str, clients: int, batch: int,
                   epochs: int, rounds: int, seed: int, rank: int, opt,
                   gamma: int = 1, mediator_epochs: int = 1,
                   alpha: float | None = None, out: dict | None = None):
    """The reference engine's LoRA adapter exchange (``repro/core/engine.py``
    with ``lora_rank``, no Alg. 2 plan) as a mesh-free loop: the mapping
    of ``repro.models.lora.build_mapping(jmodel.param_specs(), rank,
    alpha)``, the frozen A of ``init_adapter_A(fold_in(PRNGKey(seed),
    A_SALT))`` and the round-0 state of ``init_adapter_state``; the
    reference's ``make_mediator_update`` (``kind="astraea"``, Alg. 3 once)
    or ``make_client_update`` (``kind="fedavg"``, a fresh selection every
    round) train the state through a model whose ``apply`` merges it into
    the backbone (``merge_params``, as the engine's ``dc_replace``); Eq. 6
    over the rows, folded as the engine's ``_fold`` (``state + agg`` or
    ``agg``); ``CommMeter`` with the adapter payload.  Returns ``(state,
    a_tree, mapping, comm, merged)``, ``merged`` the final merged
    weights; ``out``, if given, receives ``states``, the state before
    round 0 and after each round."""
    import dataclasses

    from repro.models import lora as jlora
    mapping = jlora.build_mapping(jmodel.param_specs(), rank, alpha)
    a_tree = jlora.init_adapter_A(
        jax.random.fold_in(jax.random.PRNGKey(seed), jlora.A_SALT), mapping)
    backbone = jax.tree.map(jnp.asarray, params)
    state = jlora.init_adapter_state(mapping, backbone)
    merged_model = dataclasses.replace(jmodel, apply=lambda tp, x, **kw: jmodel.apply(
        jlora.merge_params(backbone, a_tree, tp, mapping), x, **kw))
    local = jfl.LocalSpec(batch, epochs)
    if kind == "astraea":
        update = jax.jit(make_mediator_update(merged_model, opt, local, mediator_epochs))
    else:
        update = jax.jit(jfl.make_client_update(merged_model, opt, local))
    pad = padded_size(fed, batch)
    xs, ys, mask = fed.padded(pad)
    raw = fed.client_counts()
    rng = np.random.default_rng(seed)
    comm = JCommMeter(jcnn.count_params(params))
    comm.adapter_payload_bytes = jlora.exchange_nbytes(mapping, comm.bytes_per_param)
    states = [state]
    for rnd in range(rounds):
        if kind == "fedavg" or rnd == 0:
            sel = rng.choice(fed.num_clients, size=clients, replace=False)
            if kind == "astraea":
                meds = jsched.reschedule(raw[sel].astype(np.float64), gamma, impl="batched")
                groups = [[int(sel[i]) for i in m.clients] for m in meds]
            else:
                groups = [[int(k)] for k in sel]
        keys = _round_keys(seed, rnd, len(groups))
        outs, weights = [], []
        for r, g in enumerate(groups):
            if kind == "astraea":
                idx = np.zeros(gamma, np.int64)
                slot = np.zeros(gamma, np.float32)
                idx[:len(g)], slot[:len(g)] = g, 1.0
                m = mask[idx] * slot[:, None]
                outs.append(update(state, xs[idx], ys[idx], m, keys[r]))
            else:
                m = mask[g[0]]
                outs.append(update(state, xs[g[0]], ys[g[0]], m, keys[r]))
            weights.append(jnp.float32(m.sum()))
        if not state:
            pass                            # rank 0: nothing to average
        elif kind == "astraea":
            state = _fold_deltas(state, outs, weights)
        else:
            state = _stack_average(outs, weights)
        if kind == "astraea":
            comm.astraea_round(clients, gamma, mediator_epochs)
        else:
            comm.fedavg_round(clients)
        comm.end_round()
        states.append(state)
    if out is not None:
        out["states"] = states
    merged = jlora.merge_params(backbone, a_tree, state, mapping)
    return state, a_tree, mapping, comm, merged


def adapter_tree_to_jax(tree: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Inverse of ``repro_torch.convert.adapter_tree_from_jax``: the port's
    flat ``{path: tensor}`` LoRA tree as the reference's numpy leaves;
    bfloat16 tensors come back as float32 arrays of the same values."""
    out = {}
    for path, t in tree.items():
        t = t.detach().cpu()
        out[path] = (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()
    return out


# the norm scales ``rand_params`` draws around 1 under LayerNorm
NORM_SCALES = {"norm1", "norm2", "norm_x", "final_norm", "enc_final_norm"}


def rand_params(rcfg, seed, max_seq=4096):
    """The reference's param tree with every leaf drawn from numpy: matrices
    at ``1/sqrt(d_in)``, embeddings and learned positions at their spec's
    scale, norm scales ``N(1, 0.1)`` under LayerNorm and ``N(0, 0.1)``
    under RMS norm (which multiplies by ``1 + scale``), biases ``N(0,
    0.1)``."""
    rng = np.random.default_rng(seed)

    def draw(path, spec):
        name = str(getattr(path[-1], "key", path[-1]))
        if name in NORM_SCALES:
            a = rng.normal(size=spec.shape) * 0.1 + (1.0 if rcfg.norm == "ln" else 0.0)
        elif spec.scale == 0.0:                       # biases
            a = rng.normal(size=spec.shape) * 0.1
        elif spec.scale is not None:
            a = rng.normal(size=spec.shape) * spec.scale
        else:
            a = rng.normal(size=spec.shape) / np.sqrt(spec.shape[-2])
        return a.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, jtransformer.param_specs(rcfg, max_seq),
                                            is_leaf=lambda x: isinstance(x, LogicalParam))
