"""The port's round engine on the CPU: rows in lockstep (``row_exec="vmap"``)
against rows one by one (``"map"``), the flat Eq. 6 buffer against the
tree form, the imbalance statistics and the adaptive Alg. 2 plan against
the reference (``repro``), the plan refreshed per reschedule against the
reference's mesh-free loop (``torch_parity.reference_astraea``).

Tolerances: ``"vmap"`` against ``"map"`` and the port against the
reference loop, 1e-4 in every parameter after two or three rounds --
batched fp32 sums in another order (vmap's grouped convolutions and
batched products), carried through Adam, the bound the port's slice tests
hold it to against the reference; the statistics 1e-6 (fp32 logs);
everything counted on the host (schedules, plans, ledger) exactly.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import augmentation as jaug                       # noqa: E402
from repro.core import distribution as jdist                      # noqa: E402
from repro.data import federated as jfederated                    # noqa: E402
from repro.models import cnn as jcnn                              # noqa: E402

from repro_torch.convert import params_from_jax                   # noqa: E402
from repro_torch.core import (AstraeaTrainer, EngineConfig, FedAvgTrainer,  # noqa: E402
                              LocalSpec, augmentation, distribution)
from repro_torch.core.draws import SeededDraws                    # noqa: E402
from repro_torch.core.fl import _grads, row_grads                 # noqa: E402
from repro_torch.core.reweighting import (ReweightedFedAvgTrainer,  # noqa: E402
                                          inverse_frequency_weights,
                                          weighted_cross_entropy)
from repro_torch.data.federated import CINIC_LIKE, EMNIST_LIKE, partition, table1  # noqa: E402
from repro_torch.examples import imbalance_motivation                 # noqa: E402
from repro_torch.kernels import ops                               # noqa: E402
from repro_torch.models.cnn import cinic_cnn, emnist_cnn, init_params  # noqa: E402
from repro_torch.optim import adam                                # noqa: E402

from torch_parity import (JaxDraws, max_param_diff, padded_size,  # noqa: E402
                          reference_astraea, reference_params)

TOL = 1e-4


def _federation(cinic: bool):
    if cinic:
        spec = dataclasses.replace(CINIC_LIKE, image_size=16, noise=0.5, distort=0.35)
        make, gd = (lambda: cinic_cnn(10, 16, 3, 8)), "normal"
    else:
        spec = dataclasses.replace(EMNIST_LIKE, num_classes=8, image_size=16)
        make, gd = (lambda: emnist_cnn(8, 16)), "letterfreq"
    fed = partition(spec, num_clients=12, total_samples=300, test_samples=80,
                    sizes="instagram", global_dist=gd, local="random", seed=0)
    return fed, make


class RecordingDraws(SeededDraws):
    """Seeded draws that record every client address asked for."""

    def __init__(self):
        super().__init__(1, "cpu")
        self.asked = []

    def client(self, rnd, row, mediator_epoch, slot):
        self.asked.append((rnd, row, mediator_epoch, slot))
        return super().client(rnd, row, mediator_epoch, slot)


# (arm, trainer, keyword arguments): FedAvg (with and without the online
# plan), Astraea with an empty slot (6 clients in mediators of 4) and a
# dummy row (3 rows for 2 mediators) over two mediator epochs, Astraea at
# the defaults, and the reweighting baseline
ENGINE_CASES = [
    ("emnist", "fedavg", {}),
    ("emnist", "fedavg", {"alpha": 0.67}),
    ("emnist", "astraea", {"clients_per_round": 6, "pad_mediators_to": 3,
                           "mediator_epochs": 2}),
    ("emnist", "reweighted", {}),
    ("cinic", "fedavg", {}),
    ("cinic", "astraea", {}),
]


def _trainer(arm, kind, row_exec, draws, **kw):
    fed, make = _federation(arm == "cinic")
    common = dict(local=LocalSpec(10, 1), seed=0, device="cpu",
                  init_params=init_params(make(), 0), row_exec=row_exec, draws=draws)
    common["clients_per_round"] = kw.pop("clients_per_round", 8)
    cls = {"fedavg": FedAvgTrainer, "reweighted": ReweightedFedAvgTrainer,
           "astraea": AstraeaTrainer}[kind]
    if kind == "astraea":
        common.update(gamma=4, alpha=0.67)
    return cls(make(), adam(1e-3), fed, **common, **kw)


@pytest.mark.parametrize("arm,kind,kw", ENGINE_CASES)
def test_vmap_rows_equal_map_rows(arm, kind, kw):
    """Two rounds: the same schedules, ledger and draw addresses, params
    within ``TOL``; the lockstep program is built once, the loop builds
    none."""
    runs = {}
    for row_exec in ("map", "vmap"):
        tr = _trainer(arm, kind, row_exec, RecordingDraws(), **dict(kw))
        hist = tr.fit(2, eval_every=1)
        runs[row_exec] = (tr, hist)
    (m, hm), (v, hv) = runs["map"], runs["vmap"]
    assert m.engine.last_groups == v.engine.last_groups
    assert m.comm.round_log == v.comm.round_log
    assert sorted(m.draws.asked) == sorted(v.draws.asked)
    assert (m.engine.num_round_traces, v.engine.num_round_traces) == (0, 1)
    err = max(float((m.params[k] - v.params[k]).abs().max()) for k in m.params)
    assert err <= TOL, err
    assert [h["round"] for h in hm] == [h["round"] for h in hv] == [1, 2]


def test_flat_eq6_is_bitwise_the_tree():
    """Rows written into one ``(M, N)`` buffer through the layout's views,
    then ``fedavg_agg_flat``: equal bit for bit to ``fedavg_agg_tree`` over
    the same leaves stacked, a zero-weight row included; the leaves come
    back as views of one ``(N,)`` result."""
    g = torch.Generator().manual_seed(0)
    shapes = {"a.weight": (12, 1, 5, 5), "a.bias": (12,), "b.weight": (150, 96),
              "b.bias": (150,), "out.weight": (7, 150)}
    params = {k: torch.zeros(s) for k, s in shapes.items()}
    layout = ops.FlatLayout(params)
    assert layout.total == sum(int(np.prod(s)) for s in shapes.values())
    m = 5
    buf = torch.zeros(m, layout.total)
    stacked = {k: torch.randn((m,) + s, generator=g) for k, s in shapes.items()}
    for r in range(m):
        for k, v in layout.views(buf[r]).items():
            v.copy_(stacked[k][r])
    for k, v in layout.views(buf).items():          # (M, ...) views of the buffer
        assert torch.equal(v, stacked[k]) and v.data_ptr() >= buf.data_ptr()
    weights = torch.rand(m, generator=g)
    weights[3] = 0.0
    flat = ops.fedavg_agg_flat(buf, weights, layout)
    tree = ops.fedavg_agg_tree(stacked, weights)
    assert list(flat) == list(tree)
    for k in tree:
        assert torch.equal(flat[k], tree[k]), k
    base = flat["a.weight"].data_ptr()
    assert all(v._base is flat["a.weight"]._base for v in flat.values())
    assert flat["a.bias"].data_ptr() == base + 4 * 12 * 25
    with pytest.raises(ValueError):
        ops.fedavg_agg_flat(buf[:, 1:], weights, layout)
    with pytest.raises(ValueError):
        ops.FlatLayout({"x": torch.zeros(3, dtype=torch.float64)})


def test_row_exec_is_validated():
    with pytest.raises(ValueError, match="row_exec"):
        EngineConfig.fedavg(clients_per_round=4, local=LocalSpec(10, 1), row_exec="scan")


def _counts_cases():
    spec = dataclasses.replace(EMNIST_LIKE, num_classes=10, image_size=16)
    feds = table1(spec, num_clients=16, total_samples=1600, test_samples=100)
    cases = [fed.client_counts() for fed in feds.values()]
    rng = np.random.default_rng(0)
    cases.append(rng.integers(0, 300, (64, 47)))
    cases.append(np.vstack([np.zeros((1, 5), np.int64), rng.integers(0, 9, (3, 5))]))
    return cases


def test_imbalance_motivation_twin(monkeypatch, capsys):
    """The example's TABLE I federations are the JAX example's, with the
    same three statistics; one round of each on the CPU prints a row per
    federation and Fig. 1's per-class recall."""
    mine = imbalance_motivation.federations()
    spec = dataclasses.replace(jfederated.EMNIST_LIKE, num_classes=10, image_size=16,
                               noise=0.45, distort=0.35)
    ref = jfederated.table1(spec, num_clients=16, total_samples=1600, test_samples=600)
    assert list(mine) == list(ref)
    for name in ref:
        counts = ref[name].client_counts()
        np.testing.assert_array_equal(mine[name].client_counts(), counts)
        got = distribution.imbalance_summary(counts)
        want = jdist.imbalance_summary(jnp.asarray(counts))
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, atol=1e-6)
    monkeypatch.setattr("sys.argv", ["imbalance_motivation", "--device", "cpu",
                                     "--rounds", "1"])
    imbalance_motivation.main()
    out = capsys.readouterr().out
    assert all(f"\n{name} " in out for name in ref)
    assert "per-class recall on LTRF1" in out and "minority-3 recall" in out


@pytest.mark.parametrize("case", range(7))
def test_imbalance_summary_matches_reference(case):
    """The Table I federations, a 64 x 47 random table and one with an empty
    client: the union histogram exactly, the three statistics within 1e-6
    (fp32 logs)."""
    counts = _counts_cases()[case]
    mine = distribution.imbalance_summary(counts)
    ref = jdist.imbalance_summary(jnp.asarray(counts))
    np.testing.assert_array_equal(distribution.global_histogram(counts).numpy(),
                                  np.asarray(jdist.global_histogram(jnp.asarray(counts)),
                                             np.float32))
    assert set(mine) == set(ref) == {"size_cv", "local_kld_mean", "global_kld"}
    for k in ref:
        np.testing.assert_allclose(float(mine[k]), float(ref[k]), rtol=1e-6, atol=1e-6)


def _phases(plan):
    """The same resolved phase in both packages' ``AugPhase``, per mode."""
    out = []
    for mode, engine_plan in ((None, None), ("online", plan if plan.any() else None),
                              ("materialized", None)):
        fields = (None, None if mode is None else plan, engine_plan, 0.0, 0.0, mode)
        out.append((augmentation.AugPhase(*fields), jaug.AugPhase(*fields)))
    return out


@pytest.mark.parametrize("plan", [np.array([0, 2, 1, 0]), np.zeros(4, np.int64)])
@pytest.mark.parametrize("adaptive", [False, True])
def test_resolve_engine_plan_matches_reference(plan, adaptive):
    """Static: the phase's engine plan (none when all zero); adaptive: the
    whole plan, all-zero included, and ``alpha`` -- or, outside the online
    mode, the reference's ValueError."""
    for mine, ref in _phases(plan):
        if adaptive and ref.mode != "online":
            with pytest.raises(ValueError, match="adaptive_plan"):
                jaug.resolve_engine_plan(ref, adaptive, 0.67)
            with pytest.raises(ValueError, match="adaptive_plan"):
                augmentation.resolve_engine_plan(mine, adaptive, 0.67)
            continue
        got = augmentation.resolve_engine_plan(mine, adaptive, 0.67)
        want = jaug.resolve_engine_plan(ref, adaptive, 0.67)
        assert got[1] == want[1]
        assert (got[0] is None) == (want[0] is None)
        if want[0] is not None:
            np.testing.assert_array_equal(got[0], want[0])


def test_trainers_refuse_adaptive_outside_online():
    fed, make = _federation(False)
    for kw in ({"aug_mode": "materialized"}, {"alpha": None}):
        with pytest.raises(ValueError, match="adaptive_plan"):
            AstraeaTrainer(make(), adam(1e-3), fed, clients_per_round=8, gamma=4,
                           local=LocalSpec(10, 1), adaptive_plan=True, device="cpu", **kw)
    with pytest.raises(ValueError, match="adaptive_plan"):
        FedAvgTrainer(make(), adam(1e-3), fed, clients_per_round=8,
                      local=LocalSpec(10, 1), adaptive_plan=True, device="cpu")


def test_adaptive_hook_installed_on_a_zero_plan():
    """A federation whose union histogram is exactly uniform: the static
    plan is all zero (no engine plan, no resample); adaptive installs it
    anyway, and the first cohort's plan is refreshed and charged to it."""
    spec = dataclasses.replace(EMNIST_LIKE, num_classes=8, image_size=16)
    fed = partition(spec, num_clients=12, total_samples=296, test_samples=80,
                    sizes="instagram", global_dist="letterfreq", local="random", seed=0)
    labels = np.arange(sum(len(y) for y in fed.client_labels)) % 8
    cuts = np.cumsum([len(y) for y in fed.client_labels])[:-1]
    fed = dataclasses.replace(fed, client_labels=np.split(labels.astype(np.int32), cuts))
    kw = dict(clients_per_round=8, local=LocalSpec(10, 1), alpha=0.67, device="cpu",
              seed=0)
    static = FedAvgTrainer(emnist_cnn(8, 16), adam(1e-3), fed, **kw)
    assert not static.augmentation_plan.any() and static.engine._plan is None
    tr = FedAvgTrainer(emnist_cnn(8, 16), adam(1e-3), fed, adaptive_plan=True, **kw)
    assert tr.engine._plan is not None and not tr.engine.last_plan.any()
    tr.run_round()
    sel = np.random.default_rng(0).choice(12, 8, replace=False)
    np.testing.assert_array_equal(tr.engine.last_plan, augmentation.augmentation_plan(
        fed.client_counts()[sel].sum(0), 0.67))
    w = 4 * sum(p.numel() for p in tr.params.values())
    assert tr.comm.round_log == [4 * 8 * 12 + 4 * 8 * 8 + 2 * 8 * w]


ADAPTIVE = dict(NC=8, HW=16, K=12, C=8, GAMMA=4, B=10, E=1, E_M=1, ALPHA=0.67,
                ROUNDS=3, SEED=0)


def test_adaptive_astraea_matches_reference_loop():
    """Adaptive plan with a reschedule every round, three rounds: per
    reschedule the cohort's plan, the mediator groups and the WAN ledger
    equal the reference loop's exactly; params within ``TOL``."""
    a = ADAPTIVE
    spec = dataclasses.replace(EMNIST_LIKE, num_classes=a["NC"], image_size=a["HW"])
    fed = partition(spec, num_clients=a["K"], total_samples=300, test_samples=80,
                    sizes="instagram", global_dist="letterfreq", local="random",
                    seed=a["SEED"])
    params = reference_params(a["NC"], a["HW"], a["SEED"])
    init = params_from_jax(params)
    out = {}
    params, _, comm, _, _ = reference_astraea(
        jcnn.emnist_cnn(a["NC"], a["HW"]), params, fed, clients=a["C"],
        gamma=a["GAMMA"], batch=a["B"], epochs=a["E"], mediator_epochs=a["E_M"],
        alpha=a["ALPHA"], rounds=a["ROUNDS"], seed=a["SEED"], adaptive=True,
        reschedule_every_round=True, out=out)
    # the cohorts differ, and so do their plans
    assert len({tuple(p) for p in out["plans"]}) > 1
    port = AstraeaTrainer(
        emnist_cnn(a["NC"], a["HW"]), adam(1e-3), fed, clients_per_round=a["C"],
        gamma=a["GAMMA"], local=LocalSpec(a["B"], a["E"]), mediator_epochs=a["E_M"],
        alpha=a["ALPHA"], adaptive_plan=True, reschedule_every_round=True,
        seed=a["SEED"], device="cpu", init_params=init,
        draws=JaxDraws(seed=a["SEED"], mode="astraea", m_real=a["C"] // a["GAMMA"],
                       gamma=a["GAMMA"], mediator_epochs=a["E_M"], local_epochs=a["E"],
                       batch=a["B"], model=emnist_cnn(a["NC"], a["HW"]),
                       pad=padded_size(fed, a["B"])))
    plans, groups = [], []
    for _ in range(a["ROUNDS"]):
        port.run_round()
        plans.append(port.engine.last_plan)
        groups.append(port.engine.last_groups)
    assert groups == out["groups"]
    for got, want in zip(plans, out["plans"]):
        np.testing.assert_array_equal(got, want)
    assert port.comm.round_log == comm.round_log
    assert port.engine.num_round_traces == 1
    assert max_param_diff(port.params, params) <= TOL


@pytest.mark.parametrize("cinic", [False, True])
def test_reweighted_loss_runs_under_vmap(cinic):
    """The inverse-frequency loss of the reweighting baseline through
    ``row_grads``: each row's gradient equals per-row autograd within 1e-5
    of its scale (fp32 sums batched in another order), a zero-mask row
    exactly zero."""
    fed, make = _federation(cinic)
    model = make()
    wce = weighted_cross_entropy(torch.from_numpy(
        inverse_frequency_weights(fed.client_counts().sum(0))))

    def loss_fn(model, params, x, y, mask, keep):
        return wce(model.apply(params, x, keep), y, mask)

    g = torch.Generator().manual_seed(3)
    m, b = 3, 10
    p = init_params(model, 0)
    stacked = {k: v.expand((m,) + v.shape).clone() for k, v in p.items()}
    x = torch.rand((m, b) + model.input_shape, generator=g)
    y = torch.randint(0, model.num_classes, (m, b), generator=g)
    mask = torch.ones(m, b)
    mask[2] = 0.0
    keep = [torch.rand((m,) + s, generator=g) >= r for s, r in model.dropout_sites(b)]
    got = row_grads(model, loss_fn)(stacked, x, y, mask, keep)
    for r in range(m):
        want = _grads(model, p, x[r], y[r], mask[r], [k[r] for k in keep], loss_fn)
        for k in want:
            scale = float(want[k].abs().max()) or 1.0
            assert float((got[k][r] - want[k]).abs().max()) <= 1e-5 * scale, (r, k)
    assert all(bool((v[2] == 0).all()) for v in got.values())


@pytest.mark.parametrize("row_exec", ["map", "vmap"])
def test_empty_slot_runs_under_adamw(row_exec):
    """AdamW (wd=0.1) with six clients in mediators of four, so the second
    mediator has two empty slots: every slot runs, as in the reference's
    scan, and each of an empty slot's steps still applies the decoupled
    decay.  Two rounds against the reference loop with the same optimizer:
    groups and ledger exactly, params within ``TOL`` (``"map"`` skipped the
    empty slots before and missed by ~2e-4)."""
    from repro.optim import adamw as jadamw
    from repro_torch.optim import adamw
    a = dict(ADAPTIVE, C=6, ROUNDS=2)
    spec = dataclasses.replace(EMNIST_LIKE, num_classes=a["NC"], image_size=a["HW"])
    fed = partition(spec, num_clients=a["K"], total_samples=300, test_samples=80,
                    sizes="instagram", global_dist="letterfreq", local="random",
                    seed=a["SEED"])
    params = reference_params(a["NC"], a["HW"], a["SEED"])
    init = params_from_jax(params)
    params, groups, comm, _, _ = reference_astraea(
        jcnn.emnist_cnn(a["NC"], a["HW"]), params, fed, clients=a["C"],
        gamma=a["GAMMA"], batch=a["B"], epochs=a["E"], mediator_epochs=a["E_M"],
        alpha=a["ALPHA"], rounds=a["ROUNDS"], seed=a["SEED"],
        opt=jadamw(1e-3, weight_decay=0.1))
    assert sorted(len(g) for g in groups) == [2, 4]
    port = AstraeaTrainer(
        emnist_cnn(a["NC"], a["HW"]), adamw(1e-3, weight_decay=0.1), fed,
        clients_per_round=a["C"], gamma=a["GAMMA"], local=LocalSpec(a["B"], a["E"]),
        mediator_epochs=a["E_M"], alpha=a["ALPHA"], seed=a["SEED"], device="cpu",
        init_params=init, row_exec=row_exec,
        draws=JaxDraws(seed=a["SEED"], mode="astraea", m_real=2, gamma=a["GAMMA"],
                       mediator_epochs=a["E_M"], local_epochs=a["E"], batch=a["B"],
                       model=emnist_cnn(a["NC"], a["HW"]), pad=padded_size(fed, a["B"])))
    port.fit(a["ROUNDS"], eval_every=a["ROUNDS"])
    assert port.engine.last_groups == groups
    assert port.comm.round_log == comm.round_log
    assert max_param_diff(port.params, params) <= TOL
