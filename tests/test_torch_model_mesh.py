"""The 2-D ``(mediator, model)`` mesh in the port's CNN engine, on the CPU
(the port's counterpart of ``tests/test_model_mesh.py``, case by case).

The contract (``core/engine.py``, the reference's §8): the parameters are
split over the ``model`` axis by the rule tables (placements equal to the
reference's ``spec_for``) and replicated over ``mediator``; client data
and schedules partition over ``mediator`` only.  Under the gather oracle
(``tp_rows=False``, the CPU's ``"auto"``) the round gathers the shards
into its weights and splits the result again, moving exact bytes, so on
the reference's tiny federation (12 clients, 8 classes, 16 px, c=6,
gamma=3, ``pad_mediators_to=4``, two rounds with a reschedule each, the
online Alg. 2 plan on) a 2 x 2 mesh of four logical CPU positions gives
the 4 x 1 mesh's parameters bit for bit, and those the 1-D mesh's, for
the replicated, sharded and host stores, sync and async (S=0), under
``"vmap"`` and ``"map"``, with and without LoRA; one round program is
built; the bytes a position holds halve; the WAN ledger does not move and
only the intra-pod ledger grows.

The reference's own engine raises on a multi-device mesh under JAX 0.9.0
(``ShardingTypeError``), so these trajectories are held to the port's 1-D
engine, which ``tests/test_torch_system.py`` and
``tests/test_torch_sharded_store.py`` hold to the reference.
"""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.launch import sharding as RS                                 # noqa: E402
from repro.launch.compat import abstract_mesh                           # noqa: E402
from repro.models import cnn as jcnn                                    # noqa: E402

from repro_torch.core import (AstraeaTrainer, AsyncRoundEngine, AsyncSpec,  # noqa: E402
                              EngineConfig, FedAvgTrainer, FLRoundEngine, LocalSpec,
                              StragglerSpec)
from repro_torch.core.augmentation import augmentation_plan            # noqa: E402
from repro_torch.data.federated import EMNIST_LIKE, partition           # noqa: E402
from repro_torch.launch import mesh as M                                # noqa: E402
from repro_torch.launch import sharding as PS                           # noqa: E402
from repro_torch.models.cnn import cinic_cnn, emnist_cnn, init_params  # noqa: E402
from repro_torch.optim import adam                                      # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def fed():
    spec = dataclasses.replace(EMNIST_LIKE, num_classes=8, image_size=16)
    return partition(spec, num_clients=12, total_samples=600, test_samples=160,
                     sizes="instagram", global_dist="letterfreq", local="random",
                     seed=0, name="tiny-ltrf")


@pytest.fixture(scope="module")
def model():
    return emnist_cnn(8, image_size=16)


@pytest.fixture(scope="module")
def plan(fed):
    return augmentation_plan(fed.client_counts().sum(0), 0.67)


def m22():
    return M.make_fl_mesh(mediator=2, model=2, devices=(CPU,) * 4)


def m41():
    return M.make_fl_mesh(mediator=4, model=1, devices=(CPU,) * 4)


def m1d(n=4):
    return M.make_mediator_mesh(devices=(CPU,) * n)


def _cfg(**kw):
    kw.setdefault("pad_mediators_to", 4)
    return EngineConfig.astraea(clients_per_round=6, gamma=3, local=LocalSpec(10, 1),
                                seed=0, reschedule_every_round=True, **kw)


def _run(model, fed, mesh, plan=None, async_spec=None, rounds=2, **kw):
    e = FLRoundEngine(model, adam(1e-3), fed, _cfg(**kw), mesh=mesh, aug_plan=plan,
                      device="cpu")
    r = e if async_spec is None else AsyncRoundEngine(e, async_spec)
    for _ in range(rounds):
        r.run_round()
    return e


def _same(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# --------------------------------------------------------------------------
# meshes and placements
# --------------------------------------------------------------------------

def test_make_fl_mesh_shapes_and_validation():
    mesh = M.make_fl_mesh(mediator=1, model=1, devices=(CPU,))
    assert mesh.shape == {"mediator": 1, "model": 1}
    assert M.model_axis_size(mesh) == 1
    assert M.model_axis_size(m1d(1)) == 1
    with pytest.raises(ValueError, match="model axis"):
        M.make_fl_mesh(mediator=1, model=0, devices=(CPU,))
    # a model axis the positions cannot host is rejected: no visible card
    # here, and three logical positions for a model axis of two
    with pytest.raises(ValueError, match="divisible"):
        M.make_fl_mesh(model=2)
    with pytest.raises(ValueError, match="divisible"):
        M.make_fl_mesh(model=2, devices=(CPU,) * 3)
    with pytest.raises(ValueError, match="devices"):
        M.make_fl_mesh(mediator=2, model=2, devices=(CPU,) * 2)
    # without devices the positions take visible cards: none here
    with pytest.raises(ValueError, match="visible card"):
        M.make_fl_mesh(mediator=2, model=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.default_fl_mesh(1)
    mesh = m22()
    assert mesh.shape == {"mediator": 2, "model": 2} and mesh.size == 4
    assert M.mediator_devices(mesh) == (CPU, CPU)           # model column 0
    assert M.model_devices(mesh, 1) == (CPU, CPU)
    local = M.process_local_mesh(2, device="cpu")
    assert local.shape == {"mediator": 1, "model": 2} and local.devices == (CPU, CPU)
    assert M.process_local_mesh(1, device="cpu").shape == {"mediator": 1}
    with pytest.raises(ValueError, match="model axis"):
        M.process_local_mesh(0, device="cpu")
    assert M.resolve_fl_mesh(mesh, 3) is mesh and M.resolve_fl_mesh(None, None) is None
    assert not hasattr(M, "_MODEL_AXIS")


def test_cnn_param_specs_mirror_init():
    """Both CNNs' specs cover every parameter, each in the reference's
    layout: the port's shape is the spec's permuted."""
    for m in (emnist_cnn(8, image_size=16), cinic_cnn(8, image_size=16, width=8)):
        params = init_params(m, 0)
        specs = m.param_specs()
        assert sorted(n for sp in specs.values() for n in sp.names) == sorted(params)
        for sp in specs.values():
            (name,) = sp.names
            want = sp.shape if sp.perm is None else tuple(sp.shape[i] for i in sp.perm)
            assert tuple(params[name].shape) == want, name


@pytest.mark.parametrize("make, jmake", [
    (lambda: emnist_cnn(8, image_size=16), lambda: jcnn.emnist_cnn(8, image_size=16)),
    (lambda: emnist_cnn(47, image_size=28), lambda: jcnn.emnist_cnn(47, image_size=28)),
    (lambda: cinic_cnn(8, image_size=16, width=8),
     lambda: jcnn.cinic_cnn(8, image_size=16, width=8)),
])
@pytest.mark.parametrize("t", [2, 4])
def test_rule_tables_shard_wide_dims_over_model_only(make, jmake, t):
    """The placements are the reference's ``spec_for`` on the same 2-D
    mesh: output channels and features over ``model``, never a
    contraction dimension, never ``mediator``; a dimension the axis does
    not divide (47 classes) stays whole.  ``placements`` gives the port
    dimension: 0 for every split conv and dense weight and bias."""
    am = abstract_mesh((2, t), ("mediator", "model"))
    pm = M.AbstractMesh(("mediator", "model"), (2, t))
    jspecs = jmake().param_specs()
    want = {f"{layer}/{leaf}": RS.spec_for(sp.shape, sp.axes, am, RS.model_only_rules())
            for layer, leaves in jspecs.items() for leaf, sp in leaves.items()}
    pspecs = make().param_specs()
    got = {k: PS.spec_for(sp.shape, sp.axes, pm, PS.model_only_rules())
           for k, sp in pspecs.items()}
    assert set(got) == set(want)
    for k in got:
        assert got[k] == tuple(want[k]), k
        assert "mediator" not in got[k]
    dims = PS.placements(pspecs, pm)
    for k, sp in pspecs.items():
        (name,) = sp.names
        assert dims[name] == (0 if "model" in got[k] else None), k
    if "out/w" in got and jspecs["out"]["w"].shape[1] % t:
        assert dims["out.weight"] is None


def test_shard_and_gather_params_exact():
    model = emnist_cnn(47, image_size=28)
    params = init_params(model, 3)
    mesh = m22()
    dims = PS.placements(model.param_specs(), mesh)
    sh = PS.shard_params(params, dims, mesh)
    assert len(sh.positions) == 4
    _same(PS.gather_params(sh, CPU), params)
    for p in range(4):
        for k, v in sh.positions[p].items():
            full = params[k]
            if dims[k] is None:
                assert torch.equal(v, full)
            else:
                assert torch.equal(v, full.chunk(2, dims[k])[p % 2])
            assert v.is_contiguous() and v.untyped_storage().data_ptr() != \
                full.untyped_storage().data_ptr()
    # positions of one column on one device share its tensors
    assert all(sh.positions[0][k] is sh.positions[2][k] for k in params)
    whole = sum(v.nbytes for v in params.values())
    out_bytes = params["out.weight"].nbytes + params["out.bias"].nbytes
    assert sh.position_bytes() == (whole - out_bytes) // 2 + out_bytes


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

def test_engine_2d_one_device_mesh_bitwise_matches_1d(model, fed, plan):
    """A (1, 1) 2-D mesh is the 1-D mediator mesh bit for bit, Alg. 2 on,
    across a reschedule, with one round program (model=1)."""
    e2d = _run(model, fed, M.make_fl_mesh(mediator=1, model=1, devices=(CPU,)), plan,
               pad_mediators_to=2)
    e1d = _run(model, fed, m1d(1), plan, pad_mediators_to=2)
    _same(e2d.params, e1d.params)
    assert e2d.num_round_traces == 1
    st = e2d.store.stats()
    assert st["model_axis"] == 1
    assert st["per_device_param_bytes"] == e1d.store.stats()["per_device_param_bytes"]
    assert e2d.comm.intra_pod_bytes == 0
    assert e2d.comm.total_bytes == e1d.comm.total_bytes


def test_trainer_model_parallel_knob(model, fed):
    """The trainers' ``model_parallel`` builds the default 2-D mesh over
    the visible cards (none here: refused by name); an explicit mesh
    wins over the knob."""
    for make in (lambda **kw: AstraeaTrainer(model, adam(1e-3), fed, clients_per_round=6,
                                             gamma=3, local=LocalSpec(10, 1), alpha=None,
                                             seed=0, device="cpu", **kw),
                 lambda **kw: FedAvgTrainer(model, adam(1e-3), fed, clients_per_round=4,
                                            local=LocalSpec(10, 1), seed=0, device="cpu",
                                            **kw)):
        with pytest.raises(ValueError, match="divisible"):
            make(model_parallel=3)
        tr = make(mesh=m22(), model_parallel=5)
        assert tr.engine.mesh.shape == {"mediator": 2, "model": 2}
        tr.run_round()
        assert tr.engine.num_round_traces == 2         # one program a mediator row
        assert tr.engine.store.stats()["model_axis"] == 2


def test_model_unannotated_falls_back_to_replicated(fed):
    """A model without ``param_specs`` runs on a 2-D mesh with its weights
    whole on every position (no residency win, no crash)."""
    class NoSpecs:
        def __init__(self, m):
            self._m = m

        def __getattr__(self, name):
            if name == "param_specs":
                raise AttributeError(name)
            return getattr(self._m, name)

    e = FLRoundEngine(NoSpecs(emnist_cnn(8, image_size=16)), adam(1e-3), fed,
                      EngineConfig.astraea(clients_per_round=4, gamma=2,
                                           local=LocalSpec(10, 1), seed=0),
                      mesh=m22(), device="cpu")
    e.run_round()
    assert e._dims is None and e._tp_rows is False
    assert e.store.stats()["model_axis"] == 1


@pytest.mark.parametrize("row_exec", ["vmap", "map"])
@pytest.mark.parametrize("store", ["replicated", "sharded", "host"])
def test_2x2_equals_4x1_bitwise(model, fed, plan, store, row_exec):
    """2 x 2 == 4 x 1 bit for bit for every store (Alg. 2 riding along)
    under ``"map"``; under ``"vmap"`` each mediator row is a round program
    of ``M_pad / n`` rows, whose bits follow that width on the CPU (one row
    takes the unbatched convolutions), so the 2 x 2 run is held to the 2 x
    1 run, one program a mediator row on each; two packs; the bytes a
    position holds halve; the WAN ledger is equal and only 2 x 2 charges
    the model axis's gathers on the intra-pod ledger."""
    e22 = _run(model, fed, m22(), plan, store=store, row_exec=row_exec, tp_rows=False)
    mesh = m41() if row_exec == "map" else M.make_fl_mesh(mediator=2, model=1,
                                                          devices=(CPU,) * 2)
    e41 = _run(model, fed, mesh, plan, store=store, row_exec=row_exec)
    _same(e22.params, e41.params)
    assert e22.num_round_traces == e41.num_round_traces == (2 if row_exec == "vmap" else 0)
    assert e22.num_schedule_packs == 2
    s22, s41 = e22.store.stats(), e41.store.stats()
    assert s22["model_axis"] == 2 and s41["model_axis"] == 1
    assert s22["per_device_param_bytes"] * 2 == s41["per_device_param_bytes"]
    for p in e22._shards.positions:
        for k, v in p.items():
            assert v.nbytes * 2 == e41.params[k].nbytes, k
    assert e22.comm.total_bytes == e41.comm.total_bytes
    assert e22.comm.model_axis_tp_bytes > 0 and e41.comm.model_axis_tp_bytes == 0
    rest = e22.comm.intra_pod_bytes - e22.comm.model_axis_tp_bytes
    assert rest == e22.comm.store_stream_bytes + e22.comm.store_exchange_bytes
    if store != "sharded":      # the sharded store's exchange follows its shard count
        assert rest == e41.comm.intra_pod_bytes


@pytest.mark.parametrize("row_exec", ["vmap", "map"])
def test_4x1_equals_1d_and_sharded_store_rows(model, fed, plan, row_exec):
    """4 x 1 is today's 1-D mediator mesh bit for bit; the sharded store's
    client axis partitions over the mediator rows only (2 shards at 2 x
    2, each half the replicated store's bytes)."""
    _same(_run(model, fed, m41(), plan, row_exec=row_exec).params,
          _run(model, fed, m1d(), plan, row_exec=row_exec).params)
    sh = _run(model, fed, m22(), plan, store="sharded", row_exec=row_exec, rounds=1)
    rep = _run(model, fed, m22(), plan, store="replicated", row_exec=row_exec, rounds=1)
    assert len(sh.store._shards) == 2
    assert sh.store.per_device_bytes() * 2 == rep.store.per_device_bytes()


@pytest.mark.parametrize("row_exec", ["vmap", "map"])
def test_async_s0_on_2x2_bitwise_sync(model, fed, plan, row_exec):
    """Async S=0 on the 2 x 2 mesh is its sync run bit for bit, one round
    program, Alg. 2 on; every wave and commit charges a model-axis gather."""
    spec = AsyncSpec(staleness_bound=0, wave_size=1,
                     straggler=StragglerSpec(model="fixed", seed=0))
    a22 = _run(model, fed, m22(), plan, spec, row_exec=row_exec, tp_rows=False)
    e22 = _run(model, fed, m22(), plan, row_exec=row_exec, tp_rows=False)
    _same(a22.params, e22.params)
    assert a22.num_round_traces == (2 if row_exec == "vmap" else 0)
    assert a22.comm.total_bytes == e22.comm.total_bytes
    assert a22.comm.model_axis_tp_bytes > e22.comm.model_axis_tp_bytes > 0


@pytest.mark.parametrize("row_exec", ["vmap", "map"])
def test_lora_gather_oracle_2x2_bitwise_1d(model, fed, row_exec):
    """The gather oracle with LoRA adapters on the 2 x 2 mesh: the backbone
    operand is gathered, the adapters are whole; the adapter state is the
    1-D run's over as many mediator rows bit for bit (under ``"vmap"`` a
    row's program width sets its bits), the WAN ledger adapter-sized and
    equal, the backbone gather charged to the intra-pod ledger."""
    l22 = _run(model, fed, m22(), row_exec=row_exec, tp_rows=False, lora_rank=2)
    l1d = _run(model, fed, m1d(2), row_exec=row_exec, lora_rank=2)
    _same(l22.adapters, l1d.adapters)
    _same(l22.params, l1d.params)
    assert l22.num_round_traces == (2 if row_exec == "vmap" else 0)
    assert l22.comm.total_bytes == l1d.comm.total_bytes
    assert l22.comm.wan_adapter_bytes == l22.comm.total_bytes
    assert l22.comm.intra_pod_bytes > 0 and l1d.comm.intra_pod_bytes == 0


def test_model_axis_round_charge_is_the_references(model, fed):
    """One sync round charges ``msize * t * |w| * (t - 1) / t`` bytes."""
    e = _run(model, fed, m22(), rounds=1, tp_rows=False)
    w = e.comm.model_bytes
    assert e.comm.model_axis_tp_bytes == 4 * w * 1 / 2
    assert np.isclose(e.comm.intra_pod_bytes, e.comm.model_axis_tp_bytes)
