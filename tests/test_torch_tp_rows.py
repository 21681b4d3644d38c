"""TP rows in the port's CNN engine (``EngineConfig.tp_rows``), on the CPU:
the ``model`` axis doing the rows' work (the port's counterpart of
``tests/test_tp_rows.py``, case by case).

The resolution table (``core/engine.py::FLRoundEngine._resolve_tp_rows``):

* ``False``, a mesh without a model axis, or a model whose parameters do
  not split -> the gather oracle (an explicit ``True`` on a ``model=1``
  mesh too: there is nothing to split);
* ``"auto"`` -> TP rows on a CUDA device, the oracle on the CPU;
* ``True`` -> TP rows, on the CPU as well.  This is the port's one stated
  divergence: the reference raises there, for a crash of XLA's CPU
  partitioner under partial-auto ``shard_map`` that the port does not
  have, and running them here lets these tests hold them.

TP rows train the shards (``models/cnn.py::TensorParallel``): no row ever
holds the whole replica, and after two rounds their parameters are the
oracle's within the reference's bound (``rtol=1e-5, atol=1e-6``,
``tests/test_tp_rows.py``), under ``"map"`` and ``"vmap"``, with and
without LoRA adapters (whose backbone stays split: no model-axis charge).
The federation is the reference's tiny one (12 clients, 8 classes, 16 px).
"""
import dataclasses

import pytest
import torch

torch.set_num_threads(1)

from repro_torch.core import (AsyncRoundEngine, AsyncSpec, EngineConfig,  # noqa: E402
                              FLRoundEngine, LocalSpec, StragglerSpec)
from repro_torch.data.federated import EMNIST_LIKE, partition           # noqa: E402
from repro_torch.launch import model_axis                               # noqa: E402
from repro_torch.launch.mesh import make_fl_mesh, make_mediator_mesh    # noqa: E402
from repro_torch.launch.model_axis import shard_key                   # noqa: E402
from repro_torch.models.cnn import TensorParallel, emnist_cnn           # noqa: E402
from repro_torch.optim import adam                                      # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def fed():
    spec = dataclasses.replace(EMNIST_LIKE, num_classes=8, image_size=16)
    return partition(spec, num_clients=12, total_samples=600, test_samples=160,
                     sizes="instagram", global_dist="letterfreq", local="random",
                     seed=0, name="tiny-ltrf")


MODEL = emnist_cnn(8, image_size=16)


def _cfg(**kw):
    kw.setdefault("pad_mediators_to", 2)
    return EngineConfig.astraea(clients_per_round=6, gamma=3, local=LocalSpec(10, 1),
                                seed=0, **kw)


def m22():
    return make_fl_mesh(mediator=2, model=2, devices=(CPU,) * 4)


def _run(fed, mesh, rounds=2, async_spec=None, model=MODEL, **kw):
    e = FLRoundEngine(model, adam(1e-3), fed, _cfg(**kw), mesh=mesh, device="cpu")
    r = e if async_spec is None else AsyncRoundEngine(e, async_spec)
    for _ in range(rounds):
        r.run_round()
    return e


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _close(a, b):
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=1e-5, atol=1e-6, msg=k)


def test_tp_rows_config_validation():
    with pytest.raises(ValueError, match="tp_rows"):
        _cfg(tp_rows="yes")
    for mode in (True, False, "auto"):
        assert _cfg(tp_rows=mode).tp_rows == mode


def test_tp_rows_resolves_off_without_model_axis(fed):
    """``model=1`` meshes have nothing to split: every mode -- even an
    explicit True -- resolves to the oracle, and the (1, 1) 2-D trajectory
    stays the 1-D one bit for bit."""
    def run(mesh, mode):
        e = _run(fed, mesh, tp_rows=mode)
        assert e._tp_rows is False
        return e

    e_true = run(make_fl_mesh(mediator=1, model=1, devices=(CPU,)), True)
    e_auto = run(make_fl_mesh(mediator=1, model=1, devices=(CPU,)), "auto")
    e_1d = run(make_mediator_mesh(devices=(CPU,)), "auto")
    _same(e_true.params, e_auto.params)
    _same(e_auto.params, e_1d.params)
    assert e_auto.num_round_traces == 1


@pytest.mark.parametrize("mode, want", [("auto", False), (False, False), (True, True)])
def test_tp_rows_resolution_table_on_cpu(fed, mode, want):
    """On the 2 x 2 mesh on the CPU: "auto" is the oracle, False the
    oracle, True TP rows (the stated divergence: the reference raises)."""
    e = FLRoundEngine(MODEL, adam(1e-3), fed, _cfg(tp_rows=mode), mesh=m22(), device="cpu")
    assert e._tp_rows is want


def test_auto_oracle_is_bitwise_1d(fed):
    """"auto" resolves to the gather oracle on the CPU: 2 x 2 == 1-D."""
    e22 = _run(fed, m22(), tp_rows="auto")
    e1d = _run(fed, make_mediator_mesh(devices=(CPU,) * 2), tp_rows="auto")
    _same(e22.params, e1d.params)
    assert e22.num_round_traces == 2            # one round program a mediator row


@pytest.mark.parametrize("row_exec", ["map", "vmap"])
@pytest.mark.parametrize("lora_rank", [None, 2])
def test_tp_rows_matches_gather_oracle(fed, row_exec, lora_rank):
    """TP rows reproduce the gather oracle's trajectory within the
    reference's bound after two rounds (not bit for bit: each position's
    convolution covers its channels only, and the input gradients are
    summed over the positions), one round program a mediator row."""
    tp = _run(fed, m22(), tp_rows=True, row_exec=row_exec, lora_rank=lora_rank)
    oracle = _run(fed, m22(), tp_rows=False, row_exec=row_exec, lora_rank=lora_rank)
    assert tp._tp_rows is True and oracle._tp_rows is False
    assert tp.num_round_traces == (2 if row_exec == "vmap" else 0)   # one a mediator row
    _close(tp.params, oracle.params)
    if lora_rank is not None:
        _close(tp.adapters, oracle.adapters)
    assert tp.comm.total_bytes == oracle.comm.total_bytes
    if lora_rank is None:
        assert tp.comm.model_axis_tp_bytes == oracle.comm.model_axis_tp_bytes > 0
    else:       # the backbone stays split, the adapters whole: nothing gathered
        assert tp.comm.intra_pod_bytes == 0 < oracle.comm.intra_pod_bytes


def test_tp_rows_never_hold_the_replica(fed):
    """The rows train shards only: each split leaf's row state is half the
    leaf, a replicated one whole, and the round program's weights are the
    shards'."""
    e = _run(fed, m22(), rounds=1, tp_rows=True)
    state, full = e.row_state(), e.params
    for k, dim in e._dims.items():
        if dim is None:
            assert state[k].shape == full[k].shape
            continue
        assert k not in state
        for j in range(2):
            s = state[shard_key(k, j)]
            assert s.shape[dim] * 2 == full[k].shape[dim]
            assert s is e._shards.column(j)[k]
    assert {k: tuple(v.shape[1:]) for k, v in e._program.p0.items()} == \
        {k: tuple(v.shape) for k, v in state.items()}


@pytest.mark.parametrize("tp_rows, row_exec, gathers", [
    (True, "vmap", 0), (True, "map", 0), (False, "vmap", 1), (False, "map", 1)])
def test_a_round_gathers_the_weights_only_under_the_oracle(fed, monkeypatch, tp_rows,
                                                           row_exec, gathers):
    """A round after the first (whose program is built then) gathers the
    shards whole once under the oracle (its round-start gather) and never
    under TP rows: the fold adds each shard's slice of the aggregate, and
    the span waits on the shards.  The result is the same either way."""
    from repro_torch.launch import sharding
    e = _run(fed, m22(), rounds=1, tp_rows=tp_rows, row_exec=row_exec)
    calls = []
    real = sharding.gather_params
    monkeypatch.setattr(sharding, "gather_params",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    e.run_round()
    assert len(calls) == gathers
    # the four positions on one device share their two columns' tensors
    assert len({id(t) for p in e._shards.positions for t in p.values()}) == 2 * len(e._dims)


def test_tp_rows_async_s0_bitwise_sync(fed):
    """Async S=0 with TP rows is the sync TP run bit for bit; TP waves
    are charged nothing, the commit's fold one gather (the reference's
    rule)."""
    spec = AsyncSpec(staleness_bound=0, wave_size=1,
                     straggler=StragglerSpec(model="fixed", seed=0))
    a = _run(fed, m22(), async_spec=spec, tp_rows=True)
    s = _run(fed, m22(), tp_rows=True)
    _same(a.params, s.params)
    assert a.comm.total_bytes == s.comm.total_bytes
    assert a.comm.model_axis_tp_bytes == s.comm.model_axis_tp_bytes


def test_tensor_parallel_layers_match_plain_apply():
    """One forward and backward through the TP layers against the plain
    apply on the whole weights: logits and every gradient within fp32
    rounding, the shards' gradients the whole gradient's slices."""
    from repro_torch.launch import sharding
    from repro_torch.models.cnn import init_params
    params = init_params(MODEL, 0)
    mesh = make_fl_mesh(mediator=1, model=2, devices=(CPU,) * 2)
    dims = sharding.placements(MODEL.param_specs(), mesh)
    tp = TensorParallel(MODEL, dims, (CPU, CPU), CPU)
    tree = {}
    for k, d in dims.items():
        if d is None:
            tree[k] = params[k]
        else:
            for j, s in enumerate(model_axis.split(params[k], d, (CPU, CPU))):
                tree[shard_key(k, j)] = s
    g = torch.Generator().manual_seed(0)
    x = torch.rand((5, 16, 16, 1), generator=g)
    keep = [torch.rand(shape, generator=g) > rate for shape, rate in MODEL.dropout_sites(5)]
    leaves = {k: v.clone().requires_grad_(True) for k, v in tree.items()}
    whole = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    y_tp, y = tp.apply(leaves, x, keep), MODEL.apply(whole, x, keep)
    torch.testing.assert_close(y_tp, y, rtol=1e-6, atol=1e-6)
    y_tp.square().sum().backward()
    y.square().sum().backward()
    for k, d in dims.items():
        want = whole[k].grad
        got = leaves[k].grad if d is None else torch.cat(
            [leaves[shard_key(k, j)].grad for j in range(2)], d)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6, msg=k)
