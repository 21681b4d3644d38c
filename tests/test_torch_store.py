"""The port's client stores on the CPU (``core/client_store.py``).

Replicated, host and spilled stores give bit-for-bit equal trajectories
(gathers and copies move exact values; an inactive slot is a no-op
whatever row it reads); the spilled store's prefetch depth and LRU size
change when bytes move, never which; a streaming federation equals its
materialized self; each reschedule's host->device copy is charged to the
intra-pod ledger and the WAN ledger never moves with the policy.  The
store's device bytes are ``U_cap`` rows, whatever ``K``.  All exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import client_store as jstore                      # noqa: E402

from repro_torch.core import (AstraeaTrainer, EngineConfig, FedAvgTrainer,  # noqa: E402
                              LocalSpec)
from repro_torch.core import client_store                         # noqa: E402
from repro_torch.data.federated import EMNIST_LIKE, partition       # noqa: E402
from repro_torch.data.synthetic import (StreamingFederation,        # noqa: E402
                                        SyntheticSpec, federation_counts)
from repro_torch.models.cnn import emnist_cnn, init_params          # noqa: E402
from repro_torch.optim import adam                                  # noqa: E402

ROUNDS = 3


def _federation():
    spec = dataclasses.replace(EMNIST_LIKE, num_classes=8, image_size=16)
    return partition(spec, num_clients=12, total_samples=300, test_samples=80,
                     sizes="instagram", global_dist="letterfreq", local="random",
                     seed=0)


def _trainer(kind, data, store, *, nc=8, hw=16, **kw):
    model = emnist_cnn(nc, hw)
    common = dict(clients_per_round=8, local=LocalSpec(10, 1), seed=0, device="cpu",
                  init_params=init_params(model, 0), store=store)
    if kind == "fedavg":
        return FedAvgTrainer(model, adam(1e-3), data, **common, **kw)
    return AstraeaTrainer(model, adam(1e-3), data, gamma=4, alpha=0.67,
                          reschedule_every_round=True, **common, **kw)


def _run(tr):
    tr.fit(ROUNDS, eval_every=ROUNDS)
    return tr


def _equal(a, b) -> bool:
    return all(torch.equal(a.params[k], b.params[k]) for k in a.params)


@pytest.mark.parametrize("row_exec", ["map", "vmap"])
@pytest.mark.parametrize("kind", ["astraea", "fedavg"])
def test_policies_give_equal_trajectories(kind, row_exec):
    """A reschedule every round: the same params bit for bit, the same WAN
    ledger; the streaming stores charge U_cap rows per reschedule to the
    intra-pod ledger, the replicated store nothing."""
    fed = _federation()
    runs = {p: _run(_trainer(kind, fed, p, row_exec=row_exec))
            for p in ("replicated", "host", "spilled")}
    rep = runs["replicated"]
    per_client = sum(a[0].nbytes for a in fed.padded(rep.engine.pad))
    for policy, tr in runs.items():
        assert _equal(tr, rep), policy
        assert tr.comm.round_log == rep.comm.round_log
        assert tr.engine.last_groups == rep.engine.last_groups
        streamed = 0 if policy == "replicated" else ROUNDS * 8 * per_client
        assert tr.comm.store_stream_bytes == tr.comm.intra_pod_bytes == streamed
        stats = tr.engine.store.stats()
        assert stats["policy"] == policy and stats["streamed_bytes"] == streamed
        want = 12 * per_client if policy == "replicated" else 8 * per_client
        assert stats["per_device_bytes"] == want


@pytest.mark.parametrize("depth,lru", [(1, None), (3, None), (1, 0), (3, 0), (2, 4)])
def test_spilled_pipeline_changes_no_bits(depth, lru):
    """Prefetch depth 1 to 3 and an LRU of 0, 4 or the default 2 U_cap
    rows: the same params as the host store, bit for bit; every reschedule
    after the first uses a prefetched stage; with no cache every row comes
    from the tier."""
    fed = _federation()
    host = _run(_trainer("fedavg", fed, "host"))
    tr = _run(_trainer("fedavg", fed, "spilled", store_prefetch_depth=depth,
                       store_lru_rows=lru))
    assert _equal(tr, host) and tr.comm.round_log == host.comm.round_log
    s = tr.engine.store.stats()
    assert s["prefetch_depth"] == depth and s["lru_rows"] == (16 if lru is None else lru)
    assert s["prefetch_hits"] == ROUNDS - 1 and s["prefetch_misses"] == 0
    assert s["cache_hit_rows"] + s["tier_rows"] == ROUNDS * 8
    if lru == 0:
        assert s["cache_hit_rows"] == 0 and s["lru_evictions"] == 0
    assert len(tr.engine._pending_sels) == depth


def test_spilled_mmap_tier(tmp_path):
    """The packed federation spilled to memmaps in a given directory."""
    fed = _federation()
    eng = _trainer("fedavg", fed, "replicated").engine
    store = client_store.build_client_store(
        "spilled", *fed.padded(eng.pad), device=torch.device("cpu"), capacity=8,
        spill_dir=str(tmp_path))
    assert store.stats()["spill_dir"] == str(tmp_path)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "clients_m.mmap", "clients_x.mmap", "clients_y.mmap"]
    idx = np.array([[3], [5]])
    data, index = store.plan(idx, np.ones((2, 1), np.float32))
    x, y, m = store.slot_data(data, index)
    xs, ys, ms = fed.padded(eng.pad)
    np.testing.assert_array_equal(x.numpy(), xs[idx])
    np.testing.assert_array_equal(y.numpy(), ys[idx])
    np.testing.assert_array_equal(m.numpy(), ms[idx])


def _stream(k, nc=8, hw=16):
    spec = SyntheticSpec(num_classes=nc, image_size=hw)
    return StreamingFederation(spec, federation_counts(k, nc, seed=1), batch_size=10,
                               seed=0, test_per_class=4)


@pytest.mark.parametrize("policy", ["host", "spilled"])
@pytest.mark.parametrize("kind", ["astraea", "fedavg"])
def test_streaming_federation_equals_materialized(kind, policy):
    """A lazy 40-client federation streamed into the host or spilled store
    against its materialized copy in the replicated store: the same
    schedules and params, bit for bit."""
    stream = _stream(40)
    tr = _run(_trainer(kind, stream, policy))
    ref = _run(_trainer(kind, stream.materialize(), "replicated"))
    assert tr.engine.pad == ref.engine.pad == stream.pad
    assert tr.engine.last_groups == ref.engine.last_groups
    assert _equal(tr, ref) and tr.comm.round_log == ref.comm.round_log


def test_device_bytes_do_not_depend_on_k():
    """The spilled store over 100 and 5,000 lazy clients: ``U_cap`` rows on
    the device, the same bytes (the reference's ``per_device_bytes``
    formula) and the same device arrays."""
    got = []
    for k in (100, 5000):
        stream = _stream(k)
        tr = _trainer("fedavg", stream, "spilled")
        tr.run_round()
        store = tr.engine.store
        held = sum(t.nbytes for t in store._dev)
        assert held == store.per_device_bytes() == 8 * stream.nbytes_per_client
        ref = jstore.SpilledHostStore.__new__(jstore.SpilledHostStore)
        ref._cap, ref._src = 8, stream
        assert jstore.HostStore.per_device_bytes(ref) == held
        got.append(held)
    assert got[0] == got[1]


def test_store_errors():
    fed = _federation()
    eng = _trainer("fedavg", fed, "replicated").engine
    cpu = torch.device("cpu")
    store = client_store.build_client_store("host", *fed.padded(eng.pad), device=cpu,
                                            capacity=3)
    with pytest.raises(ValueError, match="capacity is 3"):
        store.plan(np.arange(4)[:, None], np.ones((4, 1), np.float32))
    with pytest.raises(ValueError, match="unknown store_exchange"):
        _trainer("astraea", fed, "sharded", store_exchange="all_gather")
    with pytest.raises(ValueError, match="unknown client-store policy"):
        EngineConfig.fedavg(clients_per_round=4, local=LocalSpec(10, 1), store="disk")
    for bad in (dict(store_prefetch_depth=0), dict(store_lru_rows=-1)):
        with pytest.raises(ValueError):
            EngineConfig.fedavg(clients_per_round=4, local=LocalSpec(10, 1), **bad)
    with pytest.raises(ValueError, match="'host' or 'spilled'"):
        _trainer("fedavg", _stream(20), "replicated")
    with pytest.raises(ValueError, match="packed arrays"):
        client_store.build_client_store("replicated", device=cpu, source=_stream(20))
    with pytest.raises(ValueError, match="prefetch_depth"):
        client_store.build_client_store("spilled", source=_stream(20), device=cpu,
                                        prefetch_depth=0)
