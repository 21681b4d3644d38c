"""The mediator axis as compute, on the CPU: each mediator row of a
``(mediator, model)`` mesh trains its own rows on its own positions (the
reference's ``mediator_shard_map``: ``repro/core/engine.py:203-245`` and
``repro/launch/steps.py:118-255``), over logical CPU positions.

* **The CNN engine** (``core/engine.py``) on ``4 x 1`` and ``2 x 2`` meshes
  at the reference's tiny federation (12 clients, 8 classes, 16 px, c=6,
  gamma=3, ``pad_mediators_to=4``, a reschedule each round): under
  ``"map"`` bit for bit the engine-device run -- ``EngineDeviceRows``, the
  oracle kept here: every row on the engine's device in one block, each
  store's slots gathered there, which is how rows trained before they
  moved to their positions -- for the replicated, host, spilled and
  sharded stores (both exchanges), with and without the online Alg. 2
  plan, with LoRA adapters and async S=0 masked.  Under ``"vmap"`` each
  mediator row is a round program of ``M_pad / n`` rows (``n`` programs,
  ``num_round_traces == n``); on this CPU a lockstep program's bits follow
  its width (one row takes the unbatched convolutions, and a bias
  gradient's sum reorders), so ``"vmap"`` is held bit for bit across the
  stores and exchanges at one mesh, and to the engine-device run (one
  program over every row) within ``VMAP_TOL``, the bound the engine's
  ``"vmap"`` against ``"map"`` already meets.
* **The device exchange** (``ShardedStore.serve``): each position's active
  slots equal the replicated store's, and the bytes copied between
  positions equal ``exchange_bytes_per_round``, the figure the intra-pod
  ledger books, a round; the WAN ledger does not change.
* **The transformer round** (``launch/steps.py::make_fl_round(mesh=)``) at
  ``(2, 1)``, ``(4, 1)`` and ``(2, 2)``, full-delta and over a LoRA
  adapter state, for qwen3-4b, granite-moe-3b-a800m, mamba2-370m and
  hymba-1.5b (reduced configs): bit for bit the in-turn round at the same
  ``t`` (the mesh ``(1, t)``); Eq. 6 is ``psum_eq6``: one ``fedavg_agg``
  a mediator row a leaf (a shard; the flat adapter tree), each over ``(M,
  block)``, never the ``(M, leaf)`` stack.  A mediator count the rows do
  not divide raises.
* **The reference**: the ``(2, 1)`` round against the reference's
  ``make_fl_round`` jitted on a 2-device host mesh (a subprocess with
  ``--xla_force_host_platform_device_count=2``, as ``tests/test_engine.py``
  runs its multi-device engine), full-delta and at LoRA rank 4 with the
  reference's ``A`` injected: every leaf's update within 1e-4 of the
  reference's largest update plus two fp32 spacings of the start, the
  bound ``tests/test_torch_lora.py`` holds the one-row round to.
* ``fl_train --devices cpu,cpu,cpu,cpu --model-parallel 2`` trains 2
  mediators a round; 3 positions at ``--model-parallel 2`` raise.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch import configs as C                                    # noqa: E402
from repro_torch.core import (AsyncRoundEngine, AsyncSpec, EngineConfig,  # noqa: E402
                              FLRoundEngine, LocalSpec, StragglerSpec)
from repro_torch.core.augmentation import augmentation_plan           # noqa: E402
from repro_torch.core.client_store import build_client_store          # noqa: E402
from repro_torch.data.federated import EMNIST_LIKE, partition          # noqa: E402
from repro_torch.launch import fl_train, steps                         # noqa: E402
from repro_torch.launch.mesh import make_fl_mesh, model_devices        # noqa: E402
from repro_torch.models import lora as lora_lib                        # noqa: E402
from repro_torch.models import transformer as T                        # noqa: E402
from repro_torch.models.cnn import emnist_cnn                          # noqa: E402
from repro_torch.optim import adam                                     # noqa: E402

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
VMAP_TOL = 1e-4         # params after two rounds, the engine's "vmap" against "map"
ROUNDS = 2
STORES = [("replicated", "ragged"), ("host", "ragged"), ("spilled", "ragged"),
          ("sharded", "ragged"), ("sharded", "gather")]
STORE_IDS = ["replicated", "host", "spilled", "sharded-ragged", "sharded-gather"]
MESHES = {"4x1": (4, 1), "2x2": (2, 2)}


class EngineDeviceRows(FLRoundEngine):
    """The oracle: every schedule row on the engine's device in one block
    (one round program under ``"vmap"``), each store's slots gathered there
    (``slot_data``: the sharded store's direct copies, no exchange run)."""

    def row_positions(self):
        return [(self.device,) + tuple(model_devices(self.mesh, 0)[1:])]


def _federation():
    spec = dataclasses.replace(EMNIST_LIKE, num_classes=8, image_size=16)
    return partition(spec, num_clients=12, total_samples=600, test_samples=160,
                     sizes="instagram", global_dist="letterfreq", local="random",
                     seed=0)


FED = _federation()
PLAN = augmentation_plan(FED.client_counts().sum(0), 0.67)


def _mesh(shape):
    n, t = shape
    return make_fl_mesh(mediator=n, model=t, devices=(CPU,) * (n * t))


def _engine(shape, store="replicated", exchange="ragged", row_exec="map", aug=True,
            cls=FLRoundEngine, **kw):
    cfg = EngineConfig.astraea(clients_per_round=6, gamma=3, local=LocalSpec(10, 1), seed=0,
                               pad_mediators_to=4, reschedule_every_round=True,
                               store=store, store_exchange=exchange, row_exec=row_exec,
                               tp_rows=False, **kw)
    return cls(emnist_cnn(8, 16), adam(1e-3), FED, cfg, device="cpu", mesh=_mesh(shape),
               aug_plan=PLAN if aug else None)


def _rounds(runner, rounds=ROUNDS):
    for _ in range(rounds):
        runner.run_round()
    return runner


def _same(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# --------------------------------------------------------------------------
# the CNN engine: rows on their positions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("aug", [True, False], ids=["plan", "no-plan"])
@pytest.mark.parametrize("store,exchange", STORES, ids=STORE_IDS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_map_rows_on_positions_bitwise_engine_device_run(mesh, store, exchange, aug):
    """Under ``"map"`` the rows trained on their mediator rows' positions
    (each store serving each row its slots there, the online warp one
    launch a row) give the engine-device run's params bit for bit, with
    the same WAN and intra-pod ledgers."""
    got = _rounds(_engine(MESHES[mesh], store, exchange, aug=aug))
    want = _rounds(_engine(MESHES[mesh], store, exchange, aug=aug, cls=EngineDeviceRows))
    _same(got.params, want.params)
    assert got.comm.round_log == want.comm.round_log
    assert got.comm.intra_pod_bytes == want.comm.intra_pod_bytes
    assert got.num_round_traces == want.num_round_traces == 0


@pytest.mark.parametrize("mesh", list(MESHES))
def test_vmap_one_program_a_mediator_row_bitwise_across_stores(mesh):
    """Under ``"vmap"``: one round program a mediator row (``M_pad / n``
    rows each), built once; every store and both exchanges give the same
    params bit for bit and the same WAN ledger; the engine-device run (one
    program over all ``M_pad`` rows) lies within ``VMAP_TOL``."""
    n = MESHES[mesh][0]
    runs = [_rounds(_engine(MESHES[mesh], s, x, row_exec="vmap")) for s, x in STORES]
    for e in runs:
        assert e.num_round_traces == n and len(e._programs) == n
        assert {p.m for p in e._programs} == {4 // n}
        assert [t.get("position") for t in e.trace_log] == list(range(n))
        _same(e.params, runs[0].params)
        assert e.comm.round_log == runs[0].comm.round_log
    oracle = _rounds(_engine(MESHES[mesh], row_exec="vmap", cls=EngineDeviceRows))
    assert oracle.num_round_traces == 1
    err = max(float((runs[0].params[k] - oracle.params[k]).abs().max()) for k in oracle.params)
    assert err <= VMAP_TOL, err


@pytest.mark.parametrize("row_exec", ["map", "vmap"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_lora_rows_on_positions(mesh, row_exec):
    """Rank-2 LoRA adapters over the sharded store: under ``"map"`` the
    adapter state is the engine-device run's bit for bit; under both the
    replicated store's, with the adapter-sized WAN ledger."""
    got = _rounds(_engine(MESHES[mesh], "sharded", row_exec=row_exec, lora_rank=2))
    rep = _rounds(_engine(MESHES[mesh], "replicated", row_exec=row_exec, lora_rank=2))
    _same(got.adapters, rep.adapters)
    assert got.comm.round_log == rep.comm.round_log
    assert got.comm.wan_adapter_bytes > 0
    if row_exec == "map":
        want = _rounds(_engine(MESHES[mesh], "sharded", lora_rank=2, cls=EngineDeviceRows))
        _same(got.adapters, want.adapters)


@pytest.mark.parametrize("row_exec", ["map", "vmap"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_async_s0_masked_on_positions_bitwise_sync(mesh, row_exec):
    """Async S=0, a masked wave per mediator over the sharded store: the
    sync run's params bit for bit (the masked waves run each row's
    program on its positions); under ``"map"`` the engine-device run's
    too."""
    spec = AsyncSpec(staleness_bound=0, wave_size=1, dispatch="masked",
                     straggler=StragglerSpec(model="fixed", seed=0))
    eng = _engine(MESHES[mesh], "sharded", row_exec=row_exec)
    _rounds(AsyncRoundEngine(eng, spec))
    sync = _rounds(_engine(MESHES[mesh], "sharded", row_exec=row_exec))
    _same(eng.params, sync.params)
    assert eng.comm.round_log == sync.comm.round_log
    if row_exec == "map":
        _same(eng.params, _rounds(_engine(MESHES[mesh], "sharded",
                                          cls=EngineDeviceRows)).params)


# --------------------------------------------------------------------------
# the sharded store's exchange on the devices
# --------------------------------------------------------------------------

@pytest.mark.parametrize("exchange", ["ragged", "gather"])
@pytest.mark.parametrize("n", [2, 4])
def test_device_exchange_serves_each_position_the_replicated_slots(n, exchange):
    """``serve`` on ``n`` logical shards over random schedules (inactive
    slots and dummy clients included): each position's block of active
    slots equals the replicated store's, and the rows copied between
    positions are the bytes the plan charges."""
    rng = np.random.default_rng(7)
    xs = rng.standard_normal((10, 5, 3, 3, 1)).astype(np.float32)
    ys = rng.integers(0, 8, (10, 5)).astype(np.int32)
    ms = (rng.random((10, 5)) < 0.8).astype(np.float32)
    rep = build_client_store("replicated", xs, ys, ms, device=CPU)
    store = build_client_store("sharded", xs, ys, ms, device=CPU, exchange=exchange,
                               mesh=_mesh((n, 1)))
    homes = [CPU] * n
    for trial in range(4):
        idx = rng.integers(0, 10, (8, 3))
        slot = (rng.random((8, 3)) < 0.75).astype(np.float32)
        want = rep.slot_data(*rep.plan(idx, slot))
        data, plan = store.plan(idx, slot)
        blocks = store.serve(data, plan, homes)
        assert store.last_moved_bytes == store.exchange_bytes_per_round
        active = torch.from_numpy(slot > 0)
        step = 8 // n
        for i, block in enumerate(blocks):
            rows = slice(i * step, (i + 1) * step)
            for got, w in zip(block, want):
                assert got.shape == w[rows].shape
                assert torch.equal(got[active[rows]], w[rows][active[rows]])
    # the whole block on the engine's device (the oracle's copies) is the
    # replicated store's, inactive slots too
    for got, w in zip(store.slot_data(data, plan), want):
        assert torch.equal(got, w)


@pytest.mark.parametrize("exchange", ["ragged", "gather"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_engine_moves_the_exchange_bytes_it_charges(mesh, exchange):
    """A round over the sharded store moves its exchange between the
    positions once; the bytes moved every round equal the round's
    ``exchange_bytes_per_round`` and in all the intra-pod ledger's
    ``store_exchange`` bytes; the WAN ledger is the replicated store's."""
    eng = _engine(MESHES[mesh], "sharded", exchange)
    moved = []
    for _ in range(3):
        eng.run_round()
        moved.append(eng.store.last_moved_bytes)
        assert moved[-1] == eng.store.exchange_bytes_per_round
    assert eng.store.moved_bytes == sum(moved) == eng.comm.store_exchange_bytes > 0
    rep = _rounds(_engine(MESHES[mesh], "replicated"), 3)
    assert eng.comm.round_log == rep.comm.round_log
    assert rep.comm.store_exchange_bytes == 0


# --------------------------------------------------------------------------
# the transformer round over the mediator rows
# --------------------------------------------------------------------------

FAMILIES = ("qwen3-4b", "granite-moe-3b-a800m", "mamba2-370m", "hymba-1.5b")
ROUND_MESHES = {"2x1": ((2, 1), 2), "4x1": ((4, 1), 4), "2x2": ((2, 2), 4)}
LOCAL_STEPS = 2


def _model(arch):
    cfg = C.reduced(C.get(arch))
    model = T.init_model(cfg, torch.Generator().manual_seed(0), device=CPU)
    with torch.no_grad():       # the standard fan-in (tests/test_torch_tp_round.py)
        for name, p in model.named_parameters():
            if name.startswith("layers.") and p.dim() == 2:
                p.mul_((cfg.n_layers / p.shape[0]) ** 0.5)
            elif name.startswith("layers.") and p.dim() == 3:
                p.mul_((cfg.n_layers / p.shape[-2]) ** 0.5)
    return model


def _batch(cfg, mediators):
    seq = max(32, cfg.ssm_chunk if cfg.has_ssm else 0)
    rows = mediators * LOCAL_STEPS
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (rows, seq), generator=g)
    weights = torch.arange(1, rows + 1, dtype=torch.float32)
    return tokens, torch.roll(tokens, -1, 1), weights


class _Eq6Calls:
    """Records each ``fedavg_agg`` call's ``(M, N)`` (and still runs it)."""

    def __init__(self, monkeypatch):
        self.shapes = []
        real = steps.ops.fedavg_agg

        def record(deltas, weights):
            self.shapes.append(tuple(deltas.shape))
            return real(deltas, weights)
        monkeypatch.setattr(steps.ops, "fedavg_agg", record)


@pytest.mark.parametrize("lora", [False, True], ids=["full-delta", "lora"])
@pytest.mark.parametrize("mesh", list(ROUND_MESHES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_fl_round_on_mediator_rows_bitwise_in_turn(arch, mesh, lora, monkeypatch):
    """The round over the mesh's mediator rows equals the in-turn round
    (every mediator on mediator row 0, mesh ``(1, t)``) bit for bit at the
    same ``t``; Eq. 6 runs one launch a mediator row a leaf (a shard) or a
    flat adapter tree, over ``(M, block)`` with the blocks covering the
    leaf once."""
    (n, t), m = ROUND_MESHES[mesh]
    model = _model(arch)
    params = T.train_params(model)
    tokens, labels, w = _batch(model.cfg, m)
    kw = dict(learning_rate=0.05, local_steps=LOCAL_STEPS)
    in_turn = make_fl_mesh(mediator=1, model=t, devices=(CPU,) * t) if t > 1 else None
    calls = _Eq6Calls(monkeypatch)
    if lora:
        mapping = T.adapter_mapping(model.cfg, 2)
        a_tree = lora_lib.init_adapter_A(lora_lib.A_SALT, mapping, CPU)
        state = lora_lib.init_adapter_state(mapping, params)
        state = {k: v + 0.01 * torch.randn(v.shape, generator=torch.Generator()
                                           .manual_seed(i)) for i, (k, v) in
                 enumerate(state.items())}
        want = steps.make_fl_round(model, m, lora_mapping=mapping, mesh=in_turn, **kw)(
            params, a_tree, state, tokens, labels, w)
        one = list(calls.shapes)
        calls.shapes.clear()
        got = steps.make_fl_round(model, m, lora_mapping=mapping, mesh=_mesh((n, t)), **kw)(
            params, a_tree, state, tokens, labels, w)
        total = sum(v.numel() for v in state.values())
        assert one == [(m, total)]
        assert [s[0] for s in calls.shapes] == [m] * n
        assert sum(s[1] for s in calls.shapes) == total
    else:
        want = steps.make_fl_round(model, m, mesh=in_turn, **kw)(params, tokens, labels, w)
        one = list(calls.shapes)
        calls.shapes.clear()
        got = steps.make_fl_round(model, m, mesh=_mesh((n, t)), **kw)(
            params, tokens, labels, w)
        # each leaf (each shard) in blocks over the rows, covering it once
        blocks = [len(steps.eq6_blocks(s[1], n)) for s in one]
        assert len(calls.shapes) == sum(blocks) > len(one)
        at = 0
        for s, b in zip(one, blocks):
            part = calls.shapes[at:at + b]
            at += b
            assert all(p[0] == m for p in part) and sum(p[1] for p in part) == s[1]
            assert max(p[1] for p in part) < s[1] or s[1] <= steps.EQ6_BLOCK_ALIGN
    _same(got, want)
    moved = max(float((want[k] - params[k]).abs().max()) for k in params) if not lora \
        else max(float((want[k] - state[k]).abs().max()) for k in state)
    assert moved > 0


def test_fl_round_mediators_must_split_over_the_rows():
    model = _model("qwen3-4b")
    params = T.train_params(model)
    tokens, labels, w = _batch(model.cfg, 3)
    with pytest.raises(ValueError, match="mediator rows"):
        steps.make_fl_round(model, 3, local_steps=LOCAL_STEPS, mesh=_mesh((2, 1)))
    with pytest.raises(ValueError, match="mediator rows"):
        steps.make_fl_round(model, 2, local_steps=LOCAL_STEPS, mesh=_mesh((4, 1)))
    # one mediator a row of a 3 x 1 mesh runs
    out = steps.make_fl_round(model, 3, local_steps=LOCAL_STEPS, mesh=_mesh((3, 1)))(
        params, tokens, labels, w)
    assert set(out) == set(params)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_eq6_blocks_cover_every_leaf_once(n):
    for size in (1, 63, 64, 65, 128, 130, 1000, 68_873):
        blocks = steps.eq6_blocks(size, n)
        assert blocks[0][0] == 0 and blocks[-1][1] == size and len(blocks) <= n
        assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
        assert all(lo % steps.EQ6_BLOCK_ALIGN == 0 and hi > lo for lo, hi in blocks)


# --------------------------------------------------------------------------
# the (2, 1) round against the reference's on two host devices
# --------------------------------------------------------------------------

LR, REF_STEPS, SEQ, RANK = 0.05, 2, 32, 4
_REFERENCE_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import sys
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    import repro.configs as RC
    from repro.launch import steps as RS
    from repro.launch.compat import use_mesh
    from repro.models import lora as RL
    from repro.models import transformer as RT
    from repro_torch.convert import adapter_tree_from_jax, transformer_params_from_jax

    out, lr, local_steps, seq, rank = sys.argv[1], float(sys.argv[2]), int(sys.argv[3]), \\
        int(sys.argv[4]), int(sys.argv[5])
    rcfg = RC.reduced(RC.get("qwen3-4b"))
    assert len(jax.devices()) == 2
    mesh = Mesh(np.asarray(jax.devices()).reshape(2, 1), ("data", "model"))
    params = RT.init_params(jax.random.PRNGKey(0), rcfg)
    spec_tree = jax.tree.map(lambda _: P(), RT.param_specs(rcfg),
                             is_leaf=lambda x: hasattr(x, "axes"))
    toks = np.random.default_rng(1).integers(0, rcfg.vocab,
                                             (2 * local_steps, seq)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    weights = np.repeat(np.array([32.0, 96.0], np.float32), local_steps)
    args = (jnp.asarray(toks), jnp.asarray(labels), jnp.asarray(weights))
    full = jax.jit(RS.make_fl_round(rcfg, mesh, spec_tree, learning_rate=lr,
                                    local_steps=local_steps))
    mapping = RT.adapter_mapping(rcfg, rank)
    a_tree = RL.init_adapter_A(jax.random.fold_in(jax.random.PRNGKey(0), RL.A_SALT),
                               mapping)
    state = jax.tree.map(lambda s: s + 0.01, RL.init_adapter_state(mapping, params))
    fl_lora = jax.jit(RS.make_fl_round(rcfg, mesh, spec_tree, learning_rate=lr,
                                       local_steps=local_steps, lora_mapping=mapping))
    with use_mesh(mesh):
        new = full(params, *args)
        new_state = fl_lora(params, a_tree, state, *args)
    conv = lambda t: transformer_params_from_jax(jax.tree.map(np.asarray, t))
    adapt = lambda t: adapter_tree_from_jax(jax.tree.map(np.asarray, t))
    arrays = {"tokens": toks, "labels": labels, "weights": weights}
    for name, tree in (("start", conv(params)), ("full", conv(new)), ("a", adapt(a_tree)),
                       ("state", adapt(state)), ("lora", adapt(new_state))):
        for k, v in tree.items():
            arrays[f"{name}|{k}"] = np.asarray(v, np.float32)
    np.savez(out, **arrays)
""")


def _close_step(got, want, start, rel=1e-4):
    """``tests/test_torch_lora.py``'s bound: the update ``got - start``
    within ``rel`` of the reference update's largest magnitude plus two
    fp32 spacings of the start's largest value."""
    got, want, start = (np.asarray(x, np.float32) for x in (got, want, start))
    d_ref = want - start
    tol = rel * float(np.abs(d_ref).max()) + 2 * float(np.spacing(np.abs(start).max()))
    err = float(np.abs((got - start) - d_ref).max())
    assert err <= tol, f"{err} > {tol}"
    return float(np.abs(d_ref).max())


@pytest.fixture(scope="module")
def reference_two_rows(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref2") / "round.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_SCRIPT, str(out), str(LR),
                           str(REF_STEPS), str(SEQ), str(RANK)],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as z:
        arrays = {k: z[k] for k in z.files}
    trees: dict = {}
    for key, v in arrays.items():
        if "|" in key:
            name, leaf = key.split("|", 1)
            trees.setdefault(name, {})[leaf] = torch.from_numpy(v)
    return arrays, trees


def test_two_rows_round_matches_reference_on_two_host_devices(reference_two_rows):
    """qwen3-4b's reduced round, 2 mediators on a ``(2, 1)`` mesh (one a
    row), against the reference's ``make_fl_round`` jitted over 2 host
    devices from the same weights and tokens: every leaf's update within
    the bound of ``_close_step``, full-delta and over a rank-4 adapter
    state with the reference's ``A``."""
    arrays, trees = reference_two_rows
    model = T.Transformer(C.reduced(C.get("qwen3-4b")))
    model.load_state_dict(trees["start"])
    start = T.train_params(model)
    tokens, labels, weights = (torch.from_numpy(arrays[k]).to(dtype)
                               for k, dtype in (("tokens", torch.int64),
                                                ("labels", torch.int64),
                                                ("weights", torch.float32)))
    mesh = _mesh((2, 1))
    got = steps.make_fl_round(model, 2, learning_rate=LR, local_steps=REF_STEPS,
                              mesh=mesh)(start, tokens, labels, weights)
    moved = [_close_step(got[k], trees["full"][k], start[k]) for k in start]
    assert max(moved) > 1e-3
    mapping = T.adapter_mapping(model.cfg, RANK)
    state = trees["state"]
    got = steps.make_fl_round(model, 2, learning_rate=LR, local_steps=REF_STEPS,
                              lora_mapping=mapping, mesh=mesh)(
        start, trees["a"], state, tokens, labels, weights)
    assert set(got) == set(trees["lora"])
    moved = [_close_step(got[k], trees["lora"][k], state[k]) for k in state]
    assert max(moved) > 0


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def test_fl_train_trains_a_mediator_a_row():
    """``--devices`` names ``n * t`` positions row-major: four CPU
    positions at ``--model-parallel 2`` train 2 mediators a round (Alg. 3
    makes 2 of 8 clients at gamma 4), the WAN ledger books both; three
    positions raise, as in the reference."""
    out = fl_train.main(["--device", "cpu", "--devices", "cpu,cpu,cpu,cpu",
                         "--model-parallel", "2", "--rounds", "1"])
    assert out["mediators_trained"] == 2 and all(np.isfinite(out["losses"]))
    solo = fl_train.main(["--device", "cpu", "--rounds", "1"])
    assert solo["mediators_trained"] == 1
    assert out["ledger"]["wan_bytes_total"] > solo["ledger"]["wan_bytes_total"]
    with pytest.raises(SystemExit, match="divisible"):
        fl_train.main(["--device", "cpu", "--devices", "cpu,cpu,cpu",
                       "--model-parallel", "2"])
