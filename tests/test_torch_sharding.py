"""The port's sharding rules and abstract meshes (``launch/sharding.py``,
``launch/mesh.py``) against the reference's on the CPU: every parameter
of the ten architectures placed on both production meshes through the
port's ``Spec.logical`` axes, the shards' shapes, the batch, decode-cache,
optimizer-state and LoRA-adapter placements, and the mesh helpers.  The
reference's meshes are device-free ``AbstractMesh``es, so nothing here
needs more than one device."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

torch.set_num_threads(1)

import repro.configs as RC                                        # noqa: E402
from repro.configs.base import INPUT_SHAPES as R_SHAPES           # noqa: E402
from repro.configs.base import input_specs as r_input_specs       # noqa: E402
from repro.launch import mesh as RMesh                            # noqa: E402
from repro.launch import sharding as RS                           # noqa: E402
from repro.launch.compat import abstract_mesh                     # noqa: E402
from repro.models import lora as RLo                              # noqa: E402
from repro.models import transformer as RT                        # noqa: E402
from repro.models.layers import LogicalParam                      # noqa: E402

from repro_torch import configs as PC                             # noqa: E402
from repro_torch.launch import mesh as PMesh                      # noqa: E402
from repro_torch.launch import sharding as PS                     # noqa: E402
from repro_torch.models import transformer as PT                  # noqa: E402
from repro_torch.optim import adam                                # noqa: E402

MESHES = {"single16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    shape, axes = MESHES[name]
    return abstract_mesh(shape, axes), PMesh.AbstractMesh(axes, shape)


def _ref_leaves(specs) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, LogicalParam))[0]
    return {".".join(k.key for k in path): lp for path, lp in flat}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", PC.ARCH_IDS)
def test_spec_for_matches_reference_for_every_parameter(arch, mesh_name):
    """Each parameter's placement under the train rules and the model-only
    rules, and each device's shard shape, equal the reference's."""
    rmesh, pmesh = _meshes(mesh_name)
    ref = _ref_leaves(RT.param_specs(RC.get(arch)))
    specs = PT.param_specs(PC.get(arch))
    assert set(ref) == set(specs)
    for rrules, prules in ((RS.TRAIN_RULES, PS.TRAIN_RULES),
                           (RS.model_only_rules(), PS.model_only_rules())):
        shards = PS.param_shardings(specs, pmesh, prules)
        for k, lp in ref.items():
            assert specs[k].logical == tuple(lp.axes), k
            want = RS.spec_for(lp.shape, lp.axes, rmesh, rrules)
            assert shards[k].spec == tuple(want), (k, shards[k].spec, want)
            assert shards[k].shard_shape == tuple(
                NamedSharding(rmesh, want).shard_shape(lp.shape)), k


# the reference's own unit cases (tests/test_sharding.py)
UNIT_CASES = [
    ((6144, 6144), ("embed", "heads"), "single16x16", ("data", "model")),
    ((896, 896), ("embed", "heads"), "single16x16", ("data", "model")),
    ((50280,), ("vocab",), "single16x16", ()),
    ((8, 6144, 32768), ("expert", "embed", "mlp"), "single16x16", (None, "data", "model")),
    ((6144, 32768), ("embed", "mlp"), "pod2x16x16", (("pod", "data"), "model")),
    ((256, 256), ("vocab", "mlp"), "single16x16", ("model",)),
    ((51865, 512), ("vocab", "embed"), "single16x16", (None, "data")),
]


@pytest.mark.parametrize("shape,axes,mesh_name,want", UNIT_CASES)
def test_spec_for_unit_cases(shape, axes, mesh_name, want):
    rmesh, pmesh = _meshes(mesh_name)
    got = PS.spec_for(shape, axes, pmesh, PS.TRAIN_RULES)
    assert got == want == tuple(RS.spec_for(shape, axes, rmesh, RS.TRAIN_RULES))


def _port_cache_leaves(cfg, cache) -> dict:
    """The port's cache leaves under the reference's keys (an SSM model's
    sit under ``"ssm"`` in the port, at the top in the reference)."""
    if cfg.arch_type == "ssm":
        return dict(cache["ssm"])
    return {f"{blk}.{k}": t for blk, leaves in cache.items() for k, t in leaves.items()}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-370m", "hymba-1.5b", "whisper-base",
                                  "internvl2-1b"])
def test_batch_and_cache_shardings_match_reference(arch, mesh_name):
    rmesh, pmesh = _meshes(mesh_name)
    rcfg, cfg = RC.get(arch), PC.get(arch)
    for name in ("train_4k", "decode_32k", "long_500k"):
        if PC.skip_reason(cfg, PC.INPUT_SHAPES[name]):
            continue
        rins = r_input_specs(rcfg, R_SHAPES[name])
        pins = PC.input_specs(cfg, PC.INPUT_SHAPES[name])
        rb = RS.batch_shardings(rins["batch"], rmesh)
        pb = PS.batch_shardings(pins["batch"], pmesh)
        assert set(rb) == set(pb)
        for k, ns in rb.items():
            assert pb[k].spec == tuple(ns.spec), (name, k)
            assert pb[k].shard_shape == ns.shard_shape(rins["batch"][k].shape)
        if "cache" not in rins:
            continue
        rc = RS.cache_shardings(rins["cache"], rmesh)
        rflat = {".".join(k.key for k in path): ns for path, ns in
                 jax.tree_util.tree_flatten_with_path(rc)[0]}
        pc = _port_cache_leaves(cfg, PS.cache_shardings(pins["cache"], pmesh))
        assert set(rflat) == set(pc)
        for k, ns in rflat.items():
            assert pc[k].spec == tuple(ns.spec), (name, k)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "hymba-1.5b"])
def test_adapter_shardings_match_reference(arch):
    """LoRA rank 16: the state's and A's placements of every entry."""
    rmesh, pmesh = _meshes("single16x16")
    rcfg, cfg = RC.get(arch), PC.get(arch)
    rstate, ra = RS.adapter_shardings(RLo.build_mapping(RT.param_specs(rcfg), 16), rmesh)
    pstate, pa = PS.adapter_shardings(PT.adapter_mapping(cfg, 16), PT.param_specs(cfg), pmesh)
    assert set(rstate) == set(pstate) and set(ra) == set(pa)
    for want, got in ((rstate, pstate), (ra, pa)):
        for path, ns in want.items():
            assert got[path].spec == tuple(ns.spec), path


def test_opt_state_mirrors_parameters():
    """AdamW's moments take their parameters' placements, one a layer;
    the per-device bytes equal the stacked specs'."""
    cfg = PC.reduced(PC.get("granite-moe-3b-a800m"))
    _, pmesh = _meshes("single16x16")
    specs = PT.param_specs(cfg)
    shards = PS.param_shardings(specs, pmesh)
    per = PS.per_parameter(specs, shards)
    model = PT.Transformer(cfg, device="meta")
    params = PT.train_params(model)
    assert set(per) == set(params)
    state = adam(1e-3).init(params)
    opt = PS.opt_state_shardings(state, per, pmesh)
    assert opt["step"].spec == () and opt["mu"] == opt["nu"] == per
    assert sum(per[k].nbytes(p.dtype) for k, p in params.items()) == \
        sum(shards[k].nbytes(sp.dtype) for k, sp in specs.items())
    for k, p in params.items():
        assert len(per[k].shard_shape) == p.dim()


def test_meshes_and_helpers_match_reference():
    for multi in (False, True):
        pm = PMesh.make_production_mesh(multi_pod=multi)
        shape, axes = MESHES["pod2x16x16" if multi else "single16x16"]
        assert pm.axis_names == axes and pm.sizes == shape
        assert pm.size == int(np.prod(shape))
        rm = abstract_mesh(shape, axes)
        assert PMesh.data_axes(pm) == RMesh.data_axes(rm)
        assert PMesh.model_axis_size(pm) == RMesh.model_axis_size(rm) == 16
    assert PMesh.make_host_mesh().shape == {"data": 1, "model": 1}
    for n, s in ((4, 1), (4, 3), (8, 5)):
        assert PMesh.ring_permutation(n, s) == RMesh.ring_permutation(n, s)
    with pytest.raises(ValueError):
        PMesh.ring_permutation(4, 0)
    cpu4 = (torch.device("cpu"),) * 4
    assert PMesh.make_fl_mesh(mediator=4, devices=cpu4).shape == {"mediator": 4, "model": 1}
    assert PS.model_only_rules() == RS.model_only_rules()
    assert PS.TRAIN_RULES == RS.TRAIN_RULES and PS.INFER_RULES == RS.INFER_RULES


@pytest.mark.parametrize("call", [
    lambda: PMesh.make_fl_mesh(mediator=2, model=2),
    lambda: PMesh.process_local_mesh(2),
    lambda: PMesh.default_fl_mesh(2),
])
def test_distributed_runtime_is_refused_by_name(call):
    """Model-axis meshes without devices on a host without cards are
    refused by name: their positions take visible cards, one each, and
    logical positions must be spelled out (the model axis itself runs:
    tests/test_torch_model_mesh.py)."""
    with pytest.raises((ValueError, RuntimeError), match="card|CUDA device"):
        call()
