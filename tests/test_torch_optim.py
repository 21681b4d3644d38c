"""Port parity for the rest of ``optim/``: AdamW, Adam and SGD under a
learning-rate schedule, global-norm clipping and the schedules, against
``repro/optim`` on the same params and gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.optim import optimizers as jopt                        # noqa: E402
from repro.optim import schedules as jsched                       # noqa: E402

from repro_torch.convert import params_from_jax                   # noqa: E402
from repro_torch.optim import (adam, adamw, apply_updates,        # noqa: E402
                               clip_by_global_norm, schedules, sgd)

from torch_parity import max_param_diff, reference_params         # noqa: E402

SCHEDULES = {
    "constant": (lambda m: m.constant(3e-3)),
    "cosine": (lambda m: m.cosine_decay(1e-2, 7, final_frac=0.1)),
    "warmup_cosine": (lambda m: m.warmup_cosine(1e-2, 3, 9)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_reference(name):
    port, ref = SCHEDULES[name](schedules), SCHEDULES[name](jsched)
    for step in range(0, 14):
        got = port(step)
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(ref(jnp.asarray(step, jnp.int32))),
                                           rel=1e-6, abs=1e-12)


def _grads(tree, n, seed):
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), tree)
            for _ in range(n)]


def _run_both(jo, po, tree, grads):
    jstate, jp = jo.init(tree), tree

    @jax.jit
    def jstep(g, jstate, jp):
        upd, jstate = jo.update(g, jstate, jp)
        return jax.tree.map(lambda p, u: p + u, jp, upd), jstate

    params = params_from_jax(tree)
    state = po.init(params)
    for g in grads:
        jp, jstate = jstep(g, jstate, jp)
        upd, state = po.update(params_from_jax(g), state, params)
        params = apply_updates(params, upd)
    return params, jp


@pytest.mark.parametrize("lr", ["float", "warmup_cosine"])
@pytest.mark.parametrize("wd", [0.01, 0.3])
def test_adamw_steps_match_reference(lr, wd):
    tree = reference_params(8, 16, 5)
    rate = 1e-3 if lr == "float" else None
    jrate = rate if rate else jsched.warmup_cosine(1e-3, 2, 6)
    prate = rate if rate else schedules.warmup_cosine(1e-3, 2, 6)
    params, jp = _run_both(jopt.adamw(jrate, weight_decay=wd), adamw(prate, weight_decay=wd),
                           tree, _grads(tree, 4, 6))
    assert max_param_diff(params, jp) < 1e-6


def test_adam_and_sgd_take_schedules_like_reference():
    tree = reference_params(8, 16, 7)
    grads = _grads(tree, 4, 8)
    params, jp = _run_both(jopt.adam(jsched.cosine_decay(1e-2, 4)),
                           adam(schedules.cosine_decay(1e-2, 4)), tree, grads)
    assert max_param_diff(params, jp) < 1e-6
    params, jp = _run_both(jopt.sgd(jsched.warmup_cosine(0.1, 2, 5), momentum=0.9),
                           sgd(schedules.warmup_cosine(0.1, 2, 5), momentum=0.9),
                           tree, grads)
    assert max_param_diff(params, jp) < 1e-6


@pytest.mark.parametrize("max_norm", [0.5, 1e4])
def test_clip_by_global_norm_matches_reference(max_norm):
    tree = _grads(reference_params(8, 16, 9), 1, 10)[0]
    expect = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), max_norm)
    got = clip_by_global_norm(params_from_jax(tree), max_norm)
    assert max_param_diff(got, expect) < 1e-6
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in got.values())))
    assert norm == pytest.approx(min(max_norm, norm), rel=1e-5)
    if max_norm > 1e3:           # below the norm: gradients pass unchanged
        for k, g in params_from_jax(tree).items():
            assert torch.equal(got[k], g)
