"""The port's measurement layer on the CPU (``roofline/``): the useful-FLOP
references and parameter counts against the reference's for every arch x
input shape, every kernel's analytic cost against the reference's
``CostEstimate`` (and the two backwards' against ``kernel_times.py``'s
bounds), the roofline's arithmetic, and the step-cost counter: a matmul
counted exactly, each ``ops`` wrapper charged by its cost with its plain
version uncounted, the wrappers' meta branch (shape-only, its outputs'
shapes and dtypes the plain version's; a meta input outside it raises),
and a reduced model's train step counted alike on the CPU and on meta."""
import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.configs as RC                                        # noqa: E402
from repro.kernels import affine_warp as r_warp                   # noqa: E402
from repro.kernels import fedavg_agg as r_fedavg                  # noqa: E402
from repro.kernels import flash_attention as r_flash              # noqa: E402
from repro.kernels import kld_score as r_kld                      # noqa: E402
from repro.kernels import ssd_chunk as r_ssd                      # noqa: E402
from repro.models import transformer as RT                        # noqa: E402
from repro.roofline import model as RM                            # noqa: E402

from repro_torch import configs as PC                             # noqa: E402
from repro_torch.examples import kernel_times                     # noqa: E402
from repro_torch.kernels import ops, ref                          # noqa: E402
from repro_torch.launch import steps                              # noqa: E402
from repro_torch.models import transformer as PT                  # noqa: E402
from repro_torch.optim import adam                                # noqa: E402
from repro_torch.roofline import counts as PCnt                   # noqa: E402
from repro_torch.roofline import model as PM                      # noqa: E402


def _same_cost(got, want):
    assert (got.flops, got.transcendentals, got.bytes_accessed) == \
        (want.flops, want.transcendentals, want.bytes_accessed)


# ---------------------------------------------------------------- model

@pytest.mark.parametrize("shape", list(PC.INPUT_SHAPES))
@pytest.mark.parametrize("arch", PC.ARCH_IDS)
def test_model_flops_match_reference(arch, shape):
    rcfg, cfg = RC.get(arch), PC.get(arch)
    s = PC.INPUT_SHAPES[shape]
    tokens = s.global_batch * (s.seq_len if s.kind != "decode" else 1)
    for kind in (s.kind, "train"):
        assert PM.model_flops(cfg, tokens, kind) == RM.model_flops(rcfg, tokens, kind)
        assert PM.analytic_flops_per_token(cfg, s.seq_len, kind) == \
            RM.analytic_flops_per_token(rcfg, s.seq_len, kind)
    max_seq = max(s.seq_len, 4096)
    assert PT.param_count(cfg, max_seq) == RT.param_count(rcfg, max_seq)
    assert PT.active_param_count(cfg, max_seq) == RT.active_param_count(rcfg, max_seq)


# ---------------------------------------------------------------- kernel costs

@pytest.mark.parametrize("m,n,db,ob", [(16, 68_873, 4, 4), (2, 388_956_160, 2, 2),
                                       (4, 2_142, 4, 4)])
def test_fedavg_cost_matches_reference(m, n, db, ob):
    _same_cost(PM.fedavg_agg_cost(m, n, db, ob), r_fedavg.cost_estimate(m, n, db, ob))


@pytest.mark.parametrize("m,k,c", [(1, 16, 10), (1, 4096, 47), (256, 1024, 47),
                                   (16, 512, 2000)])
def test_score_and_greedy_costs_match_reference(m, k, c):
    _same_cost(PM.score_cost(m, k, c), r_kld.score_cost(m, k, c))
    _same_cost(PM.greedy_cost(k, c), r_kld.greedy_cost(k, c))


@pytest.mark.parametrize("b,h,w,c,ib", [(7360, 28, 28, 1, 4), (4096, 32, 32, 3, 4),
                                        (2, 20, 36, 3, 2)])
def test_affine_warp_cost_matches_reference(b, h, w, c, ib):
    _same_cost(PM.affine_warp_cost(b, h, w, c, ib), r_warp.cost_estimate(b, h, w, c, ib))


@pytest.mark.parametrize("b,h,sq,skv,d,io", [(4, 32, 128, 128, 128, 2),
                                             (1, 8, 2048, 2048, 256, 4),
                                             (4, 8, 1, 1536, 64, 2)])
def test_flash_cost_matches_reference(b, h, sq, skv, d, io):
    _same_cost(PM.flash_attention_cost(b, h, sq, skv, d, io),
               r_flash.cost_estimate(b, h, sq, skv, d, io))


@pytest.mark.parametrize("b,nc,L,h,p,n,io", [(4, 2, 64, 25, 64, 16, 4),
                                             (4, 8, 64, 32, 64, 128, 4),
                                             (1, 3, 16, 2, 8, 4, 2)])
def test_ssd_cost_matches_reference(b, nc, L, h, p, n, io):
    _same_cost(PM.ssd_chunk_cost(b, nc, L, h, p, n, io),
               r_ssd.cost_estimate(b, nc, L, h, p, n, io))


@pytest.mark.parametrize("sq,skv,h,kv,causal,window,off,dtype", [
    (9, 9, 4, 2, True, None, 0, torch.float32),
    (5, 12, 4, 1, True, 4, 7, torch.bfloat16),
    (6, 11, 2, 2, False, None, 0, torch.float32),
    (7, 7, 4, 4, False, 3, 0, torch.float32),
])
def test_backward_costs_are_kernel_times_bounds(sq, skv, h, kv, causal, window, off, dtype):
    """The two backwards are charged the operations and bytes
    ``kernel_times.py`` bounds them by, and the visible pairs are the
    plain mask's."""
    b, d = 2, 8
    q = torch.zeros(b, sq, h, d, dtype=dtype)
    k = torch.zeros(b, skv, kv, d, dtype=dtype)
    mask = ref.attention_mask(sq, skv, causal=causal, window=window, q_offset=off,
                              device="cpu")
    assert PM.visible_pairs(sq, skv, causal, window, off) == int(mask.sum())
    cost = PM.flash_attention_bwd_cost(b, h, kv, sq, skv, d, q.element_size(), causal,
                                       window, off)
    peak = kernel_times.BF16_FLOPS_PER_S if dtype == torch.bfloat16 \
        else kernel_times.FP32_FLOPS_PER_S
    assert kernel_times.bound(cost.bytes_accessed, cost.flops, peak) == \
        kernel_times.flash_bwd_bound(q, k, mask)
    for shape in ((4, 2, 64, 25, 64, 16), (4, 8, 64, 32, 64, 128), (1, 3, 16, 2, 8, 4)):
        c = PM.ssd_chunk_bwd_cost(*shape)
        assert kernel_times.bound(c.bytes_accessed, c.flops) == \
            kernel_times.ssd_bwd_bound(*shape)


def test_peaks_are_the_h100_data_sheet():
    hw = PM.HW()
    assert (hw.peak_flops, hw.peak_flops_tf32, hw.peak_flops_fp32, hw.hbm_bw, hw.link_bw) == \
        (989e12, 495e12, 67e12, 3.35e12, 450e9)
    assert (kernel_times.BF16_FLOPS_PER_S, kernel_times.FP32_FLOPS_PER_S,
            kernel_times.HBM_BYTES_PER_S, kernel_times.TF32_FLOPS_PER_S) == \
        (hw.peak_flops, hw.peak_flops_fp32, hw.hbm_bw, hw.peak_flops_tf32)


def test_roofline_math():
    hw = PM.HW()
    t = PM.roofline_from_costs(989e12, 6.7e12, None, 494.5e12)
    assert t.compute_s == 1.0 and t.memory_s == 2.0 and t.collective_s is None
    assert t.dominant == "memory" and t.step_time_s == 2.0 and t.useful_ratio == 0.5
    d = t.as_dict()
    assert d["collective_bytes"] is None and d["dominant"] == "memory"
    t = PM.roofline_from_costs(989e12, 0.0, 900e9, 1.0)
    assert t.collective_s == 2.0 and t.dominant == "collective"
    kr = PM.kernel_roofline(989e12, 3.35e12)
    assert kr["compute_s"] == kr["memory_s"] == kr["roofline_s"] == 1.0
    assert kr["bound"] == "compute" and kr["intensity"] == 989e12 / 3.35e12
    kr = PM.kernel_roofline(1.0, 3.35e12)
    assert kr["bound"] == "memory" and kr["ridge_intensity"] == hw.peak_flops / hw.hbm_bw
    assert PM.achieved_fraction(2.0, 1.0) == 0.5


# ---------------------------------------------------------------- the counter

@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_step_costs_of_a_matmul_is_exact(device):
    m, k, n = 7, 5, 3
    a, b = torch.ones(m, k, device=device), torch.ones(k, n, device=device)
    c = PCnt.step_costs(lambda x, y: x @ y, a, b)
    assert c.flops == 2 * m * k * n
    assert c.bytes == 4 * (m * k + k * n + m * n)
    assert list(c.by_op) == ["aten.mm"] and c.kernels == {}
    assert c.collective_bytes is None
    assert c.result.shape == (m, n)
    if device == "meta":
        assert c.start_bytes == 4 * (m * k + k * n)
        assert c.peak_bytes == c.start_bytes + 4 * m * n


def _rng_t(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)


def _cases():
    """(kernel name, call, inputs) of every wrapper at a shape the card
    takes (flash head dim 64; SSD chunk 8)."""
    rng = np.random.default_rng(0)
    t = lambda *s, **kw: _rng_t(rng, *s, **kw)              # noqa: E731
    counts = torch.from_numpy(rng.integers(0, 9, size=(9, 4)).astype(np.float32))
    q, kk, vv = t(1, 8, 4, 64), t(1, 8, 2, 64), t(1, 8, 2, 64)
    out = ref.flash_attention(q, kk, vv).contiguous()
    x, dt, A, B, C = t(1, 2, 8, 2, 4), t(1, 2, 8, 2).abs(), -t(2).abs(), t(1, 2, 8, 3), \
        t(1, 2, 8, 3)
    return {
        "fedavg_agg": (ops.fedavg_agg, (t(5, 37), t(5).abs())),
        "kld_greedy_picks": (ops.kld_greedy_picks, (counts, 3)),
        "kld_score": (ops.kld_score, (counts[0].clone(), counts)),
        "kld_score_matrix": (ops.kld_score_matrix, (counts[:3].clone(), counts)),
        "affine_warp": (ops.affine_warp, (t(2, 6, 5, 1), t(2, 2, 2), t(2, 2))),
        "flash_attention": (lambda *a: ops.flash_attention(*a, causal=True, window=5),
                            (q, kk, vv)),
        "flash_attention_bwd": (ops.flash_attention_bwd, (q, kk, vv, out, t(1, 8, 4, 64))),
        "ssd_chunk": (ops.ssd_chunk, (x, dt, A, B, C)),
        "ssd_chunk_bwd": (ops.ssd_chunk_bwd, (x, dt, A, B, C, t(1, 2, 8, 2, 4),
                                              t(1, 2, 2, 3, 4), t(1, 2, 2))),
    }


def _meta(args):
    return tuple(a.to("meta") if isinstance(a, torch.Tensor) else a for a in args)


def _flat(out):
    return list(out) if isinstance(out, tuple) else [out]


KERNELS = list(ops.LAUNCHES)


@pytest.mark.parametrize("name", KERNELS)
def test_meta_branch_gives_the_plain_versions_shapes(name):
    fn, args = _cases()[name]
    plain = _flat(fn(*args))
    ops.reset_launches()
    meta = _flat(PCnt.step_costs(fn, *_meta(args)).result)
    assert [(o.shape, o.dtype) for o in meta] == [(o.shape, o.dtype) for o in plain]
    assert all(o.device.type == "meta" for o in meta)
    assert sum(ops.LAUNCHES.values()) == 0


@pytest.mark.parametrize("name", KERNELS)
def test_meta_input_without_a_counter_raises(name):
    fn, args = _cases()[name]
    with pytest.raises(ValueError, match="unsupported device"):
        fn(*_meta(args))


# each case's analytic cost (``_cases``' shapes)
CASE_COSTS = {
    "fedavg_agg": PM.fedavg_agg_cost(5, 37, 4, 4),
    "kld_greedy_picks": PM.greedy_cost(9, 4),
    "kld_score": PM.score_cost(1, 9, 4),
    "kld_score_matrix": PM.score_cost(3, 9, 4),
    "affine_warp": PM.affine_warp_cost(2, 6, 5, 1, 4),
    "flash_attention": PM.flash_attention_cost(1, 4, 8, 8, 64, 4),
    "flash_attention_bwd": PM.flash_attention_bwd_cost(1, 4, 2, 8, 8, 64, 4),
    "ssd_chunk": PM.ssd_chunk_cost(1, 2, 8, 2, 4, 3, 4),
    "ssd_chunk_bwd": PM.ssd_chunk_bwd_cost(1, 2, 8, 2, 4, 3),
}


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("name", KERNELS)
def test_counter_charges_each_wrapper_by_its_cost(name, device):
    """One call: the kernel charged once at its analytic cost, the plain
    version's (or the meta branch's) tensor ops uncounted.  The backward
    without the forward's lse runs the forward first on the card, and so
    on meta: one more ``flash_attention`` charge there, none on the CPU."""
    fn, args = _cases()[name]
    if device == "meta":
        args = _meta(args)
    c = PCnt.step_costs(fn, *args)
    names = [name] + (["flash_attention"] if name == "flash_attention_bwd"
                      and device == "meta" else [])
    want = {n: {"launches": 1, "flops": CASE_COSTS[n].flops,
                "bytes": CASE_COSTS[n].bytes_accessed} for n in names}
    assert c.kernels == want
    assert c.by_op == {}
    assert c.flops == sum(w["flops"] for w in want.values())
    assert c.bytes == sum(w["bytes"] for w in want.values())
    assert ops.COUNTER is None


def test_counter_charges_the_attention_gradient():
    """Through autograd: one forward and one backward charge."""
    rng = np.random.default_rng(1)
    q = _rng_t(rng, 2, 8, 4, 64).requires_grad_(True)
    k = _rng_t(rng, 2, 8, 2, 64).requires_grad_(True)

    def fn(q, k):
        ops.flash_attention(q, k, k).sum().backward()
    c = PCnt.step_costs(fn, q, k)
    assert c.launches == {"flash_attention": 1, "flash_attention_bwd": 1}
    bwd = PM.flash_attention_bwd_cost(2, 4, 2, 8, 8, 64, 4, True, None, 0)
    assert c.kernels["flash_attention_bwd"]["flops"] == bwd.flops
    assert "aten.bmm" not in c.by_op and q.grad is not None


def _counted_step(cfg, device, tokens):
    if device == "cpu":
        model = PT.init_model(cfg, torch.Generator().manual_seed(0))
    else:
        model = PT.Transformer(cfg, device="meta")
    params = PT.train_params(model)
    opt = adam(1e-3)
    state = opt.init(params)
    batch = {"tokens": tokens.to(device), "labels": tokens.to(device)}
    return PCnt.step_costs(steps.make_train_step(model, opt), params, state, batch)


@pytest.mark.parametrize("arch,b,s", [("qwen3-4b", 2, 16), ("hymba-1.5b", 1, 64)])
def test_reduced_train_step_counts_alike_on_cpu_and_meta(arch, b, s):
    """The same step's FLOPs and kernel charges on the CPU (plain
    versions, values) and on meta (shape-only), and every aten op's bytes
    but the copies the CPU's plain attention adds: its output is a
    permuted view, where the kernel's (and the meta branch's) is
    contiguous, so ``reshape`` copies it on the CPU alone."""
    cfg = PC.reduced(PC.get(arch))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (b, s))
                              .astype(np.int32))
    cpu = _counted_step(cfg, "cpu", tokens)
    meta = _counted_step(cfg, "meta", tokens)
    assert cpu.kernels == meta.kernels
    assert cpu.flops == meta.flops
    none = {"calls": 0, "bytes": 0.0}
    copies = [c.by_op.pop("aten.clone", none) for c in (cpu, meta)]

    def moving(by_op):              # a copy's reshape also views otherwise
        return {k: v for k, v in by_op.items() if v["bytes"] or v["flops"]}
    assert moving(cpu.by_op) == moving(meta.by_op)
    assert copies[0]["calls"] >= copies[1]["calls"]
    assert cpu.bytes - copies[0]["bytes"] == meta.bytes - copies[1]["bytes"]
    n_attn = cfg.n_layers if cfg.has_attention else 0
    n_ssd = cfg.n_layers if cfg.has_ssm else 0
    want = {"flash_attention": n_attn, "flash_attention_bwd": n_attn,
            "ssd_chunk": n_ssd, "ssd_chunk_bwd": n_ssd}
    assert cpu.launches == {k: v for k, v in want.items() if v}
    assert math.isfinite(float(cpu.result[2]))
    assert meta.peak_bytes > meta.start_bytes > 0 and cpu.peak_bytes == 0
