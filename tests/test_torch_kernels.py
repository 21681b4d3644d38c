"""Port parity: the plain versions of the CUDA kernels against the JAX
reference (its non-Pallas oracles, and the flash-attention and SSD Pallas
kernels in interpret mode), and the ``ops`` wrappers' CPU routing and
checks.  tests/test_torch_cuda.py holds the kernels themselves against
these plain versions on a card."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import distribution as jdist                      # noqa: E402
from repro.core import fl as jfl                                  # noqa: E402
from repro.core import scheduling as jsched                       # noqa: E402
from repro.core.augmentation import warp_params                   # noqa: E402
from repro.kernels import ops as jops                             # noqa: E402
from repro.kernels import ref as jref                             # noqa: E402

from repro_torch.core import distribution as dist                 # noqa: E402
from repro_torch.core import scheduling                           # noqa: E402
from repro_torch.core.fl import weighted_average                  # noqa: E402
from repro_torch.kernels import ops, ref                          # noqa: E402


# ---------------------------------------------------------------- Eq. 6

@pytest.mark.parametrize("m,n", [(1, 7), (4, 300), (16, 1031)])
def test_fedavg_agg_matches_reference(m, n):
    rng = np.random.default_rng(m * 100 + n)
    d = rng.normal(size=(m, n)).astype(np.float32)
    w = (rng.random(m) * 10 + 0.1).astype(np.float32)
    w[-1] = 0.0 if m > 1 else w[-1]          # a zero-weight (dummy) row
    got = ops.fedavg_agg(torch.from_numpy(d), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, np.asarray(jref.fedavg_agg(jnp.asarray(d), jnp.asarray(w))),
                               rtol=1e-6, atol=1e-7)
    expect_wa = jfl.weighted_average({"x": jnp.asarray(d)}, jnp.asarray(w))["x"]
    np.testing.assert_allclose(got, np.asarray(expect_wa), rtol=1e-6, atol=1e-7)


def test_fedavg_agg_bf16_accumulates_in_fp32():
    rng = np.random.default_rng(5)
    d = torch.from_numpy(rng.normal(size=(6, 513)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.random(6).astype(np.float32))
    got = ops.fedavg_agg(d, w)
    assert got.dtype == torch.bfloat16
    wn = w / w.sum()
    expect = (wn[:, None].double() * d.double()).sum(0)
    # one bf16 rounding of the fp32 sum: within half a bf16 ulp (2^-8 rel)
    torch.testing.assert_close(got.double(), expect, rtol=2 ** -8, atol=1e-6)


def test_fedavg_agg_tree_fused_equals_per_leaf_and_weighted_average():
    rng = np.random.default_rng(7)
    tree = {"a": torch.from_numpy(rng.normal(size=(5, 3, 4)).astype(np.float32)),
            "b": torch.from_numpy(rng.normal(size=(5, 11)).astype(np.float32)),
            "c": torch.from_numpy(rng.normal(size=(5, 6)).astype(np.float32)
                                  ).to(torch.bfloat16)}
    w = torch.from_numpy(rng.random(5).astype(np.float32))
    fused = ops.fedavg_agg_tree(tree, w)
    assert list(fused) == list(tree)
    for k, leaf in tree.items():
        per_leaf = ops.fedavg_agg(leaf.reshape(5, -1), w).reshape(leaf.shape[1:])
        assert fused[k].dtype == leaf.dtype
        assert torch.equal(fused[k], per_leaf)
    wa = weighted_average({k: tree[k] for k in ("a", "b")}, w)
    for k in ("a", "b"):
        torch.testing.assert_close(fused[k], wa[k], rtol=1e-6, atol=1e-7)


def test_fedavg_agg_rejects_bad_inputs():
    with pytest.raises(ValueError):
        ops.fedavg_agg(torch.zeros(3, 4, dtype=torch.float64), torch.ones(3))
    with pytest.raises(ValueError):
        ops.fedavg_agg(torch.zeros(3, 4), torch.ones(2))
    with pytest.raises(ValueError):
        ops.fedavg_agg(torch.zeros(3, 4, device="meta"), torch.ones(3, device="meta"))


# ---------------------------------------------------------------- warp

_jax_warp = jax.jit(jref.affine_warp)
_jax_warp_params = jax.jit(lambda key: warp_params(key, 3))


# (H, W) of the rectangular cases: wide, tall, and a width no tile divides
RECT_SIZES = [(20, 36), (36, 20), (7, 13)]


@pytest.mark.parametrize("case", range(6))
def test_affine_warp_matches_map_coordinates(case):
    """Ten seeded batches per case (60 in all), including far out-of-bounds
    maps; cases 0-3 square images, 4-5 rectangular ones (H != W).  atol
    5e-5: the four-tap arithmetic and map_coordinates round the source
    coordinate in a different order."""
    worst = 0.0
    for j in range(10):
        seed = case * 10 + j
        rng = np.random.default_rng(seed)
        if case < 4:
            hw = [8, 16, 28][seed % 3]
            h, w = hw, hw
        else:
            h, w = RECT_SIZES[seed % 3]
        b, c = 3, [1, 3][seed % 2]
        scale = 0.5 + 2.0 * rng.random()
        imgs = rng.normal(size=(b, h, w, c)).astype(np.float32)
        mats, trans = _jax_warp_params(jax.random.PRNGKey(seed))
        mats = np.asarray(mats) * scale
        trans = np.asarray(trans) * scale
        expect = np.asarray(_jax_warp(jnp.asarray(imgs), jnp.asarray(mats),
                                      jnp.asarray(trans)))
        got = ops.affine_warp(torch.from_numpy(imgs), torch.from_numpy(mats),
                              torch.from_numpy(trans)).numpy()
        worst = max(worst, float(np.max(np.abs(got - expect))))
    assert worst <= 5e-5


def test_online_augment_batch_matches_reference_with_its_draws():
    """One padded client batch through Alg. 2's resample + warp, fed the
    reference's own categorical / uniform / warp draws."""
    from repro.core.augmentation import online_augment_batch as j_online
    from repro_torch.core.augmentation import online_augment_batch
    from torch_parity import aug_draws
    rng = np.random.default_rng(4)
    pad, nc = 30, 6
    x = rng.normal(size=(pad, 16, 16, 1)).astype(np.float32)
    y = rng.integers(0, nc, pad).astype(np.int32)
    m = (np.arange(pad) < 23).astype(np.float32)
    plan = np.array([0, 3, 1, 0, 2, 5], np.int32)
    key = jax.random.PRNGKey(9)
    ex, ey = jax.jit(lambda k: j_online(k, jnp.asarray(x), jnp.asarray(y),
                                        jnp.asarray(m), jnp.asarray(plan),
                                        impl="reference"))(key)
    w = m * (1.0 + plan[y]).astype(np.float32)
    draws = [torch.from_numpy(np.array(a)) for a in aug_draws(key, jnp.asarray(w), n=pad)]
    draws[0] = draws[0].long()
    gx, gy = online_augment_batch(torch.from_numpy(x), torch.from_numpy(y),
                                  torch.from_numpy(plan), draws)
    np.testing.assert_array_equal(gy.numpy(), np.asarray(ey))
    np.testing.assert_allclose(gx.numpy(), np.asarray(ex), rtol=0, atol=5e-5)


def test_warp_batch_is_the_kernel_on_its_draws():
    from repro_torch.core.augmentation import warp_batch, warp_params
    imgs = torch.from_numpy(np.random.default_rng(2).normal(size=(5, 12, 12, 2))
                            .astype(np.float32))
    out = warp_batch(imgs, generator=torch.Generator().manual_seed(3))
    mats, trans = warp_params(5, generator=torch.Generator().manual_seed(3))
    assert torch.equal(out, ops.affine_warp(imgs, mats, trans))


def test_affine_warp_identity_and_checks():
    img = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 9, 7, 2)).astype(np.float32))
    eye = torch.eye(2).expand(2, 2, 2).contiguous()
    assert torch.equal(ops.affine_warp(img, eye, torch.zeros(2, 2)), img)
    with pytest.raises(ValueError):
        ops.affine_warp(img, eye[:1], torch.zeros(2, 2))
    with pytest.raises(ValueError):
        ops.affine_warp(img.double(), eye.double(), torch.zeros(2, 2).double())


# ---------------------------------------------------------------- Alg. 3

def test_merged_kld_scores_match_reference():
    rng = np.random.default_rng(3)
    med = rng.integers(0, 30, 47).astype(np.float32)
    cand = rng.integers(0, 30, (64, 47)).astype(np.float32)
    cand[3] = 0.0
    expect = np.asarray(jdist.merged_kld_scores(jnp.asarray(med), jnp.asarray(cand)))
    got = dist.merged_kld_scores(torch.from_numpy(med), torch.from_numpy(cand)).numpy()
    np.testing.assert_allclose(got, expect, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        dist.kld_to_uniform(torch.from_numpy(cand)).numpy(),
        np.asarray(jdist.kld_to_uniform(jnp.asarray(cand))), rtol=1e-6, atol=1e-7)
    labels = rng.integers(0, 47, 200)
    mask = (rng.random(200) < 0.7).astype(np.float32)
    np.testing.assert_array_equal(
        dist.class_histogram(torch.from_numpy(labels), 47, torch.from_numpy(mask)).numpy(),
        np.asarray(jdist.class_histogram(jnp.asarray(labels), 47, jnp.asarray(mask))))


# every case has K = 8 clients over 8 or 47 classes: the reference loop
# scores eagerly, and a fixed set of shapes keeps its compiles cached
K = 8


def _cases():
    rng = np.random.default_rng(11)
    cases = []
    for i in range(6):                                   # random histograms
        c = (8, 47)[i % 2]
        cases.append((rng.integers(0, 60, (K, c)), int(rng.integers(1, 6))))
    for i in range(4):                                   # permuted duplicates
        base = rng.integers(0, 40, (3, 8))
        cases.append((np.stack([rng.permutation(base[j % 3]) for j in range(K)]),
                      int(rng.integers(2, 5))))
    cases.append((np.tile(rng.integers(1, 9, (1, 8)), (K, 1)), 3))     # all tied
    cases.append((np.zeros((K, 8)), 2))                                  # empty
    return cases


@pytest.mark.parametrize("case", range(12))
def test_greedy_picks_match_reference_loop(case):
    """Port picks (batched plain pass and loop) vs the reference's numpy
    loop.  Where the lists diverge, the two candidates tie in float64."""
    counts, gamma = _cases()[case]
    expect = jsched.reschedule(counts, gamma, impl="loop")
    picks_ref = np.array([c for m in expect for c in m.clients])
    for impl in ("batched", "loop"):
        got = scheduling.reschedule(counts, gamma, impl=impl, device="cpu")
        assert [len(m.clients) for m in got] == [len(m.clients) for m in expect]
        div = scheduling.first_divergence(counts, gamma, picks_ref,
                                          scheduling.picks_of(got))
        assert div is None or div["tie"], div
        if div is None:
            for a, b in zip(got, expect):
                np.testing.assert_array_equal(a.counts, b.counts)


def test_greedy_random_cases_match_strictly():
    """Random integer histograms have no float64 ties: strict equality."""
    rng = np.random.default_rng(5)
    for _ in range(10):
        counts = rng.integers(0, 100, (K, 47))
        expect = jsched.reschedule(counts, 4, impl="loop")
        got = scheduling.reschedule(counts, 4, impl="batched", device="cpu")
        assert [m.clients for m in got] == [m.clients for m in expect]


@pytest.mark.parametrize("gamma", [1, 4, 9])
def test_greedy_picks_above_a_thousand_classes_match_reference_loop(gamma):
    """C = 1,100 classes, K = 8 clients: the wrapper's pass equals the
    reference's numpy loop exactly; gamma 9 > K never closes a mediator
    early."""
    counts = np.random.default_rng(gamma).integers(0, 30, (K, 1100))
    expect = jsched.reschedule(counts, gamma, impl="loop")
    picks = ops.kld_greedy_picks(torch.as_tensor(counts, dtype=torch.float32), gamma)
    assert picks.tolist() == [c for m in expect for c in m.clients]


def test_all_tied_picks_are_in_client_order():
    counts = np.ones((10, 4))
    picks = ops.kld_greedy_picks(torch.ones(10, 4), 3)
    np.testing.assert_array_equal(picks.numpy(), np.arange(10))
    assert picks.dtype == torch.int32
    assert [m.clients for m in scheduling.reschedule(counts, 3, impl="loop",
                                                      device="cpu")] \
        == [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9]]


def test_first_divergence_flags_real_disagreements():
    counts = np.array([[5, 0], [0, 5], [3, 3]], float)
    assert scheduling.first_divergence(counts, 3, [2, 0, 1], [2, 0, 1]) is None
    div = scheduling.first_divergence(counts, 3, [2, 0, 1], [0, 2, 1])
    assert div["step"] == 0 and not div["tie"]
    div = scheduling.first_divergence(counts, 3, [2, 0, 1], [2, 1, 0])
    assert div["step"] == 1 and div["tie"]


def test_schedule_stats_and_random_schedule_match_reference():
    rng = np.random.default_rng(9)
    counts = rng.integers(0, 50, (13, 8))
    got = scheduling.random_schedule(13, 4, counts, seed=3)
    expect = jsched.random_schedule(13, 4, counts, seed=3)
    assert [m.clients for m in got] == [m.clients for m in expect]
    s_got, s_exp = scheduling.schedule_stats(got), jsched.schedule_stats(expect)
    assert s_got.keys() == s_exp.keys()
    for k in s_got:
        assert s_got[k] == pytest.approx(s_exp[k], rel=1e-6)


def test_greedy_wrapper_checks():
    with pytest.raises(ValueError):
        ops.kld_greedy_picks(torch.ones(4, 3, dtype=torch.float64), 2)
    with pytest.raises(ValueError):
        ops.kld_greedy_picks(torch.ones(4, 3), 0)
    with pytest.raises(ValueError):
        scheduling.reschedule(np.ones((3, 2)), 2, impl="scan", device="cpu")


def test_cpu_calls_launch_nothing():
    ops.reset_launches()
    ops.fedavg_agg(torch.ones(2, 3), torch.ones(2))
    ops.kld_greedy_picks(torch.ones(3, 2), 2)
    ops.kld_score(torch.ones(2), torch.ones(3, 2))
    ops.kld_score_matrix(torch.ones(4, 2), torch.ones(3, 2))
    ops.affine_warp(torch.ones(1, 4, 4, 1), torch.eye(2)[None], torch.zeros(1, 2))
    ops.flash_attention(torch.ones(1, 3, 2, 64), torch.ones(1, 3, 1, 64),
                        torch.ones(1, 3, 1, 64))
    ops.flash_attention_bwd(torch.ones(1, 3, 2, 64), torch.ones(1, 3, 1, 64),
                            torch.ones(1, 3, 1, 64), torch.ones(1, 3, 2, 64),
                            torch.ones(1, 3, 2, 64))
    ops.ssd_chunk(torch.ones(1, 1, 4, 1, 2), torch.ones(1, 1, 4, 1), -torch.ones(1),
                  torch.ones(1, 1, 4, 3), torch.ones(1, 1, 4, 3))
    ops.ssd_chunk_bwd(torch.ones(1, 1, 4, 1, 2), torch.ones(1, 1, 4, 1), -torch.ones(1),
                      torch.ones(1, 1, 4, 3), torch.ones(1, 1, 4, 3), torch.ones(1, 1, 4, 1, 2),
                      torch.ones(1, 1, 1, 3, 2), torch.ones(1, 1, 1))
    assert ops.LAUNCHES == {"fedavg_agg": 0, "kld_greedy_picks": 0, "kld_score": 0,
                            "kld_score_matrix": 0, "affine_warp": 0,
                            "flash_attention": 0, "flash_attention_bwd": 0,
                            "ssd_chunk": 0, "ssd_chunk_bwd": 0}


# ---------------------------------------------------------------- attention

def _attn_inputs(seed, b, sq, skv, h, kv, d=64, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, skv, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, skv, kv, d)).astype(np.float32)
    return q, k, v


# (b, sq, skv, H, KV, causal, window, q_offset): causal, window, q_offset,
# GQA 2:1 and 1:1, ragged lengths (not multiples of the kernel's 64-row
# tiles); s <= 128 because the Pallas kernel runs in interpret mode
FLASH_CASES = [
    (1, 64, 64, 2, 2, True, None, 0),
    (2, 96, 96, 4, 2, True, 16, 0),
    (1, 100, 100, 4, 2, True, 33, 0),
    (1, 50, 50, 2, 1, False, None, 0),
    (1, 32, 96, 4, 2, True, None, 64),
    (2, 40, 120, 4, 2, True, 24, 80),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_reference(case):
    """The wrapper's plain version (model layout, KV heads mapped by index)
    against the Pallas kernel in interpret mode through the reference's GQA
    wrapper, and against the reference's oracle in kernel layout.  fp32:
    the sums run in other orders, |err| <= 2e-6 on unit-scale inputs."""
    b, sq, skv, h, kv, causal, window, off = case
    q, k, v = _attn_inputs(sq + skv, b, sq, skv, h, kv)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal, window=window,
                              q_offset=off).numpy()
    pallas = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal, window=window, q_offset=off)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=0, atol=2e-6)
    rep = h // kv
    kr, vr = (jnp.repeat(jnp.asarray(t), rep, axis=2) for t in (k, v))
    oracle = jref.flash_attention(jnp.swapaxes(jnp.asarray(q), 1, 2), jnp.swapaxes(kr, 1, 2),
                                  jnp.swapaxes(vr, 1, 2), causal=causal, window=window,
                                  q_offset=off)
    np.testing.assert_allclose(got, np.asarray(jnp.swapaxes(oracle, 1, 2)), rtol=0,
                               atol=2e-6)


# (b, sq, skv, H, KV, causal, window, q_offset) at head dims the card's
# kernel is not built for (96) and gemma's 256: MQA 4:1, a window, a
# q_offset, no causal mask, lengths not multiples of 64
ANY_D_FLASH_CASES = [
    (1, 100, 100, 4, 1, True, None, 0),
    (2, 96, 96, 4, 1, True, 24, 0),
    (1, 40, 120, 4, 1, True, 33, 80),
    (1, 50, 50, 4, 2, False, None, 0),
]


@pytest.mark.parametrize("d", [256, 96])
@pytest.mark.parametrize("case", ANY_D_FLASH_CASES)
def test_flash_attention_any_head_dim_matches_reference(case, d):
    """On the CPU the wrapper takes any head dim, as the reference does:
    its plain version against the Pallas kernel in interpret mode, fp32,
    within 1e-5 of the output's scale."""
    b, sq, skv, h, kv, causal, window, off = case
    q, k, v = _attn_inputs(sq + skv + d, b, sq, skv, h, kv, d)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal, window=window,
                              q_offset=off).numpy()
    pallas = np.asarray(jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             causal=causal, window=window, q_offset=off))
    scale = max(float(np.abs(pallas).max()), 1.0)
    assert got.shape == (b, sq, h, d)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5 * scale)


def test_flash_attention_bf16_matches_reference_kernel():
    """bf16 in and out, fp32 inside in both: the two fp32 results may round
    to neighbouring bf16 values, so |err| <= one bf16 ulp of the output
    (2^-7 relative to the largest output)."""
    q, k, v = _attn_inputs(3, 2, 96, 96, 4, 2)
    tq, tk, tv = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=True, window=40)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (tq, tk, tv))
    pallas = np.asarray(jops.flash_attention(jq, jk, jv, causal=True, window=40),
                        np.float32)
    scale = np.abs(pallas).max()
    np.testing.assert_allclose(got.float().numpy(), pallas, rtol=0, atol=2 ** -7 * scale)


def _online_flash(q, k, v, *, causal, window, q_offset, tile, bf16_p):
    """A card kernel's arithmetic, emulated here: fp32 ``q.k^T`` scaled by
    ``1/sqrt(d)``, online softmax over ``tile``-key tiles in key order with
    fp32 running max, denominator and accumulator, ``l`` summed from the
    unrounded ``p``; ``bf16_p`` rounds ``P`` to bf16 before ``P.V`` (the
    tensor-core kernel), else ``P.V`` stays fp32 (the CUDA-core kernel).
    Returns fp32."""
    b, sq, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, sq, kv, h // kv, d)
    kf, vf = k.float(), v.float()
    mask = ref.attention_mask(sq, skv, causal=causal, window=window,
                              q_offset=q_offset, device="cpu")
    m = torch.full((b, kv, h // kv, sq), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(b, kv, h // kv, sq, d)
    for k0 in range(0, skv, tile):
        vis = mask[:, k0:k0 + tile]
        s = torch.einsum("bqgrd,bkgd->bgrqk", qf, kf[:, k0:k0 + tile]) / math.sqrt(d)
        s = torch.where(vis, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.where(vis, torch.exp(s - m_new[..., None]), 0.0)
        l = l * corr + p.sum(-1)
        pv = p.to(torch.bfloat16).float() if bf16_p else p
        acc = acc * corr[..., None] + torch.einsum("bgrqk,bkgd->bgrqd", pv,
                                                   vf[:, k0:k0 + tile])
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)


def _tensor_core_flash(q, k, v, *, causal, window, q_offset, tile):
    """The bf16 card kernel's arithmetic: bf16 inputs, ``P`` rounded to bf16
    before ``P.V``, bf16 output."""
    return _online_flash(q, k, v, causal=causal, window=window, q_offset=q_offset,
                         tile=tile, bf16_p=True).to(torch.bfloat16)


# FLASH_CASES at d=64, plus head dims 80, 128 and 256 (window, q_offset, GQA 4:1, MQA)
TC_FLASH_CASES = [(*c, 64) for c in FLASH_CASES] + [
    (1, 100, 100, 4, 2, True, 33, 0, 80),
    (1, 90, 90, 2, 2, True, 40, -7, 80),
    (2, 70, 130, 4, 1, True, None, 60, 128),
    (1, 130, 130, 8, 1, True, None, 0, 256),
    (1, 70, 150, 4, 2, True, 50, 80, 256),
]


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("case", TC_FLASH_CASES)
def test_tensor_core_flash_numerics_within_card_tolerance(case, tile):
    """The card's bf16 tolerance, 2^-7 * max(|plain|, 1), admits the
    tensor-core kernel's arithmetic (P rounded to bf16 before P.V) against
    the plain version ``ref.flash_attention``, on three seeds."""
    b, sq, skv, h, kv, causal, window, off, d = case
    kw = dict(causal=causal, window=window, q_offset=off)
    for seed in range(3):
        q, k, v = (torch.from_numpy(t).to(torch.bfloat16)
                   for t in _attn_inputs(seed, b, sq, skv, h, kv, d))
        got = _tensor_core_flash(q, k, v, tile=tile, **kw)
        plain = ref.flash_attention(q, k, v, **kw)
        err = float((got.double() - plain.double()).abs().max())
        assert err <= 2 ** -7 * max(float(plain.double().abs().max()), 1.0), (seed, err)


# FLASH_CASES at d=64, ANY_D_FLASH_CASES at gemma's d=256, and d=80 and 128
# rows (window, q_offset, GQA 4:1, MQA)
F32_FLASH_CASES = [(*c, 64) for c in FLASH_CASES] + [(*c, 256) for c in ANY_D_FLASH_CASES] + [
    (1, 100, 100, 4, 2, True, 33, 0, 80),
    (1, 90, 90, 2, 2, True, 40, -7, 80),
    (2, 70, 120, 4, 1, True, None, 50, 128),
]


@pytest.mark.parametrize("case", F32_FLASH_CASES)
def test_cuda_core_flash_numerics_within_card_tolerance(case):
    """The fp32 card kernel's arithmetic (online softmax over its 64-key
    tiles in key order, fp32 throughout) against the reference's Pallas
    kernel in interpret mode, within the card's fp32 tolerance 1e-5 *
    max(|out|, 1)."""
    b, sq, skv, h, kv, causal, window, off, d = case
    q, k, v = _attn_inputs(sq + skv + d, b, sq, skv, h, kv, d)
    got = _online_flash(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        causal=causal, window=window, q_offset=off, tile=64,
                        bf16_p=False).numpy()
    pallas = np.asarray(jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             causal=causal, window=window, q_offset=off))
    assert got.shape == pallas.shape == (b, sq, h, d)
    np.testing.assert_allclose(got, pallas, rtol=0,
                               atol=1e-5 * max(float(np.abs(pallas).max()), 1.0))


def test_flash_attention_row_without_keys_is_zero():
    q, k, v = (torch.from_numpy(t) for t in _attn_inputs(4, 1, 8, 8, 2, 2))
    out = ops.flash_attention(q, k, v, causal=True, q_offset=-4)
    assert torch.equal(out[:, :4], torch.zeros_like(out[:, :4]))
    assert torch.isfinite(out).all() and out[:, 4:].abs().sum() > 0


def test_flash_attention_wrapper_checks():
    q, k, v = (torch.from_numpy(t) for t in _attn_inputs(5, 1, 8, 8, 4, 2))
    # head dim 32: the CPU takes any head dim (the card raises, see
    # tests/test_torch_cuda.py)
    q32, k32, v32 = q[..., :32].contiguous(), k[..., :32].contiguous(), v[..., :32].contiguous()
    assert torch.equal(ops.flash_attention(q32, k32, v32), ref.flash_attention(q32, k32, v32))
    with pytest.raises(ValueError):                     # 4 heads over 3 KV heads
        ops.flash_attention(q, torch.cat([k, k[:, :, :1]], 2), torch.cat([v, v[:, :, :1]], 2))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k.double(), v.double())
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v[:, :4])


# ---------------------------------------------------------------- SSD chunk

def _ssd_inputs(seed, b=2, nc=3, L=32, h=4, p=16, n=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, nc, L, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, nc, L, h)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(h,)) * 0.3)).astype(np.float32)
    B = (rng.normal(size=(b, nc, L, n)) * 0.5).astype(np.float32)
    C = (rng.normal(size=(b, nc, L, n)) * 0.5).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("L,h,p,n", [(8, 1, 8, 8), (16, 3, 64, 32), (64, 2, 64, 16),
                                     (32, 4, 16, 8)])
def test_ssd_chunk_matches_reference(L, h, p, n):
    """Plain ``ssd_chunk`` against the Pallas kernel in interpret mode and
    the reference's oracle, fp32: relative 3e-5 of each output's scale
    (sums in another order; exp of the rounded segment sums)."""
    arrays = _ssd_inputs(L * 100 + h, L=L, h=h, p=p, n=n)
    got = ops.ssd_chunk(*(torch.from_numpy(a) for a in arrays))
    for want in (jops.ssd_chunk(*map(jnp.asarray, arrays)),
                 jref.ssd_chunk(*map(jnp.asarray, arrays))):
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.shape == w.shape and g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=3e-5 * max(np.abs(w).max(), 1.0))


def test_ssd_chunk_bf16_inputs_match_reference():
    """bf16 x, B, C (fp32 dt, A), as tests/test_ssd_kernel.py feeds the
    Pallas kernel: y_diag in bf16 within one bf16 ulp of the largest
    output, S and g fp32 within 3e-5 relative."""
    x, dt, A, B, C = _ssd_inputs(11)
    tx, tB, tC = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, B, C))
    y, S, g = ops.ssd_chunk(tx, torch.from_numpy(dt), torch.from_numpy(A), tB, tC)
    assert y.dtype == torch.bfloat16 and S.dtype == torch.float32
    jx, jB, jC = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (tx, tB, tC))
    yr, Sr, gr = (np.asarray(t, np.float32)
                  for t in jops.ssd_chunk(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC))
    np.testing.assert_allclose(y.float().numpy(), yr, rtol=0,
                               atol=2 ** -7 * np.abs(yr).max())
    np.testing.assert_allclose(S.numpy(), Sr, rtol=0, atol=3e-5 * np.abs(Sr).max())
    np.testing.assert_allclose(g.numpy(), gr, rtol=3e-5, atol=0)


def test_ssd_chunk_decay_stays_finite_for_steep_segments():
    """Segment sums far below -88 (exp underflow) and above +88 on the
    upper triangle must leave every output finite."""
    x, dt, A, B, C = _ssd_inputs(12)
    dt = dt * 400.0
    y, S, g = ops.ssd_chunk(*(torch.from_numpy(a) for a in (x, dt, A, B, C)))
    assert all(torch.isfinite(t).all() for t in (y, S, g))


def test_ssd_chunk_wrapper_checks():
    """Shapes, dtypes, and the shared-memory check: the kernel's least
    layout (one fp32 x stage, C B^T recomputed per head) takes a little
    less than the per-head kernel did for L and n that are multiples of 8
    (the Hymba block 45,568 B against 45,824; (128, 128, 64) 230,400 B
    against 230,912, just under 227 KB); a shape over 227 KB is
    refused."""
    assert ops.ssd_chunk_smem_bytes(64, 64, 16) == 45_568
    assert ops.ssd_chunk_smem_bytes(128, 128, 64) == 230_400 <= ops.MAX_SMEM_BYTES
    assert ops.ssd_chunk_smem_bytes(256, 8, 8) > ops.MAX_SMEM_BYTES
    x, dt, A, B, C = (torch.from_numpy(a) for a in _ssd_inputs(13))
    with pytest.raises(ValueError):
        ops.ssd_chunk(x, dt.double(), A, B, C)
    with pytest.raises(ValueError):
        ops.ssd_chunk(x, dt, A, B.bfloat16(), C)
    with pytest.raises(ValueError):
        ops.ssd_chunk(x, dt[..., :2], A, B, C)
    with pytest.raises(ValueError):                     # (L, L) decay over 227 KB
        big = torch.zeros(1, 1, 256, 1, 8)
        ops.ssd_chunk(big, torch.zeros(1, 1, 256, 1), A[:1], torch.zeros(1, 1, 256, 8),
                      torch.zeros(1, 1, 256, 8))


def test_ssd_chunk_padding_near_the_limit():
    """p is padded to 4 only, so (L, p, n) = (128, 130, 64) fits in exactly
    227 KB and runs; n is padded to 8, so (128, 136, 60), which the per-head
    kernel took in 228,864 B, needs 234,496 B and is refused."""
    assert ops.ssd_chunk_smem_bytes(128, 130, 64) == ops.MAX_SMEM_BYTES == 232_448
    x, dt, A, B, C = (torch.from_numpy(a) for a in _ssd_inputs(14, b=1, nc=1, L=128, h=1,
                                                                 p=130, n=64))
    y, S, g = ops.ssd_chunk(x, dt, A, B, C)
    assert y.shape == x.shape and S.shape == (1, 1, 1, 64, 130) and g.shape == (1, 1, 1)
    assert ops.ssd_chunk_smem_bytes(128, 136, 60) == 234_496 > ops.MAX_SMEM_BYTES
    x, dt, A, B, C = (torch.from_numpy(a) for a in _ssd_inputs(15, b=1, nc=1, L=128, h=1,
                                                                 p=136, n=60))
    with pytest.raises(ValueError):
        ops.ssd_chunk(x, dt, A, B, C)


def _ssd_cotangents(seed, x, S, g):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=t.shape).astype(np.float32) for t in (x, S, g))


# (b, nc, L, h, p, n): L 16 and 64, n 8 and 128, L, p and n that are not
# multiples of 8, and the reduced configs' block (L 64, p 32, n 16)
SSD_BWD_CASES = [(2, 3, 16, 3, 8, 8), (1, 2, 64, 2, 16, 128), (2, 2, 30, 3, 10, 6),
                 (1, 1, 64, 4, 32, 16)]


@pytest.mark.parametrize("b,nc,L,h,p,n", SSD_BWD_CASES)
def test_ssd_chunk_bwd_matches_reference_vjp(b, nc, L, h, p, n):
    """``ref.ssd_chunk_bwd`` from its formulas against ``jax.vjp`` of the
    reference's oracle on the same inputs and cotangents, fp32: dx, ddt, dB
    and dC within 1e-5 of each gradient's scale (sums in other orders;
    measured 2e-6 at worst), dA within 1e-4 (a sum of b nc L terms of both
    signs: torch's own autograd through ``ref.ssd_chunk`` is 1.3e-5 of its
    scale away from the reference's)."""
    arrays = _ssd_inputs(L + n, b=b, nc=nc, L=L, h=h, p=p, n=n)
    y, S, g = jref.ssd_chunk(*map(jnp.asarray, arrays))
    cot = _ssd_cotangents(L * n, y, S, g)
    _, vjp = jax.vjp(jref.ssd_chunk, *map(jnp.asarray, arrays))
    want = vjp(tuple(map(jnp.asarray, cot)))
    got = ref.ssd_chunk_bwd(*(torch.from_numpy(a) for a in arrays + cot))
    for name, gr, w, rel in zip(("dx", "ddt", "dA", "dB", "dC"), got, want,
                                (1e-5, 1e-5, 1e-4, 1e-5, 1e-5)):
        w = np.asarray(w)
        assert gr.shape == w.shape and gr.dtype == torch.float32, name
        np.testing.assert_allclose(gr.numpy(), w, rtol=0, atol=rel * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("dtype,dt_scale", [(torch.float32, 1.0), (torch.float32, 400.0),
                                            (torch.bfloat16, 1.0)])
def test_ssd_chunk_grads_match_autograd_of_plain_version(dtype, dt_scale):
    """``ops.ssd_chunk`` with inputs that require grad goes through
    ``_SSDChunk`` (the plain forward, ``ref.ssd_chunk_bwd``) on the CPU: its
    fp32 gradients equal torch autograd through ``ref.ssd_chunk`` in
    float64 on the same values within 1e-5 of each gradient's scale, dA
    within 1e-4 (bf16 x, B and C: gradients in bf16, 2^-7), also where the
    segment sums reach far below -88 (``dt`` 400 times larger), every
    gradient finite.  The float64 yardstick, not fp32 autograd: there
    autograd's dA is 2.9e-2 of its scale off (the diagonal of G and the
    chunk's last H cancel in its dcum; ``ref.ssd_chunk_bwd`` leaves them
    out and sums cum in float64: 1.8e-5)."""
    x, dt, A, B, C = _ssd_inputs(21)
    arrays = (x, dt * np.float32(dt_scale), A, B, C)
    y, S, g = ref.ssd_chunk(*(torch.from_numpy(a) for a in arrays))
    cot = [torch.from_numpy(c) for c in _ssd_cotangents(22, y, S, g)]
    cot[0] = cot[0].to(dtype)
    mine = [torch.from_numpy(a).to(dtype if i in (0, 3, 4) else torch.float32)
            .requires_grad_(True) for i, a in enumerate(arrays)]
    out = ops.ssd_chunk(*mine)
    assert type(out[0].grad_fn).__name__ == "_SSDChunkBackward"
    got = torch.autograd.grad(out, mine, cot)
    exact = [t.detach().double().requires_grad_(True) for t in mine]
    want = torch.autograd.grad(ref.ssd_chunk(*exact), exact, [c.double() for c in cot])
    for i, (gr, w) in enumerate(zip(got, want)):
        assert gr.dtype == mine[i].dtype and bool(torch.isfinite(gr.float()).all())
        rel = 2 ** -7 if gr.dtype == torch.bfloat16 else (1e-4 if i == 2 else 1e-5)
        err = float((gr.double() - w).abs().max())
        assert err <= rel * float(w.abs().max()), (i, err)


def test_ssd_chunk_grads_only_where_needed():
    """The backward returns None for an input that does not require grad
    (a frozen ``A``), and a call without grad stays the plain forward."""
    x, dt, A, B, C = (torch.from_numpy(a) for a in _ssd_inputs(23))
    xg = x.clone().requires_grad_(True)
    out = ops.ssd_chunk(xg, dt, A, B, C)
    grads = out[0].grad_fn.apply(*(torch.ones_like(t) for t in out))
    assert grads[0] is not None and grads[0].shape == x.shape
    assert all(gr is None for gr in grads[1:])
    with torch.no_grad():
        assert ops.ssd_chunk(xg, dt, A, B, C)[0].grad_fn is None


def _tf32(a: np.ndarray) -> np.ndarray:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest, ties away from
    zero (``cvt.rna.tf32.f32``)."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _ssd_bwd_products(n: int) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """The SSD backward kernel's matrix products at a head of L = 64, p =
    64 and state n, as (left, right) fp32 operands from seeded inputs at
    Mamba-2's scales: B dS and P^T dy (dx), dy x^T (dM'), dS x^T (dW^T),
    C B^T, dCB B (dC) and dCB^T C (dB)."""
    L, p = 64, 64
    rng = np.random.default_rng(n)
    x, dy = (rng.normal(size=(L, p)).astype(np.float32) for _ in range(2))
    dS = rng.normal(size=(n, p)).astype(np.float32)
    B, C = ((0.5 * rng.normal(size=(L, n))).astype(np.float32) for _ in range(2))
    cum = np.cumsum(-np.log1p(np.exp(rng.normal(size=L))))
    P = (np.tril(C.astype(np.float64) @ B.T.astype(np.float64)
                 * np.exp(np.minimum(cum[:, None] - cum[None, :], 0.0)))).astype(np.float32)
    dCB = np.tril(rng.normal(size=(L, L))).astype(np.float32)
    return {"B dS": (B, dS), "P^T dy": (P.T, dy), "dy x^T": (dy, x.T), "dS x^T": (dS, x.T),
            "C B^T": (C, B.T), "dCB B": (dCB, B), "dCB^T C": (dCB.T, C)}


@pytest.mark.parametrize("n", [16, 128])
@pytest.mark.parametrize("product", ["B dS", "P^T dy", "dy x^T", "dS x^T", "C B^T", "dCB B",
                                     "dCB^T C"])
def test_ssd_bwd_split_fp32_products_keep_fp32_accuracy(n, product):
    """Why the backward kernel splits its tensor-core operands: at Hymba's
    (n = 16) and mamba2-370m's (n = 128) head shapes each product in TF32
    with fp32 sums, as ``mma.sync`` forms it, against float64.  Split (each
    operand a TF32 big part plus the TF32 rounding of its remainder; big.big
    + big.small + small.big, small terms first) stays ten times under the
    kernels' 1e-5 of the product's scale; one pass of TF32 exceeds 1e-5."""
    a, b = _ssd_bwd_products(n)[product]
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = float(np.abs(exact).max())
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    split = (a_small @ b_big + a_big @ b_small).astype(np.float32) + a_big @ b_big
    single = _tf32(a) @ _tf32(b)
    assert split.dtype == single.dtype == np.float32
    assert float(np.abs(split - exact).max()) <= 1e-6 * scale
    assert float(np.abs(single - exact).max()) > 1e-5 * scale


def test_ssd_chunk_bwd_wrapper_checks():
    """Output-gradient shapes and dtypes; the backward kernel's shared
    memory in its least layout (one head stage): the Hymba block 74,080 B,
    mamba2-370m's (L 64, p 64, n 128) 160,096 B; a chunk the forward takes
    but the backward does not hold is refused when a gradient is asked for,
    before the forward runs."""
    assert ops.ssd_chunk_bwd_smem_bytes(64, 64, 16) == 74_080
    assert ops.ssd_chunk_bwd_smem_bytes(64, 64, 128) == 160_096 <= ops.MAX_SMEM_BYTES
    assert ops.ssd_chunk_bwd_smem_bytes(128, 128, 64) > ops.MAX_SMEM_BYTES
    x, dt, A, B, C = (torch.from_numpy(a) for a in _ssd_inputs(24))
    y, S, g = ops.ssd_chunk(x, dt, A, B, C)
    with pytest.raises(ValueError):
        ops.ssd_chunk_bwd(x, dt, A, B, C, y, S[..., :1], g)
    with pytest.raises(ValueError):
        ops.ssd_chunk_bwd(x, dt, A, B, C, y, S, g.double())
    with pytest.raises(ValueError):
        ops.ssd_chunk_bwd(x, dt, A, B, C, y.bfloat16(), S, g)
    big = [torch.zeros(1, 1, 128, 1, 128, requires_grad=True), torch.zeros(1, 1, 128, 1),
           -torch.ones(1), torch.zeros(1, 1, 128, 64), torch.zeros(1, 1, 128, 64)]
    ops.reset_launches()
    with pytest.raises(ValueError, match="backward"):
        ops.ssd_chunk(*big)
    with torch.no_grad():
        assert ops.ssd_chunk(*big)[0].shape == big[0].shape
