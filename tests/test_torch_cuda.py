"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports torch and the port only (no JAX), so it runs on a GPU machine:

    python -m pytest -m cuda tests/test_torch_cuda.py

Without a CUDA device every test here skips: the kernels have no CPU mode.
"""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch import configs                                   # noqa: E402
from repro_torch.core import scheduling                           # noqa: E402
from repro_torch.kernels import ops, ref                          # noqa: E402
from repro_torch.models import transformer as T                   # noqa: E402


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-6), (torch.bfloat16, 2 ** -7)])
@pytest.mark.parametrize("n", [68_873, 1 << 16])
def test_fedavg_agg_kernel(dev, dtype, rtol, n):
    """One launch from the raw weights; every N takes the vector body (odd N
    realigns each row's 16-byte loads by a warp shuffle)."""
    g = torch.Generator(device=dev).manual_seed(0)
    d = torch.randn(16, n, generator=g, device=dev).to(dtype)
    w = torch.rand(16, generator=g, device=dev)
    before = ops.LAUNCHES["fedavg_agg"]
    out = ops.fedavg_agg(d, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fedavg_agg"] == before + 1
    torch.testing.assert_close(out.double(), ref.fedavg_agg(d, w).double(),
                               rtol=rtol, atol=1e-6)


def _device_kernels_per_call(fn) -> int:
    """Device kernels in one call of ``fn``, counted as kernel nodes of a
    CUDA graph of the call (the profiler dropped kernels now and then)."""
    from repro_torch.examples.kernel_times import graph_kernel_count
    return graph_kernel_count(fn)


# N = 0..3 mod 4 (f32 rows), 0..7 mod 8 (bf16 rows), and the main paths'
# widths (EMNIST 68,873 = 1 mod 4, CINIC 2,168,362 = 2 mod 4)
FEDAVG_WIDTHS = [64, 65, 66, 67, *range(1032, 1040), 68_873, 2_168_362]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("n", FEDAVG_WIDTHS)
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-6), (torch.bfloat16, 2 ** -7)])
def test_fedavg_agg_kernel_every_width(dev, dtype, rtol, n, offset):
    """M = 7 rows (one 4-row batch and a remainder), a zero-weight row, and
    a deltas view ``offset`` elements into its buffer (offset 1 and 3 start
    it off a 16-byte boundary): within the plain version's tolerance."""
    g = torch.Generator(device=dev).manual_seed(n + offset)
    buf = torch.randn(7 * n + offset, generator=g, device=dev).to(dtype)
    d = buf[offset:].view(7, n)
    assert (d.data_ptr() % 16 != 0) == (offset != 0)
    w = torch.rand(7, generator=g, device=dev)
    w[2] = 0.0
    out = ops.fedavg_agg(d, w)
    torch.testing.assert_close(out.double(), ref.fedavg_agg(d, w).double(),
                               rtol=rtol, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [68_873, 2_168_362])
def test_fedavg_agg_is_one_kernel_per_call(dev, n):
    d = torch.randn(16, n, device=dev)
    w = torch.rand(16, device=dev)
    before = ops.LAUNCHES["fedavg_agg"]
    assert _device_kernels_per_call(lambda: ops.fedavg_agg(d, w)) == 1
    assert ops.LAUNCHES["fedavg_agg"] == before + 2     # the warm-up and the captured call


@pytest.mark.cuda
def test_fedavg_agg_tree_fused_equals_per_leaf_on_card(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    tree = {"a": torch.randn(4, 3, 5, generator=g, device=dev),
            "b": torch.randn(4, 17, generator=g, device=dev)}
    w = torch.rand(4, generator=g, device=dev)
    fused = ops.fedavg_agg_tree(tree, w)
    for k, leaf in tree.items():
        assert torch.equal(fused[k], ops.fedavg_agg(leaf.reshape(4, -1), w)
                           .reshape(leaf.shape[1:]))


@pytest.mark.cuda
@pytest.mark.parametrize("k,tied", [(16, False), (300, False), (64, True)])
def test_kld_greedy_kernel(dev, k, tied):
    rng = np.random.default_rng(k)
    counts = np.tile(rng.integers(1, 9, (1, 47)), (k, 1)) if tied \
        else rng.integers(0, 60, (k, 47))
    t = torch.as_tensor(counts, dtype=torch.float32, device=dev)
    kp = ops.kld_greedy_picks(t, 4).cpu().numpy()
    pp = ref.kld_greedy_picks(t, 4).cpu().numpy()
    div = scheduling.first_divergence(counts, 4, pp, kp)
    assert div is None or div["tie"], div
    if tied:
        np.testing.assert_array_equal(kp, np.arange(k))


def _greedy_matches_plain(counts, gamma, dev):
    """Kernel picks against the plain version's: equal, or diverging only
    where the two candidates' float64 scores tie (first_divergence)."""
    t = torch.as_tensor(counts, dtype=torch.float32, device=dev)
    before = ops.LAUNCHES["kld_greedy_picks"]
    kp = ops.kld_greedy_picks(t, gamma).cpu().numpy()
    assert ops.LAUNCHES["kld_greedy_picks"] == before + 1
    pp = ref.kld_greedy_picks(t, gamma).cpu().numpy()
    assert sorted(kp.tolist()) == list(range(len(kp)))
    div = scheduling.first_divergence(counts, gamma, pp, kp)
    assert div is None or div["tie"], div
    return kp


# (K, C, gamma): the FL cohort, Path A, the K = 4,096 row, past what one
# CTA's shared memory holds (K > 16,384, C > 1,024), every gamma case (1: every step
# opens a mediator; 5: K not a multiple; gamma > K: one mediator)
GREEDY_CARD_CASES = [(16, 47, 4), (1024, 47, 4), (4096, 47, 4), (16_385, 47, 4),
                     (16, 1100, 4), (512, 1100, 4), (300, 47, 1), (300, 47, 5),
                     (40, 47, 64), (1024, 47, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,c,gamma", GREEDY_CARD_CASES)
def test_kld_greedy_kernel_every_shape(dev, k, c, gamma):
    _greedy_matches_plain(np.random.default_rng(k + c).integers(0, 200, (k, c)), gamma, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 1024, 4096])
def test_kld_greedy_kernel_tied_and_empty_histograms(dev, k):
    """All-tied and all-zero histograms: every score ties, so the picks are
    the clients in order."""
    tied = np.tile(np.random.default_rng(k).integers(1, 9, (1, 47)), (k, 1))
    for counts in (tied, np.zeros((k, 47))):
        np.testing.assert_array_equal(_greedy_matches_plain(counts, 4, dev), np.arange(k))


@pytest.mark.cuda
def test_kld_greedy_runs_on_a_cluster(dev):
    """At K = 4,096 the pass spreads over several SMs (one CTA each); at
    the main paths' shapes everything lives in shared memory, so the call
    needs no global scratch."""
    plan = ops.kld_greedy_plan(4096, 47)
    assert plan["ctas"] > 1 and plan["rows_in_smem"] * plan["ctas"] >= 4096, plan
    assert plan["scratch_floats"] == 0, plan
    small = ops.kld_greedy_plan(16, 47)
    assert small["ctas"] == 1 and small["scratch_floats"] == 0, small


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 64])
def test_kld_greedy_kernel_mediator_in_global_scratch(dev, k):
    """C = 60,000: the open mediator does not fit in a CTA's shared memory
    and lives in the plan's global scratch, and every row is read from
    global memory; the picks still equal the plain version's.  Each client
    holds 50 of the classes, as a client of a many-class task would."""
    c = 60_000
    plan = ops.kld_greedy_plan(k, c)
    assert (plan["med_in_smem"], plan["state_in_smem"], plan["rows_in_smem"]) == (0, 1, 0), plan
    assert plan["scratch_floats"] > 0, plan
    rng = np.random.default_rng(k)
    counts = np.zeros((k, c))
    for row in counts:
        row[rng.choice(c, 50, replace=False)] = rng.integers(1, 200, 50)
    _greedy_matches_plain(counts, 4, dev)


@pytest.mark.cuda
def test_kld_greedy_kernel_state_in_global_scratch(dev):
    """K = 300,400: each CTA's per-candidate state (static scores, the list
    of its unpicked candidates and their positions, ~18,800 candidates)
    does not fit in its shared memory and lives in the global scratch.  At
    gamma = 1 every pick comes from the static scores, so the picks are the
    stable order of ``kld_score``'s scores against an empty mediator (the
    same scorer, the same bits); at gamma = 4 tied histograms give the
    clients in order."""
    k, c = 300_400, 2
    plan = ops.kld_greedy_plan(k, c)
    assert plan["state_in_smem"] == 0 and plan["scratch_floats"] > 0, plan
    counts = torch.as_tensor(np.random.default_rng(0).integers(0, 200, (k, c)),
                             dtype=torch.float32, device=dev)
    static = ops.kld_score(torch.zeros(c, device=dev), counts).cpu().numpy()
    np.testing.assert_array_equal(ops.kld_greedy_picks(counts, 1).cpu().numpy(),
                                  np.lexsort((np.arange(k), static)))
    tied = torch.tensor([[3.0, 5.0]], device=dev).expand(k, c).contiguous()
    np.testing.assert_array_equal(ops.kld_greedy_picks(tied, 4).cpu().numpy(), np.arange(k))


@pytest.mark.cuda
def test_kld_greedy_refused_launch_raises(dev):
    """A call the kernel refuses returns its CUDA error and the wrapper's
    launch helper raises; nothing is counted."""
    t = torch.ones(4, 1, device=dev)
    out = torch.empty(4, dtype=torch.int32, device=dev)
    before = ops.LAUNCHES["kld_greedy_picks"]
    with pytest.raises(RuntimeError):
        ops._launch("kld_greedy_picks", "kld_greedy_picks", t.device, t.data_ptr(),
                    out.data_ptr(), t.data_ptr(), 4, 0, 2)
    assert ops.LAUNCHES["kld_greedy_picks"] == before


# (K, C): every lane width the host picks (C = 1, 2 -> 1 lane; 6 -> 2; 10
# -> 4; 20 -> 8; 47, 64 -> 16; 200 -> 32 holding 8 classes a lane), rows
# streamed from global memory (C = 1,100) and the mediator read from
# global memory past 48 KB (C = 60,000)
SCORE_CARD_CASES = [(16, 10), (1, 47), (300, 47), (4096, 47), (64, 1100), (16, 1),
                    (33, 2), (40, 6), (300, 20), (300, 64), (130, 200), (16, 60_000)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,c", SCORE_CARD_CASES)
def test_kld_score_kernel(dev, k, c):
    """Within 1e-6 of the plain scores; a zero mediator against a zero row
    scores exactly 0."""
    rng = np.random.default_rng(k + c)
    med = torch.as_tensor(rng.integers(0, 80, c), dtype=torch.float32, device=dev)
    cand = torch.as_tensor(rng.integers(0, 60, (k, c)), dtype=torch.float32, device=dev)
    cand[0] = 0.0
    before = ops.LAUNCHES["kld_score"]
    out = ops.kld_score(med, cand)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["kld_score"] == before + 1
    torch.testing.assert_close(out, ref.kld_score(med, cand), rtol=0, atol=1e-6)
    zero = ops.kld_score(torch.zeros(c, device=dev), cand)
    assert float(zero[0]) == 0.0
    assert ops.kld_score(med, cand[:0]).shape == (0,)


@pytest.mark.cuda
def test_kld_score_plan(dev):
    """Lanes per row from C (each lane <= 4 classes up to C = 128, 8 up to
    256, then streamed); K = 512 at C = 47 runs as 64 CTAs, K = 1,024 as
    128; the mediator is staged in shared memory only on the streamed path
    while it fits in 48 KB."""
    lanes = {c: ops.kld_score_plan(16, c)["lanes"] for c in (1, 2, 6, 10, 20, 47, 64, 65, 200)}
    assert lanes == {1: 1, 2: 1, 6: 2, 10: 4, 20: 8, 47: 16, 64: 16, 65: 32, 200: 32}
    assert ops.kld_score_plan(512, 47) == {"lanes": 16, "rounds": 4, "threads": 128,
                                           "ctas": 64, "med_in_smem": 0}
    assert ops.kld_score_plan(1024, 47)["ctas"] == 128
    assert ops.kld_score_plan(16, 200)["rounds"] == 8
    assert ops.kld_score_plan(16, 1100)["med_in_smem"] == 1
    assert ops.kld_score_plan(16, 60_000)["med_in_smem"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,c", [(1, 1, 10), (16, 512, 47), (19, 77, 47), (256, 4096, 47),
                                   (9, 40, 1100), (3, 5, 60_000)])
def test_kld_score_matrix_kernel(dev, m, k, c):
    """Within 1e-6 of the plain scores, and every row bit for bit the
    single-mediator kernel's (one device function)."""
    rng = np.random.default_rng(m * k)
    meds = torch.as_tensor(rng.integers(0, 80, (m, c)), dtype=torch.float32, device=dev)
    cand = torch.as_tensor(rng.integers(0, 60, (k, c)), dtype=torch.float32, device=dev)
    out = ops.kld_score_matrix(meds, cand)
    torch.testing.assert_close(out, ref.kld_score_matrix(meds, cand), rtol=0, atol=1e-6)
    for i in (0, m // 2, m - 1):
        assert torch.equal(out[i], ops.kld_score(meds[i].contiguous(), cand))
    assert ops.kld_score_matrix(meds[:0], cand).shape == (0, k)


# (M, K, C, path): M and K ragged against every tile the plan picks (16 x
# 16 at one lane per pair, 8 x 8, 8 x 4, 4 x 4), last tiles whose bytes
# end past a 16-byte boundary (floats copied by threads), every lane count
# (1, 2, 4, 8, 16, 32) with C below, at and past a multiple of the lanes'
# rounds, C = 64 (f32 sums) and 65 (f64), the staging limit (two tiles of
# 96 KB) met and passed at 1 lane and at 4, and the direct path of a row
# slice that is not 16-byte aligned ("slice": cand[1:] at odd C)
MATRIX_TILE_CASES = [(19, 77, 64, "staged"), (21, 75, 65, "staged"), (37, 1001, 47, "staged"),
                     (5, 13, 64, "staged"), (3, 7, 65, "staged"), (40, 700, 8, "staged"),
                     (40, 700, 10, "staged"), (20, 700, 16, "staged"), (20, 700, 30, "staged"),
                     (10, 700, 30, "staged"), (8, 500, 100, "staged"), (4, 600, 100, "staged"),
                     (160, 160, 768, "staged"),
                     (160, 160, 769, "direct"), (16, 512, 2048, "staged"),
                     (16, 512, 2049, "direct"), (33, 130, 47, "slice"), (7, 9, 65, "slice")]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,c,path", MATRIX_TILE_CASES)
def test_kld_score_matrix_kernel_tiles_and_paths(dev, m, k, c, path):
    """Within 1e-6 of the plain scores on the path the plan reports, and
    the first, a middle and the last row bit for bit ``kld_score``'s."""
    rng = np.random.default_rng(m + k + c)
    meds = torch.as_tensor(rng.integers(0, 80, (m, c)), dtype=torch.float32, device=dev)
    cand = torch.as_tensor(rng.integers(0, 60, (k + 1, c)), dtype=torch.float32, device=dev)
    cand = cand[1:] if path == "slice" else cand[:k].contiguous()
    assert cand.is_contiguous() and (cand.data_ptr() % 16 != 0) == (path == "slice")
    plan = ops.kld_score_matrix_plan(m, k, c, meds, cand)
    assert plan["tiles_in_smem"] == (path == "staged"), plan
    before = ops.LAUNCHES["kld_score_matrix"]
    out = ops.kld_score_matrix(meds, cand)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["kld_score_matrix"] == before + 1
    torch.testing.assert_close(out, ref.kld_score_matrix(meds, cand), rtol=0, atol=1e-6)
    for i in (0, m // 2, m - 1):
        assert torch.equal(out[i], ops.kld_score(meds[i].contiguous(), cand))


@pytest.mark.cuda
def test_kld_score_matrix_plan(dev):
    """The fewest lanes per pair that put ~12 warps on every SM: one from
    ~50k pairs up on an H100 (Path A's sweep, 256 x 4,096); 8 at 16 x 512
    x 47, whose 4 x 4 tiles fill the card (at least a CTA per SM); 4 at 16
    x 512 x 2,000 (fewer lanes past 64 classes); never more than
    kld_score's lanes for C; every group streams its rows; tiles staged
    while two fit in 96 KB and the pointers are 16-byte aligned."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    small = ops.kld_score_matrix_plan(16, 512, 47)
    assert small["ctas"] >= sms
    if sms == 132:
        assert small == {"lanes": 8, "rounds": 0, "tile_m": 4, "tile_k": 4, "threads": 128,
                         "ctas": 512, "tiles_in_smem": 1, "smem_bytes": 8 * 47 * 4}
        for m, k in ((256, 1024), (256, 4096)):
            plan = ops.kld_score_matrix_plan(m, k, 47)
            assert (plan["lanes"], plan["tile_m"], plan["tile_k"]) == (1, 16, 16)
            assert plan["ctas"] == (m // 16) * (k // 16)
        wide = ops.kld_score_matrix_plan(16, 512, 2000)
        assert (wide["lanes"], wide["tiles_in_smem"]) == (4, 1)
        lanes = [ops.kld_score_matrix_plan(m, k, c)["lanes"] for m, k, c in
                 ((40, 700, 8), (20, 700, 16), (10, 700, 30), (5, 13, 64), (3, 7, 65))]
        assert lanes == [2, 4, 8, 16, 32]
    assert ops.kld_score_matrix_plan(3, 5, 60_000)["tiles_in_smem"] == 0
    assert ops.kld_score_matrix_plan(1, 1, 10)["lanes"] == 4       # C = 10: kld_score's 4
    assert all(ops.kld_score_matrix_plan(m, k, c)["rounds"] == 0
               for m, k, c in ((16, 512, 47), (5, 13, 64), (1, 1, 10), (256, 1024, 47)))


@pytest.mark.cuda
@pytest.mark.parametrize("k,gamma", [(16, 4), (300, 4), (1024, 4), (64, 5)])
def test_loop_with_kld_score_equals_greedy_kernel(dev, k, gamma):
    """On integer histograms the per-step loop (one kld_score launch per
    pick) takes exactly the one-launch greedy kernel's picks."""
    counts = np.random.default_rng(k).integers(0, 200, (k, 47))
    ops.reset_launches()
    loop = scheduling.reschedule(counts, gamma, impl="loop", device=dev)
    assert ops.LAUNCHES["kld_score"] == k
    batched = scheduling.reschedule(counts, gamma, impl="batched", device=dev)
    assert [m.clients for m in loop] == [m.clients for m in batched]


@pytest.mark.cuda
@pytest.mark.parametrize("k,c", [(16_385, 47), (512, 1100), (16, 10), (16, 60_000)])
def test_loop_equals_greedy_kernel_at_large_k_and_c(dev, k, c):
    """Past what one CTA's shared memory holds (K > 16,384, C > 1,024), at
    C = 10 (4 lanes per row in kld_score) and at C = 60,000 (both kernels'
    mediator in global memory): the per-step loop (one kld_score launch
    per pick, the same scorer) takes exactly the cluster kernel's picks on
    integer histograms."""
    counts = np.random.default_rng(k + c).integers(0, 200, (k, c))
    loop = scheduling.reschedule(counts, 4, impl="loop", device=dev)
    batched = scheduling.reschedule(counts, 4, impl="batched", device=dev)
    assert [m.clients for m in loop] == [m.clients for m in batched]


@pytest.mark.cuda
def test_affine_warp_kernel(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    imgs = torch.randn(64, 28, 28, 3, generator=g, device=dev)
    mats = torch.randn(64, 2, 2, generator=g, device=dev)
    trans = 3 * torch.randn(64, 2, generator=g, device=dev)
    torch.testing.assert_close(ops.affine_warp(imgs, mats, trans),
                               ref.affine_warp(imgs, mats, trans), rtol=0, atol=1e-5)


# (B, H, W, C, stages): H != W at C in {1, 3, 4}, empty and single
# batches, a batch one past the EMNIST round's; stages 2 = the staged
# path, 0 = the direct path (an image over 48 KB, or one whose bytes are
# not a multiple of 16)
WARP_CARD_CASES = [(7361, 20, 36, 1, 2), (64, 20, 36, 3, 2), (64, 36, 20, 4, 2),
                   (0, 20, 36, 3, 2), (1, 20, 36, 3, 2), (7361, 28, 28, 1, 2),
                   (5, 96, 160, 1, 0), (3, 100, 140, 3, 0), (33, 5, 7, 1, 0),
                   (17, 5, 7, 3, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,stages", WARP_CARD_CASES)
def test_affine_warp_kernel_every_shape(dev, b, h, w, c, stages):
    g = torch.Generator(device=dev).manual_seed(b + h + c)
    imgs = torch.randn(b, h, w, c, generator=g, device=dev)
    mats = torch.randn(b, 2, 2, generator=g, device=dev)
    trans = 3 * torch.randn(b, 2, generator=g, device=dev)
    out = ops.affine_warp(imgs, mats, trans)
    torch.testing.assert_close(out, ref.affine_warp(imgs, mats, trans), rtol=0, atol=1e-5)
    assert ops.affine_warp_stages(imgs, out) == stages


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c", [(20, 36, 3), (28, 28, 1), (100, 140, 3)])
def test_affine_warp_kernel_all_taps_outside(dev, h, w, c):
    """Maps that put every tap of every pixel outside the image: zeros."""
    b = 9
    imgs = torch.randn(b, h, w, c, device=dev)
    mats = torch.eye(2, device=dev).repeat(b, 1, 1)
    trans = torch.tensor([[1e4, 0.0], [0.0, -1e4], [float(h), 0.0], [-h - 1.0, 0.0],
                          [0.0, float(w)], [0.0, -w - 1.0], [1e9, 1e9], [-2.0 * h, 3.0 * w],
                          [h + 0.5, -w - 0.5]], device=dev)
    out = ops.affine_warp(imgs, mats, trans)
    torch.testing.assert_close(out, ref.affine_warp(imgs, mats, trans), rtol=0, atol=1e-5)
    assert not bool(out.any())


@pytest.mark.cuda
def test_wrappers_refuse_non_contiguous_cuda_input(dev):
    d = torch.randn(8, 4, device=dev).t()
    with pytest.raises(ValueError):
        ops.fedavg_agg(d, torch.ones(4, device=dev))


def _err_scale(out, plain):
    return (float((out.double() - plain.double()).abs().max()),
            max(float(plain.double().abs().max()), 1.0))


# (b, sq, skv, H, KV, d, causal, window, q_offset): the Hymba prefill
# layer, ragged tiles, no window, q_offset, GQA 1:1, head dims 80 and 128,
# window edges that cut through a 64-key tile, a negative q_offset
FLASH_CARD_CASES = [
    (4, 2048, 2048, 25, 5, 64, True, 1024, 0),
    (2, 200, 200, 4, 2, 64, True, 64, 0),
    (1, 130, 130, 5, 5, 80, True, None, 0),
    (1, 64, 192, 8, 2, 128, True, None, 128),
    (2, 100, 100, 4, 1, 64, False, None, 0),
    (1, 40, 300, 4, 4, 64, True, 100, 260),
    (1, 100, 100, 4, 2, 64, True, 50, 0),
    (2, 77, 77, 6, 2, 80, True, 40, -9),
    (1, 150, 260, 8, 2, 128, True, 70, 110),
    # head dim 256: gemma-2b's prefill layer (MQA 8:1), a window, a
    # q_offset with ragged sq != skv, GQA 4:2 without a causal mask
    (4, 2048, 2048, 8, 1, 256, True, None, 0),
    (2, 130, 130, 4, 2, 256, True, 50, 0),
    (1, 70, 260, 8, 1, 256, True, 90, 190),
    (1, 100, 100, 4, 2, 256, False, None, 0),
    (1, 200, 200, 8, 1, 256, True, None, 0),
    # whisper-base at full width: the encoder's non-causal self-attention
    # over 1,536 frames, the decoder's cross-attention from a 256-token
    # prompt (prefill) and from one token (decode) to them; internvl2-1b's
    # GQA 14:2 prefill layer
    (4, 1536, 1536, 8, 8, 64, False, None, 0),
    (4, 256, 1536, 8, 8, 64, False, None, 0),
    (4, 1, 1536, 8, 8, 64, False, None, 0),
    (4, 2048, 2048, 14, 2, 64, True, None, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CARD_CASES)
def test_flash_attention_kernel(dev, dtype, case):
    """fp32: online softmax against the whole-row plain version, sums in
    other orders, |err| <= 1e-5 of the output scale; bf16: one bf16 ulp
    (2^-7 of the output scale), and per element, against the plain version
    in fp32 on the same bf16 inputs, one bf16 rounding of the output
    (2^-8 of |exact|) and one of every probability weight (2^-9 of
    sum p|v| / l, doubled for the fp32 sums' order)."""
    b, sq, skv, h, kv, d, causal, window, off = case
    g = torch.Generator(device=dev).manual_seed(sq + skv + d)
    q = torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
    k = torch.randn(b, skv, kv, d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, skv, kv, d, generator=g, device=dev).to(dtype)
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=off)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    err, scale = _err_scale(out, ref.flash_attention(q, k, v, causal=causal,
                                                     window=window, q_offset=off))
    assert err <= (1e-5 if dtype == torch.float32 else 2 ** -7) * scale
    if dtype == torch.bfloat16:
        kw = dict(causal=causal, window=window, q_offset=off)
        qf, kf, vf = q.float(), k.float(), v.float()
        exact = ref.flash_attention(qf, kf, vf, **kw)
        bound = 2 ** -8 * (exact.abs() + ref.flash_attention(qf, kf, vf.abs(), **kw))
        assert bool(((out.float() - exact).abs() <= bound).all())


# (b, sq, skv, H, KV, causal, window, q_offset): a last key tile of 3, 33
# and 61 keys (skv not a multiple of 64) with and without masks, GQA 2:1
F32_RAGGED_CASES = [(2, 70, 131, 4, 2, True, None, 61), (1, 33, 97, 2, 1, False, None, 0),
                    (1, 100, 189, 4, 4, True, 50, 89)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 80, 128, 256])
@pytest.mark.parametrize("case", F32_RAGGED_CASES)
def test_flash_attention_f32_ragged_key_tile(dev, d, case):
    """fp32 at every head dim with a ragged last key tile (TMA zero-fills
    the keys past skv, the mask drops them): within 1e-5 of the output
    scale."""
    b, sq, skv, h, kv, causal, window, off = case
    g = torch.Generator(device=dev).manual_seed(sq + skv + d)
    q = torch.randn(b, sq, h, d, generator=g, device=dev)
    k = torch.randn(b, skv, kv, d, generator=g, device=dev)
    v = torch.randn(b, skv, kv, d, generator=g, device=dev)
    kw = dict(causal=causal, window=window, q_offset=off)
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    err, scale = _err_scale(out, ref.flash_attention(q, k, v, **kw))
    assert err <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_refuses_misaligned_inputs(dev, dtype):
    """The kernels load q, k and v by TMA: a contiguous view that is not
    16-byte aligned raises, with no launch."""
    base = torch.randn(1 + 2 * 8 * 64, device=dev).to(dtype)
    q = base[1:].view(1, 8, 2, 64)
    k = v = torch.randn(1, 8, 2, 64, device=dev).to(dtype)
    before = ops.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.flash_attention(q, k, v)
    assert ops.LAUNCHES["flash_attention"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 256])
def test_flash_attention_kernel_row_without_keys_is_zero(dev, d):
    q, k, v = (torch.randn(1, 8, 2, d, device=dev) for _ in range(3))
    out = ops.flash_attention(q, k, v, causal=True, q_offset=-4)
    assert torch.equal(out[:, :4], torch.zeros_like(out[:, :4]))
    assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_refuses_other_head_dims(dev, dtype):
    """A head dim the kernel is not built for raises on the card (the CPU
    takes it through the plain version); nothing is launched."""
    q, k, v = (torch.randn(1, 16, 2, 96, device=dev).to(dtype) for _ in range(3))
    before = ops.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="head dim 96"):
        ops.flash_attention(q, k, v)
    assert ops.LAUNCHES["flash_attention"] == before
    assert ops.flash_attention(q.cpu(), k.cpu(), v.cpu()).shape == q.shape


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 80, 128, 256])
def test_flash_attention_bf16_row_without_keys_is_zero(dev, d):
    q, k, v = (torch.randn(1, 70, 2, d, device=dev).to(torch.bfloat16) for _ in range(3))
    out = ops.flash_attention(q, k, v, causal=True, q_offset=-6)
    assert torch.equal(out[:, :6], torch.zeros_like(out[:, :6]))
    assert bool(torch.isfinite(out.float()).all()) and out[:, 6:].abs().sum() > 0


# (b, nc, L, h, p, n): the Hymba layer, small and mamba2-370m-like
# blocks, head counts no CTA's range divides (25, 3), L in {16, 32, 64,
# 128}, L, p, n not multiples of 8 (scalar loads and stores), p = 12 (fp32
# rows in 16-byte pieces, bf16 rows not: x loaded at each head's start),
# and in fp32 each of the four layouts: two x stages with C B^T cached
# (Hymba), two stages recomputing it ((128, 128, 16)), one stage cached
# ((128, 128, 32)) and one recomputing ((128, 128, 64)); for the backward,
# CTAs that walk several heads with the next one in flight across (batch,
# chunk) boundaries at n = 128 (189 heads on one CTA an SM) and at Hymba's
# widths with an odd head count (800 heads of 25 a chunk on two CTAs an SM),
# and a state past 128 (n = 136: the variant keeping 16 dW^T tiles a warp)
SSD_CARD_CASES = [(4, 32, 64, 25, 64, 16), (2, 3, 32, 3, 16, 8), (1, 2, 64, 4, 64, 128),
                  (1, 2, 16, 2, 8, 8), (2, 3, 16, 25, 16, 16), (1, 5, 32, 3, 64, 16),
                  (1, 3, 64, 25, 64, 16), (1, 2, 128, 3, 64, 16), (2, 2, 30, 3, 10, 6),
                  (1, 3, 64, 5, 12, 16), (1, 2, 128, 3, 128, 16), (1, 2, 128, 3, 128, 32),
                  (1, 2, 128, 2, 128, 64), (1, 2, 128, 2, 130, 64), (3, 7, 64, 9, 64, 128),
                  (2, 16, 64, 25, 64, 16), (1, 2, 64, 3, 8, 136)]


def _ssd_inputs(dev, dtype, b, nc, L, h, p, n, dt_scale=1.0):
    g = torch.Generator(device=dev).manual_seed(L * h + n)
    x = torch.randn(b, nc, L, h, p, generator=g, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(b, nc, L, h, generator=g, device=dev))
    A = -torch.exp(0.3 * torch.randn(h, generator=g, device=dev))
    B = (0.5 * torch.randn(b, nc, L, n, generator=g, device=dev)).to(dtype)
    C = (0.5 * torch.randn(b, nc, L, n, generator=g, device=dev)).to(dtype)
    return x, dt * dt_scale, A, B, C


def _ssd_matches_plain(got, want, dtype):
    for i, (o, w) in enumerate(zip(got, want)):
        assert o.dtype == w.dtype and o.shape == w.shape
        err, scale = _err_scale(o, w)
        tol = 2 ** -7 if (i == 0 and dtype == torch.bfloat16) else 1e-5
        assert err <= tol * scale, (i, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nc,L,h,p,n", SSD_CARD_CASES)
def test_ssd_chunk_kernel(dev, dtype, b, nc, L, h, p, n):
    """y_diag, S and g against the plain version: fp32 sums in another
    order, 1e-5 of each output's scale (y_diag in bf16: one bf16 ulp)."""
    x, dt, A, B, C = _ssd_inputs(dev, dtype, b, nc, L, h, p, n)
    before = ops.LAUNCHES["ssd_chunk"]
    got = ops.ssd_chunk(x, dt, A, B, C)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_chunk"] == before + 1
    _ssd_matches_plain(got, ref.ssd_chunk(x, dt, A, B, C), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_kernel_steep_segments(dev, dtype):
    """dt 400 times larger: exp(cum_i - cum_j) underflows below the
    diagonal (segment sums far below -88) and would overflow above it;
    every output is finite and within the plain version's tolerance."""
    x, dt, A, B, C = _ssd_inputs(dev, dtype, 2, 3, 64, 5, 64, 16, dt_scale=400.0)
    got = ops.ssd_chunk(x, dt, A, B, C)
    assert all(bool(torch.isfinite(t.float()).all()) for t in got)
    _ssd_matches_plain(got, ref.ssd_chunk(x, dt, A, B, C), dtype)


@pytest.mark.cuda
def test_ssd_chunk_layout_matches_library(dev):
    """The library's plan for every case above, both dtypes, 16-byte x rows
    or not, fits in 227 KB; where it is the least layout (one x stage, C B^T
    recomputed), its bytes are ``ops.ssd_chunk_smem_bytes`` (the wrapper's
    shared-memory check); the four layouts are all picked; a shape the
    wrapper refuses has no plan; Hymba's keeps C B^T and two x stages in
    74,496 B with 160 threads in fp32 and 58,112 B in bf16, three CTAs to
    an SM."""
    seen = set()
    for _, _, L, _, p, n in SSD_CARD_CASES:
        for esize in (4, 2):
            for xvec in (True, False):
                plan = ops.ssd_chunk_plan(L, p, n, esize, xvec)
                assert plan["smem_bytes"] <= ops.MAX_SMEM_BYTES, (L, p, n, esize, xvec)
                if (plan["cache_cb"], plan["stages"]) == (False, 1):
                    assert plan["smem_bytes"] == ops.ssd_chunk_smem_bytes(L, p, n)
                seen.add((plan["cache_cb"], plan["stages"]))
    assert seen == {(True, 2), (False, 2), (True, 1), (False, 1)}
    assert ops.ssd_chunk_plan(128, 130, 64) == {
        "cache_cb": False, "stages": 1, "smem_bytes": ops.ssd_chunk_smem_bytes(128, 130, 64),
        "threads": 256}
    with pytest.raises(RuntimeError):
        ops.ssd_chunk_plan(128, 136, 60)
    assert ops.ssd_chunk_plan(64, 64, 16) == {"cache_cb": True, "stages": 2,
                                              "smem_bytes": 74_496, "threads": 160}
    assert ops.ssd_chunk_plan(64, 64, 16, esize=2)["smem_bytes"] == 58_112


# the cases above that the backward kernel holds (L = 128 at p = 64 and n =
# 16 only)
SSD_BWD_CARD_CASES = [c for c in SSD_CARD_CASES
                      if ops.ssd_chunk_bwd_smem_bytes(*c[2:3], *c[4:]) <= ops.MAX_SMEM_BYTES]


def _ssd_bwd_inputs(dev, b, nc, L, h, p, n, dt_scale=1.0):
    x, dt, A, B, C = _ssd_inputs(dev, torch.float32, b, nc, L, h, p, n, dt_scale)
    g = torch.Generator(device=dev).manual_seed(L + h + n)
    cot = (torch.randn(b, nc, L, h, p, generator=g, device=dev),
           torch.randn(b, nc, h, n, p, generator=g, device=dev),
           torch.randn(b, nc, h, generator=g, device=dev))
    return x, dt, A, B, C, *cot


def _ssd_bwd_matches_plain(got, want):
    """dx, ddt, dB and dC within 1e-5 of each gradient's scale (fp32 sums in
    other orders), dA within 1e-4 (a sum of b nc L terms of both signs)."""
    for name, o, w, rel in zip(("dx", "ddt", "dA", "dB", "dC"), got, want,
                               (1e-5, 1e-5, 1e-4, 1e-5, 1e-5)):
        assert o.dtype == w.dtype and o.shape == w.shape, name
        err, scale = _err_scale(o, w)
        assert err <= rel * scale, (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("b,nc,L,h,p,n", SSD_BWD_CARD_CASES)
def test_ssd_chunk_bwd_kernel(dev, b, nc, L, h, p, n):
    """The backward kernel against ``ref.ssd_chunk_bwd`` (one launch)."""
    args = _ssd_bwd_inputs(dev, b, nc, L, h, p, n)
    before = ops.LAUNCHES["ssd_chunk_bwd"]
    got = ops.ssd_chunk_bwd(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_chunk_bwd"] == before + 1
    _ssd_bwd_matches_plain(got, ref.ssd_chunk_bwd(*args))


@pytest.mark.cuda
def test_ssd_chunk_bwd_kernel_steep_segments(dev):
    """dt 400 times larger: the segment sums fall far below -88 under the
    diagonal and would overflow above it; every gradient is finite and
    within the plain version's tolerance."""
    args = _ssd_bwd_inputs(dev, 2, 3, 64, 5, 64, 16, dt_scale=400.0)
    got = ops.ssd_chunk_bwd(*args)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    _ssd_bwd_matches_plain(got, ref.ssd_chunk_bwd(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("b,nc,L,h,p,n", [(4, 2, 64, 25, 64, 16), (4, 8, 64, 32, 64, 128)])
def test_ssd_chunk_bwd_kernel_is_bitwise_deterministic(dev, b, nc, L, h, p, n):
    """Hymba's training layer (heads split across CTAs, so dB and dC are
    sums of partials) and mamba2-370m's: two runs agree bit for bit."""
    args = _ssd_bwd_inputs(dev, b, nc, L, h, p, n)
    plan = ops.ssd_chunk_bwd_plan(b, nc, L, h, p, n)
    assert plan["ctas"] > b * nc                   # some (batch, chunk) has 2 CTAs
    one, two = ops.ssd_chunk_bwd(*args), ops.ssd_chunk_bwd(*args)
    assert all(torch.equal(u, v) for u, v in zip(one, two))


@pytest.mark.cuda
def test_ssd_chunk_bwd_layout_matches_library(dev):
    """The backward's plan for every case it holds fits in 227 KB, takes the
    variant ``ops._ssd_bwd_variant`` names and a least (one-stage) layout of
    ``ops.ssd_chunk_bwd_smem_bytes`` (the wrapper's check), and is that
    layout where it takes one head stage; both stage counts and every
    variant are picked.  Over a grid of (L, p, n) the library refuses just
    the shapes the wrapper refuses and agrees with ``ops`` on the rest.
    Hymba's training layer takes two stages in 111,968 B, two CTAs an SM,
    and mamba2-370m's two stages in 226,656 B, one CTA an SM; in the n =
    128 case of 189 heads some CTA's two heads belong to two (batch, chunk)
    pairs."""
    seen, variants = set(), set()
    for b, nc, L, h, p, n in SSD_BWD_CARD_CASES:
        plan = ops.ssd_chunk_bwd_plan(b, nc, L, h, p, n)
        assert plan["smem_bytes"] <= ops.MAX_SMEM_BYTES and plan["threads"] == 256
        assert plan["variant"] == ops._ssd_bwd_variant(L, n), (L, p, n)
        assert plan["least_smem_bytes"] == ops.ssd_chunk_bwd_smem_bytes(L, p, n), (L, p, n)
        if plan["stages"] == 1:
            assert plan["smem_bytes"] == plan["least_smem_bytes"], (L, p, n)
        seen.add(plan["stages"])
        variants.add(plan["variant"])
    assert seen == {1, 2}
    assert variants == set(ops.SSD_BWD_VARIANTS)
    for L in (1, 7, 8, 9, 16, 17, 24, 31, 32, 33, 40, 48, 56, 63, 64, 65, 72, 80, 96, 112,
              120, 128, 136, 143, 144, 145, 160):
        for n in (1, 6, 8, 16, 17, 24, 32, 48, 64, 65, 96, 128, 129, 136, 192, 256, 257):
            want = ops._ssd_bwd_variant(L, n)
            for p in (4, 8, 10, 32, 64, 128):
                if want is None or ops.ssd_chunk_bwd_smem_bytes(L, p, n) > ops.MAX_SMEM_BYTES:
                    with pytest.raises(RuntimeError):
                        ops.ssd_chunk_bwd_plan(1, 1, L, 1, p, n)
                    continue
                plan = ops.ssd_chunk_bwd_plan(1, 1, L, 1, p, n)
                assert (plan["variant"], plan["least_smem_bytes"]) == \
                    (want, ops.ssd_chunk_bwd_smem_bytes(L, p, n)), (L, p, n)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    hymba = ops.ssd_chunk_bwd_plan(4, 2, 64, 25, 64, 16)
    assert (hymba["stages"], hymba["smem_bytes"]) == (2, 111_968)
    assert hymba["ctas"] == min(200, 2 * sms)
    mamba = ops.ssd_chunk_bwd_plan(4, 8, 64, 32, 64, 128)
    assert (mamba["stages"], mamba["smem_bytes"], mamba["ctas"]) == (2, 226_656, sms)
    ctas, items, nh = ops.ssd_chunk_bwd_plan(3, 7, 64, 9, 64, 128)["ctas"], 189, 9
    assert any(items * c // ctas // nh != (items * (c + 1) // ctas - 1) // nh
               for c in range(ctas))


@pytest.mark.cuda
def test_ssd_chunk_bwd_kernel_refuses_what_it_cannot_hold(dev):
    """L = 128 at p = 128 and n = 32 (the forward takes it): the backward's
    shared memory is over 227 KB, so the wrapper raises with the bytes, and
    a gradient through ``ssd_chunk`` is refused before the forward
    launches; bf16 inputs with a gradient are refused on the card."""
    args = _ssd_bwd_inputs(dev, 1, 2, 128, 3, 128, 32)
    with pytest.raises(ValueError, match="shared memory"):
        ops.ssd_chunk_bwd(*args)
    x = args[0].clone().requires_grad_(True)
    before = ops.LAUNCHES["ssd_chunk"]
    with pytest.raises(ValueError, match="backward"):
        ops.ssd_chunk(x, *args[1:5])
    x, dt, A, B, C = _ssd_inputs(dev, torch.bfloat16, 1, 2, 64, 3, 64, 16)
    with pytest.raises(ValueError, match="bfloat16"):
        ops.ssd_chunk(x.requires_grad_(True), dt, A, B, C)
    assert ops.LAUNCHES["ssd_chunk"] == before


def _card_matches_cpu(dev, cfg, fan_in=False):
    """``cfg`` with f32 weights from one seed (LayerNorm scales set to 1:
    the reference's init zeroes them, and every LayerNorm output with
    them; with ``fan_in`` each stacked layer matrix rescaled from the
    reference init's ``1/sqrt(layers)`` to ``1/sqrt(d_in)``: at the
    reference's scale a 1e-7 relative perturbation of the weights moves the
    reduced whisper's and granite's decode logits by up to 4.2e-3 and
    4.8e-4 of their scale on the CPU alone, past the 2e-4 below), a VLM's or audio model's stub inputs from another, prompt 128,
    on the card and on the CPU: one flash launch per attention layer (an
    audio model's encoder layers and cross-attentions too) and one SSD
    launch per SSM layer in the card's prefill; the logits of the prefill
    and of 4 teacher-forced decode steps agree within 2e-4 of the logit
    scale (fp32 sums in other orders, amplified by the init's large
    activations)."""
    from repro_torch.launch.serve import modality_inputs, prefix_len
    cpu = T.init_model(cfg, torch.Generator().manual_seed(0))
    if cfg.norm == "ln":
        for name, p in cpu.named_parameters():
            if name.rsplit(".", 1)[-1] in ("norm1", "norm2", "norm_x", "final_norm",
                                           "enc_final_norm"):
                p.fill_(1.0)
    if fan_in:
        stacks = {"layers": cfg.n_layers, "encoder": cfg.encoder_layers}
        with torch.no_grad():
            for name, p in cpu.named_parameters():
                n = stacks.get(name.split(".", 1)[0])
                if n and p.dim() >= 2:
                    p.mul_((n / p.shape[-2]) ** 0.5)
    card = T.Transformer(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 132), generator=gen)
    extra = modality_inputs(cfg, 2, gen, "cpu")
    start = prefix_len(cfg) + 128
    ops.reset_launches()
    lc, cc = T.forward_prefill(cpu, {"tokens": toks[:, :128], **extra}, pad_to=start + 4)
    lg, cg = T.forward_prefill(card, {"tokens": toks[:, :128].to(dev),
                                      **{k: v.to(dev) for k, v in extra.items()}},
                               pad_to=start + 4)
    audio = cfg.arch_type == "audio"
    attn_layers = (cfg.n_layers if cfg.has_attention else 0) \
        + (cfg.encoder_layers + cfg.n_layers if audio else 0)
    assert ops.LAUNCHES["flash_attention"] == attn_layers
    assert ops.LAUNCHES["ssd_chunk"] == (cfg.n_layers if cfg.has_ssm else 0)
    err, scale = _err_scale(lg.cpu(), lc)
    assert err <= 2e-4 * scale
    for i in range(4):
        pos = start + i
        tok = toks[:, 128 + i:129 + i]
        lc, cc = T.forward_decode(cpu, {"tokens": tok, "positions": torch.full((2,), pos)}, cc)
        lg, cg = T.forward_decode(card, {"tokens": tok.to(dev),
                                         "positions": torch.full((2,), pos, device=dev)}, cg)
        err, scale = _err_scale(lg.cpu(), lc)
        assert err <= 2e-4 * scale
    # decode's cross-attention runs on the kernel, one launch a layer a step
    assert ops.LAUNCHES["flash_attention"] == attn_layers + (4 * cfg.n_layers if audio else 0)


@pytest.mark.cuda
def test_hymba_prefill_and_decode_on_card_match_cpu(dev):
    """Reduced Hymba (GQA 4:2), prompt 2W."""
    _card_matches_cpu(dev, dataclasses.replace(configs.reduced(configs.get("hymba-1.5b")),
                                               n_kv_heads=2))


# (arch, head dim override): the reduced zoo families the serving path
# registers; gemma at its full head dim 256 (``reduced`` sets 64); the MoE,
# audio and VLM families (weights at the standard fan-in)
ZOO_CARD_CASES = [("gemma-2b", 256), ("qwen3-4b", None), ("h2o-danube-1.8b", None),
                  ("mamba2-370m", None), ("granite-moe-3b-a800m", None),
                  ("whisper-base", None), ("internvl2-1b", None)]
ZOO_FAN_IN = ("granite-moe-3b-a800m", "whisper-base", "internvl2-1b")


@pytest.mark.cuda
@pytest.mark.parametrize("arch,head_dim", ZOO_CARD_CASES)
def test_zoo_prefill_and_decode_on_card_match_cpu(dev, arch, head_dim):
    """Each registered family, reduced: prompt 128 is 2W for danube's
    reduced window and two SSD chunks for mamba2, four MoE groups of 64
    tokens for granite (batch 2); internvl2's 16 vision tokens ahead of
    it, whisper's 64 frames through its encoder."""
    cfg = configs.reduced(configs.get(arch))
    if head_dim is not None:
        cfg = dataclasses.replace(cfg, head_dim=head_dim)
    _card_matches_cpu(dev, cfg, fan_in=arch in ZOO_FAN_IN)


# ---------------------------------------------------------------- the round engine

def _small_federation(cinic: bool):
    """The small EMNIST (8 classes, 16 px) or CINIC (16x16x3, width 8)
    federation of ``chip_smoke.py``'s agreement check, and a model maker."""
    from repro_torch.data.federated import CINIC_LIKE, EMNIST_LIKE, partition
    from repro_torch.models.cnn import cinic_cnn, emnist_cnn
    if cinic:
        spec = dataclasses.replace(CINIC_LIKE, image_size=16, noise=0.5, distort=0.35)
        make, gd = (lambda: cinic_cnn(10, 16, 3, 8)), "normal"
    else:
        spec = dataclasses.replace(EMNIST_LIKE, num_classes=8, image_size=16)
        make, gd = (lambda: emnist_cnn(8, 16)), "letterfreq"
    fed = partition(spec, num_clients=12, total_samples=300, test_samples=80,
                    sizes="instagram", global_dist=gd, local="random", seed=0)
    return fed, make


def _small_trainer(dev, cinic, kind, row_exec, **kw):
    from repro_torch.core import AstraeaTrainer, FedAvgTrainer, LocalSpec
    from repro_torch.models.cnn import init_params
    from repro_torch.optim import adam
    fed, make = _small_federation(cinic)
    common = dict(clients_per_round=8, local=LocalSpec(10, 1), seed=0, device=dev,
                  init_params=init_params(make(), 0), row_exec=row_exec)
    if kind == "fedavg":
        return FedAvgTrainer(make(), adam(1e-3), fed, **common, **kw)
    return AstraeaTrainer(make(), adam(1e-3), fed, gamma=4, alpha=0.67, **common, **kw)


@pytest.fixture
def plain_convolutions():
    """ATen's own convolutions in place of cuDNN's for one test.  The two
    row paths make cuDNN pick other algorithms (grouped against single
    convolutions), and at CINIC's width some of its fp32 algorithms sum
    the weight gradients far less exactly than fp32 in another order
    would: the rounds then part by 5.9e-4 at cuDNN's deterministic
    algorithms, twenty-seven times what perturbing the weights by 1e-7
    does to the loop."""
    before = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    yield
    torch.backends.cudnn.enabled = before


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fedavg", "astraea"])
@pytest.mark.parametrize("cinic", [False, True])
def test_captured_vmap_round_equals_eager_map_round(dev, plain_convolutions, cinic,
                                                    kind):
    """A round with the rows in lockstep, captured as one CUDA graph and
    replayed, against the same round row by row, eagerly, from the same
    params and seeded draws (the same numbers on one card), both through
    ATen's convolutions: equal schedules and WAN ledger, params within
    1e-4 (fp32 sums batched in another order, as phase 4 holds the card
    to the CPU)."""
    runs = {}
    for row_exec in ("map", "vmap"):
        tr = _small_trainer(dev, cinic, kind, row_exec)
        tr.run_round()
        runs[row_exec] = tr
    m, v = runs["map"], runs["vmap"]
    assert v.engine._program.graph is not None and v.engine.num_round_traces == 1
    assert m.engine.num_round_traces == 0
    assert m.engine.last_groups == v.engine.last_groups
    assert m.comm.round_log == v.comm.round_log
    err = max(float((m.params[k] - v.params[k]).abs().max()) for k in m.params)
    assert err <= 1e-4, err


def _cinic_width_round(dev, kind, row_exec, start, *, cudnn, opt, batch=10, gamma=4):
    """One round of CINIC-10's model at the paper's width
    (``cinic_cnn(10, 32, 3, 32)``, 32 x 32 x 3) on a 12-client federation,
    cuDNN on or off."""
    from repro_torch.core import AstraeaTrainer, FedAvgTrainer, LocalSpec
    from repro_torch.models.cnn import cinic_cnn
    common = dict(clients_per_round=8, local=LocalSpec(batch, 1), seed=0, device=dev,
                  init_params=start, row_exec=row_exec)
    fed = _cinic_federation()
    before = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = cudnn
    try:
        tr = FedAvgTrainer(cinic_cnn(10, 32, 3, 32), opt, fed, **common) \
            if kind == "fedavg" else \
            AstraeaTrainer(cinic_cnn(10, 32, 3, 32), opt, fed, gamma=gamma, alpha=0.67,
                           **common)
        tr.run_round()
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.enabled = before
    return tr


def _cinic_federation():
    from repro_torch.data.federated import CINIC_LIKE, partition
    return partition(dataclasses.replace(CINIC_LIKE, noise=0.5, distort=0.35),
                     num_clients=12, total_samples=300, test_samples=80, sizes="instagram",
                     global_dist="normal", local="random", seed=0)


def _flat(p, keys):
    return torch.cat([p[k].flatten().cpu() for k in keys])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fedavg", "astraea"])
def test_cudnn_vmap_round_equals_aten_map_round_at_cinic_width(dev, kind):
    """CINIC-10's model at the paper's width (``cinic_cnn(10, 32, 3, 32)``,
    32 x 32 x 3): a round with the rows in lockstep on cuDNN's
    convolutions (its default algorithms, the round captured as a CUDA
    graph) against the ``"map"`` oracle on ATen's convolutions
    (``examples/cudnn_algos.py`` measured them at most 1.7e-6 of the scale
    from float64 a convolution), from the same params and draws: equal
    schedules and WAN ledger.  The params cannot be held within 1e-4: the
    round's Adam steps carry the two paths' fp32 sums apart by 7.2e-4
    (FedAvg) and 1.3e-2 (Astraea) at the largest parameter (measured on an
    H100), as they carry the oracle from weights moved by 1e-7.  So the
    hold is that measurement's: in L2 over the round's own update, the
    ``"vmap"`` round lies no further from the oracle than twice the oracle
    lands from weights perturbed by 1e-7 (``chip_smoke.py`` phase 7's
    criterion, there with cuDNN on both paths).  The tight hold, before
    the steps compound, is the next test's."""
    from repro_torch.models.cnn import cinic_cnn, init_params
    from repro_torch.optim import adam
    init = init_params(cinic_cnn(10, 32, 3, 32), 0)
    gen = torch.Generator().manual_seed(7)
    noisy = {k: v + 1e-7 * torch.randn(v.shape, generator=gen) for k, v in init.items()}
    m = _cinic_width_round(dev, kind, "map", init, cudnn=False, opt=adam(1e-3))
    m_noisy = _cinic_width_round(dev, kind, "map", noisy, cudnn=False, opt=adam(1e-3))
    assert torch.backends.cudnn.enabled
    v = _cinic_width_round(dev, kind, "vmap", init, cudnn=True, opt=adam(1e-3))
    assert v.engine._program.graph is not None
    assert m.engine.last_groups == v.engine.last_groups
    assert m.comm.round_log == v.comm.round_log

    flat = lambda p: _flat(p, init)                                 # noqa: E731
    update = float((flat(m.params) - flat(init)).norm())
    rel = float((flat(v.params) - flat(m.params)).norm()) / update
    rel_noise = float((flat(m_noisy.params) - flat(m.params)).norm()) / update
    err = float((flat(v.params) - flat(m.params)).abs().max())
    print(f"{kind}: cuDNN vmap against ATen map: largest parameter difference {err:.3e}, "
          f"L2 {rel:.3e} of the update; the oracle from weights moved by 1e-7: {rel_noise:.3e}")
    assert rel <= 2 * rel_noise, (rel, rel_noise)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fedavg", "astraea"])
def test_cudnn_vmap_step_equals_aten_map_step_at_cinic_width(dev, kind):
    """The same CINIC-width rows before the steps compound: each row takes
    one local step (a client's whole data in one batch, one epoch; Astraea
    at gamma = 1 with the online plan, so a mediator row is one client's
    step) of plain SGD, so the round's update is the rows' gradients
    averaged and scaled.  ``"vmap"`` on cuDNN's deterministic algorithms
    (captured) against the ``"map"`` oracle on ATen's convolutions, in L2
    over the round's update: within 1e-4 (``examples/cudnn_algos.py``
    measured the two at most 1.7e-6 of the scale a convolution; the round
    here sits at 1.3e-6 (FedAvg) and 1.4e-6 (Astraea) on an H100).  A row
    trained on the wrong slot or a garbled augmentation changes that row's
    gradient outright, a share of the update far above 1e-4.  The hold
    meets its limit where the step crosses a ReLU kink: on the CPU,
    with ATen on both paths, Astraea's two row paths part by 1.3e-4 of the
    update after this step (a conv2a pre-activation within fp32 noise of
    0; nothing past conv2b moves)."""
    from repro_torch.models.cnn import cinic_cnn, init_params
    from repro_torch.optim import sgd
    fed = _cinic_federation()
    batch = max(x.shape[0] for x in fed.client_images)        # one step a client
    init = init_params(cinic_cnn(10, 32, 3, 32), 0)
    kw = dict(opt=sgd(0.05), batch=batch, gamma=1)
    m = _cinic_width_round(dev, kind, "map", init, cudnn=False, **kw)
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        v = _cinic_width_round(dev, kind, "vmap", init, cudnn=True, **kw)
    finally:
        torch.backends.cudnn.deterministic = before
    assert v.engine._program.graph is not None
    assert m.engine.last_groups == v.engine.last_groups
    assert m.comm.round_log == v.comm.round_log
    flat = lambda p: _flat(p, init)                                 # noqa: E731
    update = flat(m.params) - flat(init)
    diff = flat(v.params) - flat(m.params)
    rel = float(diff.norm() / update.norm())
    print(f"{kind}: one SGD step a row, cuDNN vmap against ATen map: L2 {rel:.3e} of the "
          f"update; largest parameter difference {float(diff.abs().max()):.3e}, "
          f"{float(diff.abs().max() / update.abs().max()):.3e} of the update's largest")
    assert rel <= 1e-4, rel


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fedavg", "astraea"])
def test_round_program_built_once_and_kernels_per_round(dev, kind):
    """Three FedAvg rounds (a fresh selection each) and three adaptive
    Astraea rounds (a fresh cohort, plan and Alg. 3 pass each): the round
    program is built and captured once; per round one Eq. 6 launch, one
    warp launch (the online plan) and, for Astraea, one greedy pass."""
    kw = {"alpha": 0.67} if kind == "fedavg" else \
        {"adaptive_plan": True, "reschedule_every_round": True}
    tr = _small_trainer(dev, False, kind, "vmap", **kw)
    plans = []
    for _ in range(3):
        ops.reset_launches()
        tr.run_round()
        torch.cuda.synchronize()
        assert ops.LAUNCHES["fedavg_agg"] == 1
        assert ops.LAUNCHES["affine_warp"] == 1
        assert ops.LAUNCHES["kld_greedy_picks"] == (kind == "astraea")
        plans.append(tr.engine.last_plan)
    assert tr.engine.num_round_traces == 1
    assert all(bool(torch.isfinite(p).all()) for p in tr.params.values())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fedavg", "astraea"])
def test_round_capture_holds_every_time(dev, kind):
    """Eight fresh CINIC trainers in a row, each capturing its round (a
    strict capture failed now and then at this width): every capture
    holds and every round's weights are finite."""
    for _ in range(8):
        tr = _small_trainer(dev, True, kind, "vmap")
        tr.run_round()
        assert tr.engine._program.graph is not None
        assert all(bool(torch.isfinite(p).all()) for p in tr.params.values())
        del tr


@pytest.mark.cuda
def test_failed_round_capture_raises(dev):
    """A local loss that synchronizes its stream runs eagerly but cannot be
    captured: the round raises instead of running eagerly."""
    from repro_torch.core.fl import masked_ce_loss

    def syncing_loss(model, params, x, y, mask, keep):
        torch.cuda.current_stream().synchronize()   # illegal inside a capture
        return masked_ce_loss(model, params, x, y, mask, keep)

    tr = _small_trainer(dev, False, "fedavg", "vmap", loss_fn=syncing_loss)
    with pytest.raises(RuntimeError, match="CUDA graph"):
        tr.run_round()


# ---------------------------------------------------------------- async rounds, stores, checkpoints

def _fleet():
    from repro_torch.core import StragglerSpec
    return StragglerSpec(model="fixed", straggler_frac=0.5, slowdown=4.0, seed=0)


@pytest.mark.cuda
@pytest.mark.parametrize("row_exec,dispatch", [("vmap", "masked"), ("map", "masked"),
                                               ("map", "overlapped")])
def test_async_s0_equals_sync_on_card(dev, row_exec, dispatch):
    """S=0, a wave per mediator behind a 4x straggler, two rounds on the
    card: bit for bit the sync run (masked: the sync round's graph, the
    rows outside a wave masked; "map": the same row program), the same
    WAN ledger; one Eq. 6 launch per commit, one warp per round."""
    from repro_torch.core import AsyncSpec
    sync = _small_trainer(dev, False, "astraea", row_exec)
    for _ in range(2):
        sync.run_round()
    spec = AsyncSpec(staleness_bound=0, wave_size=1, straggler=_fleet(), dispatch=dispatch)
    tr = _small_trainer(dev, False, "astraea", row_exec, async_spec=spec)
    ops.reset_launches()
    for _ in range(2):
        tr.run_round()
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fedavg_agg"] == tr.runner.num_commits == 2
    assert ops.LAUNCHES["affine_warp"] == 2
    assert all(torch.equal(tr.params[k], sync.params[k]) for k in sync.params)
    assert tr.comm.round_log == sync.comm.round_log


@pytest.mark.cuda
def test_one_graph_per_wave_width_on_card(dev):
    """A FedAvg cohort of 8 in waves of 3 (widths 3, 3, 2), overlapped: one
    captured graph per width, reused the next round; within 1e-4 of the
    sync run (S=0; the sliced programs batch other widths)."""
    from repro_torch.core import AsyncSpec
    spec = AsyncSpec(wave_size=3, straggler=_fleet(), dispatch="overlapped")
    tr = _small_trainer(dev, False, "fedavg", "vmap", async_spec=spec)
    sync = _small_trainer(dev, False, "fedavg", "vmap")
    tr.run_round()
    progs = dict(tr.engine._wave_programs)
    assert sorted(progs) == [2, 3] and all(p.graph is not None for p in progs.values())
    tr.run_round()
    for _ in range(2):
        sync.run_round()
    assert tr.engine._wave_programs == progs and tr.engine.num_round_traces == 2
    assert all(p.pool_bytes > 0 for p in progs.values())
    err = max(float((tr.params[k] - sync.params[k]).abs().max()) for k in sync.params)
    assert err <= 1e-4, err


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["host", "spilled"])
def test_pinned_store_equals_replicated_on_card(dev, policy):
    """A reschedule every round: the host and spilled stores (pinned
    staging, non-blocking copies on a copy stream) give the replicated
    store's params bit for bit, and charge U_cap rows per reschedule to
    the intra-pod ledger only."""
    kw = dict(reschedule_every_round=True)
    rep = _small_trainer(dev, False, "astraea", "vmap", **kw)
    tr = _small_trainer(dev, False, "astraea", "vmap", store=policy, **kw)
    for _ in range(3):
        rep.run_round()
        tr.run_round()
    store = tr.engine.store
    assert all(t.is_pinned() for t in store._staging[0] + store._staging[1])
    assert all(torch.equal(tr.params[k], rep.params[k]) for k in rep.params)
    assert tr.comm.round_log == rep.comm.round_log
    assert tr.comm.store_stream_bytes == 3 * sum(t.nbytes for t in store._dev) > 0


@pytest.mark.cuda
def test_checkpoint_round_trip_on_card(dev, tmp_path):
    """A CUDA trainer saved after two rounds and loaded into a fresh one:
    params bit for bit on the card, and round 3 equal to the uninterrupted
    run's; a tree of bf16 CUDA tensors written and read back bit for bit."""
    from repro_torch.core import load_pytree, load_trainer, save_pytree, save_trainer
    tr = _small_trainer(dev, False, "astraea", "vmap")
    for _ in range(2):
        tr.run_round()
    path = str(tmp_path / "tr.ckpt")
    save_trainer(path, tr)
    fresh = load_trainer(path, _small_trainer(dev, False, "astraea", "vmap"))
    assert all(v.device.type == "cuda" for v in fresh.params.values())
    assert all(torch.equal(fresh.params[k], tr.params[k]) for k in tr.params)
    tr.run_round()
    fresh.run_round()
    assert all(torch.equal(fresh.params[k], tr.params[k]) for k in tr.params)
    g = torch.Generator(device=dev).manual_seed(0)
    tree = {"w": torch.randn(64, 48, generator=g, device=dev).to(torch.bfloat16),
            "b": [torch.randn(48, generator=g, device=dev).to(torch.bfloat16)]}
    save_pytree(str(tmp_path / "bf16.ckpt"), tree)
    back = load_pytree(str(tmp_path / "bf16.ckpt"))
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], tree["w"].cpu()) and torch.equal(back["b"][0],
                                                                   tree["b"][0].cpu())


# ---------------------------------------------------------------- LoRA rounds and telemetry

@pytest.fixture
def deterministic_convolutions():
    """cuDNN's deterministic algorithms for runs held to each other bit for
    bit (its default ones are not deterministic at every width)."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = before


def _emnist_full_trainer(dev, row_exec, **kw):
    """Astraea at ``chip_smoke.py``'s EMNIST arm: ``emnist_cnn(47, 28)``
    (68,873 parameters), 64 clients, c=16, gamma=4, B=20, E=2, Adam 1e-3,
    alpha=0.67 online, seed 0."""
    from repro_torch.core import AstraeaTrainer, LocalSpec
    from repro_torch.data.federated import EMNIST_LIKE, partition
    from repro_torch.models.cnn import emnist_cnn
    from repro_torch.optim import adam
    fed = partition(dataclasses.replace(EMNIST_LIKE, num_classes=47), num_clients=64,
                    total_samples=6400, test_samples=2350, sizes="instagram",
                    global_dist="letterfreq", local="random", seed=0)
    return AstraeaTrainer(emnist_cnn(47, 28), adam(1e-3), fed, clients_per_round=16,
                          gamma=4, local=LocalSpec(20, 2), alpha=0.67, seed=0, device=dev,
                          row_exec=row_exec, **kw)


@pytest.mark.cuda
def test_lora_vmap_round_equals_map_round_at_emnist_width(dev, plain_convolutions):
    """A rank-2 round at EMNIST's full width (753 adapter values): under
    "vmap" one program, captured once, with one Eq. 6 launch over the
    adapter rows; within 1e-4 of the same round row by row, eagerly, both
    through ATen's convolutions."""
    runs = {}
    for row_exec in ("map", "vmap"):
        tr = _emnist_full_trainer(dev, row_exec, lora_rank=2)
        ops.reset_launches()
        tr.run_round()
        torch.cuda.synchronize()
        assert ops.LAUNCHES["fedavg_agg"] == 1
        runs[row_exec] = tr
    m, v = runs["map"].engine, runs["vmap"].engine
    assert v._program.graph is not None and v.num_round_traces == 1
    assert v._layout.total == 753 and v._rows.shape == (4, 753)
    assert m.comm.round_log == v.comm.round_log
    err = max(float((m.adapters[k] - v.adapters[k]).abs().max()) for k in m.adapters)
    assert err <= 1e-4, err


@pytest.mark.cuda
@pytest.mark.parametrize("row_exec", ["vmap", "map"])
@pytest.mark.parametrize("kind", ["fedavg", "astraea"])
def test_lora_full_rank_is_the_full_delta_round_on_card(dev, deterministic_convolutions,
                                                        kind, row_exec):
    """At full rank (24 for the small EMNIST model) every entry is dense:
    two rounds give the full-delta run's weights bit for bit on the card
    (Eq. 6's kernel over the adapter layout's columns; the same cuDNN
    settings for both)."""
    from repro_torch.models import lora
    from repro_torch.models.cnn import emnist_cnn
    full = lora.full_rank(emnist_cnn(8, 16).param_specs())
    ref_tr = _small_trainer(dev, False, kind, row_exec)
    tr = _small_trainer(dev, False, kind, row_exec, lora_rank=full)
    for _ in range(2):
        ref_tr.run_round()
        tr.run_round()
    merged = tr.engine.merged_params()
    assert all(torch.equal(merged[k], ref_tr.params[k]) for k in ref_tr.params)
    assert tr.comm.adapter_reduction_ratio == 1.0
    assert tr.comm.round_log == ref_tr.comm.round_log


@pytest.mark.cuda
@pytest.mark.parametrize("row_exec", ["vmap", "map"])
def test_lora_rank0_launches_no_eq6(dev, row_exec):
    """Rank 0: the rounds run (the "vmap" program captured over an empty
    trained tree), launch no Eq. 6 kernel, and leave the backbone
    untouched; no WAN leg carries a byte (the ledger holds the Alg. 2 plan
    broadcast alone)."""
    tr = _small_trainer(dev, False, "astraea", row_exec, lora_rank=0)
    before = {k: v.clone() for k, v in tr.params.items()}
    plan = tr.comm.total_bytes
    ops.reset_launches()
    for _ in range(2):
        tr.run_round()
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fedavg_agg"] == 0 and ops.LAUNCHES["affine_warp"] == 2
    assert tr.engine.adapters == {} and tr.comm.wan_adapter_bytes == 0
    assert plan > 0 and tr.comm.round_log == [plan, plan]
    assert tr.comm.adapter_reduction_ratio == 0.0
    assert all(torch.equal(before[k], tr.params[k]) for k in before)
    if row_exec == "vmap":
        assert tr.engine.num_round_traces == 1 and tr.engine._program.graph is not None


@pytest.mark.cuda
@pytest.mark.parametrize("lora_rank", [None, 2])
@pytest.mark.parametrize("async_bound", [None, 0])
def test_telemetry_on_card_adds_no_capture(dev, deterministic_convolutions, tmp_path,
                                           async_bound, lora_rank):
    """Spans (waiting on the card at their close) on against off, sync and
    async S=0: bit for bit the same trained state, the same round
    programs, each captured once; the events valid."""
    from repro_torch.core import AsyncSpec
    from repro_torch.obs import Telemetry, load_jsonl, validate_events
    kw = {"lora_rank": lora_rank}
    if async_bound is not None:
        kw["async_spec"] = AsyncSpec(staleness_bound=async_bound, wave_size=1,
                                     straggler=_fleet())
    off = _small_trainer(dev, False, "astraea", "vmap", **kw)
    tel = Telemetry(str(tmp_path), profile=True)
    on = _small_trainer(dev, False, "astraea", "vmap", telemetry=tel, **kw)
    for _ in range(2):
        off.run_round()
        on.run_round()
    a, b = off.engine.server_state, on.engine.server_state
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert off.engine.num_round_traces == on.engine.num_round_traces == 1
    assert [t["reason"] for t in on.engine.trace_log] == ["initial"]
    events = load_jsonl(tel.flush()["events_jsonl"])
    validate_events(events)
    assert sum(e["name"] == "round" for e in events) == 2


# ---------------------------------------------------------------- training

# (b, sq, skv, H, KV, d, causal, window, q_offset): the reduced configs'
# layer (d=64), qwen3-4b's training layer (d=128, GQA 4:1), danube's head
# (d=80) under a window, gemma's (d=256, MQA 8:1), ragged tiles with a
# q_offset, no causal mask, rows that see no key (window + offset), and
# gemma's heads over 1,024 positions (many query tiles a key tile, so the
# fp32 (Q, dO) ring wraps many times and the head split's partials are summed)
BWD_CARD_CASES = [(2, 64, 64, 4, 4, 64, True, None, 0),
                  (4, 128, 128, 32, 8, 128, True, None, 0),
                  (1, 300, 300, 32, 8, 80, True, 96, 0),
                  (2, 256, 256, 8, 1, 256, True, None, 0),
                  (1, 70, 131, 4, 2, 64, True, 50, 61),
                  (1, 45, 77, 6, 3, 128, False, None, 0),
                  (1, 40, 40, 2, 1, 80, True, 8, 45),
                  (1, 1024, 1024, 8, 1, 256, True, None, 0),
                  # the MoE, audio and VLM training layers (4 x 128, d=64):
                  # whisper's encoder over 1,536 frames and its
                  # cross-attention (non-causal, 128 queries over them),
                  # granite's GQA 24:8, internvl2's 14:2
                  (4, 1536, 1536, 8, 8, 64, False, None, 0),
                  (4, 128, 1536, 8, 8, 64, False, None, 0),
                  (4, 128, 128, 24, 8, 64, True, None, 0),
                  (4, 128, 128, 14, 2, 64, True, None, 0)]


def _bwd_inputs(dev, dtype, case, seed):
    b, sq, skv, h, kv, d, causal, window, off = case
    g = torch.Generator(device=dev).manual_seed(seed)
    q, dout = (torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn(b, skv, kv, d, generator=g, device=dev).to(dtype) for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=off)
    return q, k, v, ref.flash_attention(q, k, v, **kw).to(dtype).contiguous(), dout, kw


def _bf16_bwd_over_bound(got, exact) -> float:
    """The largest of each bf16 gradient's max |error| over its card bound,
    2^-7 of the exact gradient's largest magnitude: the tensor-core kernel
    rounds P and dS to bf16 before their products (an emulation of that
    arithmetic, tests/test_torch_train.py, stays within 0.62 of it)."""
    worst = 0.0
    for g, e in zip(got, exact):
        assert g.dtype == torch.bfloat16
        scale = max(float(e.abs().max()), 1e-30)
        worst = max(worst, float((g.float() - e).abs().max()) / (2 ** -7 * scale))
    return worst


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BWD_CARD_CASES)
def test_flash_attention_bwd_kernel(dev, dtype, case):
    """One launch; fp32: each gradient within 1e-5 of its scale of the
    plain version (fp32 sums in other orders); bf16: each gradient within
    2^-7 of its largest magnitude of the plain version in fp32 on the same
    bf16 inputs (P and dS rounded to bf16 on the tensor cores)."""
    q, k, v, out, dout, kw = _bwd_inputs(dev, dtype, case, sum(case[:6]))
    before = ops.LAUNCHES["flash_attention_bwd"]
    got = ops.flash_attention_bwd(q, k, v, out, dout, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention_bwd"] == before + 1
    if dtype == torch.float32:
        for g, p in zip(got, ref.flash_attention_bwd(q, k, v, out, dout, **kw)):
            err, scale = _err_scale(g, p)
            assert err <= 1e-5 * scale
        return
    exact = ref.flash_attention_bwd(*(t.float() for t in (q, k, v, out, dout)), **kw)
    assert _bf16_bwd_over_bound(got, exact) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 80, 128, 256])
def test_flash_attention_forward_lse(dev, dtype, d):
    """The forward's log-sum-exp (the autograd path asks for it) against
    the plain ``ref.flash_attention_lse`` on the same inputs, within 1e-5
    of 1 + |lse| (fp32 sums in other orders); +inf on the rows that see no
    key (window 8, offset 45: rows 2.. see none); the output is the one the
    call without lse gives, bit for bit."""
    for case in ((1, 40, 40, 2, 1, d, True, 8, 45), (2, 130, 200, 4, 2, d, True, 70, 50)):
        q, k, v, _, _, kw = _bwd_inputs(dev, dtype, case, d + case[1])
        before = ops.LAUNCHES["flash_attention"]
        out, lse = ops._flash_forward(q, k, v, kw["causal"], kw["window"], kw["q_offset"],
                                      with_lse=True)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["flash_attention"] == before + 1
        assert torch.equal(out, ops.flash_attention(q, k, v, **kw))
        plain = ref.flash_attention_lse(q.float(), k.float(), **kw)
        none = torch.isinf(plain)
        assert bool(torch.equal(torch.isinf(lse), none)) and bool((lse[none] > 0).all())
        if case[7] == 8:
            assert bool(none[:, :, 2:].all()) and not bool(none[:, :, :2].any())
        gap = (lse[~none] - plain[~none]).abs()
        assert bool((gap <= 1e-5 * (1 + plain[~none].abs())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", [BWD_CARD_CASES[1], BWD_CARD_CASES[2], BWD_CARD_CASES[6]])
def test_flash_attention_bwd_autograd_lse_matches_direct_call(dev, case):
    """bf16: the autograd path (the forward's lse handed to the backward) and
    the direct call (the wrapper runs the forward kernel for lse first) give
    the same bits, within the bf16 bound against the exact gradients; one
    launch of each kernel either way."""
    q, k, v, _, dout, kw = _bwd_inputs(dev, torch.bfloat16, case, 11)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(ops.LAUNCHES)
    fwd = ops.flash_attention(*leaves, **kw)
    grads = torch.autograd.grad(fwd, leaves, dout)
    assert ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert ops.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    before = dict(ops.LAUNCHES)
    direct = ops.flash_attention_bwd(q, k, v, fwd.detach(), dout, **kw)
    assert ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert ops.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    exact = ref.flash_attention_bwd(*(t.float() for t in (q, k, v, fwd.detach(), dout)), **kw)
    assert all(torch.equal(g, dg) for g, dg in zip(grads, direct))
    assert _bf16_bwd_over_bound(grads, exact) <= 1.0


@pytest.mark.cuda
def test_flash_attention_bwd_split_partials_are_bitwise(dev):
    """gemma's MQA 8:1 layer shape (d=256) and qwen3-4b's GQA 4:1 at d=128,
    in bf16 and fp32: each split of the query heads (fp32 partials per
    split, summed in split order by a second pass; the launch's private
    split argument) gives the same bits in two runs and stays within the
    dtype's bound (bf16: 2^-7 of each gradient's largest magnitude; fp32:
    1e-5 of its scale of the plain version)."""
    for dtype in (torch.bfloat16, torch.float32):
        for case, splits in (((1, 256, 256, 8, 1, 256, True, None, 0), (1, 2, 4, 8)),
                             ((2, 200, 200, 8, 2, 128, True, None, 0), (1, 2, 4))):
            q, k, v, out, dout, kw = _bwd_inputs(dev, dtype, case, 3)
            exact = ref.flash_attention_bwd(*(t.float() for t in (q, k, v, out, dout)), **kw)
            _, lse = ops._flash_forward(q, k, v, kw["causal"], kw["window"], kw["q_offset"],
                                        with_lse=True)
            for split in splits:
                first = ops._flash_bwd_launch(q, k, v, out, dout, lse, split, **kw)
                second = ops._flash_bwd_launch(q, k, v, out, dout, lse, split, **kw)
                assert all(torch.equal(a, b) for a, b in zip(first, second)), (dtype, split)
                if dtype == torch.bfloat16:
                    assert _bf16_bwd_over_bound(first, exact) <= 1.0, split
                    continue
                for g, e in zip(first, exact):
                    err, scale = _err_scale(g, e)
                    assert err <= 1e-5 * scale, split
        with pytest.raises(ValueError, match="split"):
            ops._flash_bwd_launch(q, k, v, out, dout, lse, 3, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel_is_bitwise_deterministic(dev, dtype):
    """No atomics: two runs (and a run through autograd) agree bit for bit,
    the KV heads' sums over their query heads included."""
    q, k, v, out, dout, kw = _bwd_inputs(dev, dtype, BWD_CARD_CASES[1], 5)
    first = ops.flash_attention_bwd(q, k, v, out, dout, **kw)
    second = ops.flash_attention_bwd(q, k, v, out, dout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(ops.LAUNCHES)
    fwd = ops.flash_attention(*leaves, **kw)
    grads = torch.autograd.grad(fwd, leaves, dout)
    assert ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert ops.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    _, lse = ops._flash_forward(q, k, v, kw["causal"], kw["window"], kw["q_offset"],
                                with_lse=True)
    third = ops.flash_attention_bwd(q, k, v, fwd.detach(), dout, lse=lse, **kw)
    assert all(torch.equal(a, b) for a, b in zip(grads, third))


@pytest.mark.cuda
def test_flash_attention_bwd_kernel_refuses_other_head_dims(dev):
    q, k, v = (torch.randn(1, 16, 2, 96, device=dev) for _ in range(3))
    before = ops.LAUNCHES["flash_attention_bwd"]
    with pytest.raises(ValueError, match="head dim 96"):
        ops.flash_attention_bwd(q, k, v, q, q)
    assert ops.LAUNCHES["flash_attention_bwd"] == before


def _training_on_card_matches_cpu(dev, cfg, monkeypatch):
    """``forward_train`` of a reduced config (f32 weights from one seed,
    each stacked layer matrix but the conv taps -- an expert's 3-D weights
    and the audio encoder's too -- rescaled from the reference init's
    ``1/sqrt(L)`` to ``1/sqrt(d_in)``; LayerNorm scales set to 1, as the
    reference's init zeroes them; a VLM's vision embeddings and an audio
    model's frames standard normal from a second seed) on the card and on
    the CPU: one forward and one backward flash launch per attention layer
    (an audio model's encoder and cross-attention layers included) and one
    forward and one backward SSD launch per SSM layer on the card; an MoE
    layer's top-k experts the same on both (checked first, so a flip of a
    near tie fails as a route, not as a gradient; the smallest gap between
    a token's k-th and (k+1)-th router probability is printed); the loss
    within 1e-5 and every gradient within 1e-3 of its scale (fp32 sums in
    other orders); for the families whose round takes tokens alone, a
    two-step SGD round of ``make_fl_round`` on both within 1e-3 of each
    leaf's update scale.  The rescale: at the reference's own init the CPU
    round alone, from weights perturbed by 1e-7, moves by up to 9.4e-2 of
    the embedding's update scale (danube, window 16, two steps, five
    perturbations), so card-vs-CPU agreement there tests nothing; at the
    standard fan-in that spread is at most 4.7e-5
    (``tests/test_torch_train.py::_perturbation_spread``).  Seq 64, 128 for
    the SSD families (two chunks, so the recurrence carries a gradient)."""
    from repro_torch.launch import steps as S
    from repro_torch.models import moe as moe_lib
    cpu = T.init_model(cfg, torch.Generator().manual_seed(0))
    stacks = {"layers": cfg.n_layers, "encoder": cfg.encoder_layers}
    with torch.no_grad():                  # the standard fan-in (see the docstring)
        for name, p in cpu.named_parameters():
            n, leaf = stacks.get(name.split(".", 1)[0]), name.rsplit(".", 1)[-1]
            if n and p.dim() >= 2 and leaf != "conv_w":
                p.mul_((n / p.shape[-2]) ** 0.5)
            if cfg.norm == "ln" and leaf in ("norm1", "norm2", "norm_x", "final_norm",
                                             "enc_final_norm"):
                p.fill_(1.0)
    card = T.Transformer(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    seq = 128 if cfg.has_ssm else 64
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (4, seq), generator=gen)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    if cfg.arch_type == "vlm":
        batch["vision_embeds"] = torch.randn(4, cfg.vision_tokens, cfg.d_model, generator=gen)
    if cfg.arch_type == "audio":
        batch["enc_feats"] = torch.randn(4, cfg.source_positions, cfg.d_model, generator=gen)
    dbatch = {k: t.to(dev) for k, t in batch.items()}
    routes = {"cpu": [], "card": []}
    route = moe_lib._route

    def recording(side):
        def rec(probs, top_k, capacity):
            out = route(probs, top_k, capacity)
            top = torch.topk(probs.detach(), top_k + 1, dim=-1).values
            routes[side].append((out[1].cpu(), float((top[..., -2] - top[..., -1]).min())))
            return out
        return rec

    monkeypatch.setattr(moe_lib, "_route", recording("cpu"))
    lc, gc = S._loss_and_grads(lambda p: T.forward_train(cpu, batch, p)[0], T.train_params(cpu))
    monkeypatch.setattr(moe_lib, "_route", recording("card"))
    ops.reset_launches()
    lg, gg = S._loss_and_grads(lambda p: T.forward_train(card, dbatch, p)[0],
                               T.train_params(card))
    torch.cuda.synchronize()
    monkeypatch.setattr(moe_lib, "_route", route)
    cross = cfg.n_layers if cfg.arch_type == "audio" else 0
    attn = cfg.n_layers + cfg.encoder_layers + cross if cfg.has_attention else 0
    ssm = cfg.n_layers if cfg.has_ssm else 0
    assert ops.LAUNCHES["flash_attention"] == ops.LAUNCHES["flash_attention_bwd"] == attn
    assert ops.LAUNCHES["ssd_chunk"] == ops.LAUNCHES["ssd_chunk_bwd"] == ssm
    assert len(routes["cpu"]) == len(routes["card"]) == (cfg.n_layers if cfg.is_moe else 0)
    for (ec, margin), (eg, _) in zip(routes["cpu"], routes["card"]):
        assert torch.equal(ec, eg), f"a top-k route differs (smallest gap {margin:.3e})"
    if cfg.is_moe:
        print(f"{cfg.name}: smallest gap between a token's k-th and (k+1)-th router "
              f"probability {min(m for _, m in routes['cpu']):.3e}")
    assert abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc))
    for name, g in gc.items():
        err, scale = _err_scale(gg[name].cpu(), g)
        assert err <= 1e-3 * scale, name
    if cfg.arch_type in ("vlm", "audio"):    # their round takes no frames or vision tokens
        return
    w = torch.full((4,), float(seq))
    rc = S.make_fl_round(cpu, 1, learning_rate=0.05, local_steps=2)(
        T.train_params(cpu), batch["tokens"], batch["labels"], w)
    rg = S.make_fl_round(card, 1, learning_rate=0.05, local_steps=2)(
        T.train_params(card), dbatch["tokens"], dbatch["labels"], w.to(dev))
    start = T.train_params(cpu)
    for name, p in rc.items():
        d_cpu, d_card = p - start[name], rg[name].cpu() - start[name]
        assert float((d_card - d_cpu).abs().max()) <= 1e-3 * float(d_cpu.abs().max()) + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("arch,upd", [("qwen3-4b", {}),
                                      ("h2o-danube-1.8b", {"sliding_window": 16})])
def test_reduced_dense_training_on_card_matches_cpu(dev, arch, upd, monkeypatch):
    _training_on_card_matches_cpu(
        dev, dataclasses.replace(configs.reduced(configs.get(arch)), **upd), monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-370m"])
def test_reduced_ssm_training_on_card_matches_cpu(dev, arch, monkeypatch):
    _training_on_card_matches_cpu(dev, configs.reduced(configs.get(arch)), monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "whisper-base", "internvl2-1b"])
def test_reduced_zoo_training_on_card_matches_cpu(dev, arch, monkeypatch):
    _training_on_card_matches_cpu(dev, configs.reduced(configs.get(arch)), monkeypatch)


@pytest.mark.cuda
def test_moe_backward_is_bitwise_deterministic(dev):
    """granite-moe-3b-a800m's MoE layer at full width in bf16 (4 x 128
    tokens, one group of 512, 40 experts top 8, d 1,536, f 512): forward
    and backward twice give the same bits in every gradient (a token's
    gradient gathers its 8 buffer rows' and sums them in fp32 in one
    order; autograd's ``index_select`` backward would add them by atomics
    in bf16), all finite and none zero."""
    from repro_torch.models import moe as moe_lib
    cfg = configs.get("granite-moe-3b-a800m")
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    x = torch.randn(4, 128, d, generator=g, device=dev).to(bf)
    router = torch.randn(d, E, generator=g, device=dev) / d ** 0.5
    w_gate, w_up = ((torch.randn(E, d, f, generator=g, device=dev) / d ** 0.5).to(bf)
                    for _ in range(2))
    w_down = (torch.randn(E, f, d, generator=g, device=dev) / f ** 0.5).to(bf)
    dy = torch.randn(4, 128, d, generator=g, device=dev).to(bf)

    def grads():
        leaves = [t.clone().requires_grad_(True) for t in (x, router, w_gate, w_up, w_down)]
        y, aux = moe_lib.moe_glu(*leaves, top_k=cfg.top_k, group_size=cfg.moe_group,
                                 capacity_factor=cfg.capacity_factor)
        return torch.autograd.grad((y.float() * dy.float()).sum() + 0.01 * aux, leaves)

    first, second = grads(), grads()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
        assert bool(a.isfinite().all()) and bool(a.abs().max() > 0)


# ---------------------------------------------------------------- step-cost counter

@pytest.mark.cuda
def test_counter_on_card_still_launches_the_kernel(dev):
    """Under ``step_costs`` a CUDA call launches its kernel (one more
    ``LAUNCHES``), is charged once by its analytic cost, and its result is
    the kernel's."""
    from repro_torch.roofline import model as RM
    from repro_torch.roofline import step_costs
    g = torch.Generator(device=dev).manual_seed(0)
    d = torch.randn(16, 68_873, generator=g, device=dev)
    w = torch.rand(16, generator=g, device=dev)
    before = ops.LAUNCHES["fedavg_agg"]
    c = step_costs(ops.fedavg_agg, d, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fedavg_agg"] == before + 1
    cost = RM.fedavg_agg_cost(16, 68_873, 4, 4)
    assert c.kernels == {"fedavg_agg": {"launches": 1, "flops": cost.flops,
                                        "bytes": cost.bytes_accessed}}
    assert c.by_op == {}
    torch.testing.assert_close(c.result.double(), ref.fedavg_agg(d, w).double(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,b,s", [("qwen3-4b", 2, 64), ("hymba-1.5b", 1, 64)])
def test_card_step_count_equals_meta_count(dev, arch, b, s):
    """One reduced AdamW step counted on the card (the flash and SSD
    kernels, forward and backward) and the same step on meta: equal FLOPs
    and kernel charges, and the card's launches are the charges."""
    from repro_torch.launch import steps
    from repro_torch.optim import adam
    from repro_torch.roofline import step_costs
    cfg = configs.reduced(configs.get(arch))
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=torch.Generator().manual_seed(0),
                           dtype=torch.int32)
    counted = {}
    for where in ("cuda", "meta"):
        if where == "cuda":
            model = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        else:
            model = T.Transformer(cfg, device="meta")
        params = T.train_params(model)
        opt = adam(1e-3)
        state = opt.init(params)
        batch = {"tokens": tokens.to(where), "labels": tokens.to(where)}
        ops.reset_launches()
        counted[where] = step_costs(steps.make_train_step(model, opt), params, state, batch)
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        assert launches == (counted[where].launches if where == "cuda" else {})
    card, meta = counted["cuda"], counted["meta"]
    assert card.kernels == meta.kernels
    assert card.flops == meta.flops
    assert torch.isfinite(card.result[2])


# ---------------------------------------------------------------- the model axis

def _model_axis_mesh(dev, mediator=2, model=2):
    from repro_torch.launch.mesh import make_fl_mesh
    return make_fl_mesh(mediator=mediator, model=model, devices=(dev,) * (mediator * model))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["replicated", "sharded", "host", "lora", "async"])
def test_model_axis_2x2_vmap_bitwise_4x1_on_card(dev, deterministic_convolutions, case):
    """Under the gather oracle the 2 x 2 mesh of four logical positions on
    the card is the mesh without a model axis over as many mediator rows
    (2 x 1: each row a round program of ``M_pad / 2`` rows on both, as a
    lockstep program's bits follow its width) bit for bit at the EMNIST
    width under "vmap" (one capture a mediator row), two rounds with a
    reschedule each, for the replicated, sharded and host stores, with
    LoRA adapters (rank 2) and async S=0 (a wave per mediator, masked);
    the split leaves' bytes a position halve against the 4 x 1 run's, the
    WAN ledger is equal and only the 2 x 2 run charges the model axis."""
    from repro_torch.core import AsyncSpec, StragglerSpec
    kw = {"store": case} if case in ("replicated", "sharded", "host") else {}
    if case == "lora":
        kw["lora_rank"] = 2
    if case == "async":
        kw["async_spec"] = AsyncSpec(staleness_bound=0, wave_size=1, dispatch="masked",
                                     straggler=StragglerSpec(model="fixed", seed=0))
    runs = {}
    for name, mesh in (("2x2", _model_axis_mesh(dev)), ("2x1", _model_axis_mesh(dev, 2, 1)),
                       ("4x1", _model_axis_mesh(dev, 4, 1))):
        tr = _emnist_full_trainer(dev, "vmap", mesh=mesh, tp_rows=False,
                                  reschedule_every_round=True, **kw)
        tr.run_round()
        tr.run_round()
        if tr.runner is not tr.engine:
            tr.runner.flush()
        torch.cuda.synchronize()
        n = mesh.shape["mediator"]
        assert tr.engine.num_round_traces == n
        assert [p.graph is not None for p in tr.engine._programs] == [True] * n
        runs[name] = tr
    a, b, c = runs["2x2"].engine, runs["2x1"].engine, runs["4x1"].engine
    for k in b.params:
        assert torch.equal(a.params[k], b.params[k]), k
    for k in (b.adapters or {}):
        assert torch.equal(a.adapters[k], b.adapters[k]), k
    for k, dim in a._dims.items():
        want = c.params[k].nbytes // (2 if dim is not None else 1)
        assert a._shards.positions[0][k].nbytes == want, k
    assert a.comm.round_log == b.comm.round_log == c.comm.round_log
    assert a.comm.model_axis_tp_bytes > 0 == b.comm.model_axis_tp_bytes


@pytest.mark.cuda
@pytest.mark.parametrize("row_exec", ["vmap", "map"])
def test_model_axis_tp_rows_match_oracle_on_card(dev, deterministic_convolutions, row_exec):
    """``tp_rows="auto"`` is TP rows on the card; at the reference's own
    config (``tests/test_tp_rows.py``: the tiny federation, 12 clients, 8
    classes, 16 px, c=6, gamma=3, B=10, E=1) their params after two rounds
    are the gather oracle's within the reference's bound (rtol 1e-5, atol
    1e-6), one capture a mediator row under "vmap".  (At the EMNIST arm's width a few
    small elements of ``dense1.weight`` fall outside that elementwise
    bound: ``chip_smoke.py`` phase 15 (a) holds TP rows there to 1e-5 of
    the update in L2.)"""
    from repro_torch.core import EngineConfig, FLRoundEngine, LocalSpec
    from repro_torch.data.federated import EMNIST_LIKE, partition
    from repro_torch.models.cnn import emnist_cnn
    from repro_torch.optim import adam
    fed = partition(dataclasses.replace(EMNIST_LIKE, num_classes=8, image_size=16),
                    num_clients=12, total_samples=600, test_samples=160, sizes="instagram",
                    global_dist="letterfreq", local="random", seed=0)
    runs = {}
    for mode in ("auto", False):
        cfg = EngineConfig.astraea(clients_per_round=6, gamma=3, local=LocalSpec(10, 1),
                                   seed=0, pad_mediators_to=2, row_exec=row_exec,
                                   tp_rows=mode)
        e = FLRoundEngine(emnist_cnn(8, 16), adam(1e-3), fed, cfg,
                          mesh=_model_axis_mesh(dev), device=dev)
        e.run_round()
        e.run_round()
        torch.cuda.synchronize()
        runs[mode] = e
    tp, oracle = runs["auto"], runs[False]
    assert tp._tp_rows is True and oracle._tp_rows is False
    assert tp.num_round_traces == (2 if row_exec == "vmap" else 0)     # one a mediator row
    for k in oracle.params:
        torch.testing.assert_close(tp.params[k], oracle.params[k], rtol=1e-5, atol=1e-6,
                                   msg=k)


# the qwen3-4b-shaped TP layer's gradients against the whole layer's, in L2
# over all its weights: bf16 sums reordered at 2,560 and 9,728 wide read
# 3.382e-3 on an H100 (700 W); a zero gradient reads 1, a negated one 2
TP_LAYER_GRAD_BOUND = 2 ** -6


@pytest.mark.cuda
def test_model_axis_qwen3_tp_layer_flash_on_card(dev):
    """A qwen3-4b-shaped decoder layer (d 2,560, 32:8 heads at 128, d_ff
    9,728; bf16) tensor-parallel over two logical positions against the
    whole layer at 1 x 128: each position's flash runs at 16:4 heads
    (forward and backward, one launch each a position), held against the
    plain versions (bf16: 2^-7 of the largest magnitude); the layer's
    output within 2^-6 of its scale, and its gradients in every weight,
    the shards put together, within ``TP_LAYER_GRAD_BOUND`` of the whole
    layer's in L2 over all of them (a zero gradient reads 1, a negated one
    2)."""
    from repro_torch.launch import model_axis, sharding
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_fl_mesh
    cfg = dataclasses.replace(configs.get("qwen3-4b"), n_layers=1, vocab=512, remat=False)
    model = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    params = T.train_params(model)
    mesh = make_fl_mesh(mediator=1, model=2, devices=(dev, dev))
    dims = sharding.placements(T.param_specs(cfg), mesh)
    tp = T.TensorParallel(model, dims, (dev, dev), dev)
    tree = model_axis.split_tree(params, dims, (dev, dev))
    g = torch.Generator(device=dev).manual_seed(1)
    h = torch.randn(1, 128, cfg.d_model, generator=g, device=dev).to(torch.bfloat16)
    pos = torch.arange(128, device=dev)[None]
    layer, pre = model.layers[0], "layers.0."

    def tp_layer(t):
        whole, par = tp.bind(t)
        bound = {k[len(pre):]: v for k, v in whole.items() if k.startswith(pre)}
        return torch.func.functional_call(layer, bound, (h, pos),
                                          {"mode": "train", "cache": None, "par": par})[0]

    def whole_layer(p):
        bound = {k[len(pre):]: v for k, v in p.items() if k.startswith(pre)}
        return torch.func.functional_call(layer, bound, (h, pos),
                                          {"mode": "train", "cache": None})[0]

    seen = []
    flash, flash_bwd = ops.flash_attention, ops.flash_attention_bwd

    def rec(q, k, v, **kw):
        seen.append(("fwd", tuple(q.shape), tuple(k.shape)))
        return flash(q, k, v, **kw)

    def rec_bwd(q, k, v, out, dout, **kw):
        seen.append(("bwd", tuple(q.shape), tuple(k.shape)))
        return flash_bwd(q, k, v, out, dout, **kw)

    ops.flash_attention, ops.flash_attention_bwd = rec, rec_bwd
    try:
        ops.reset_launches()
        loss, grads = S._loss_and_grads(lambda t: tp_layer(t).float().square().mean(), tree)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
    finally:
        ops.flash_attention, ops.flash_attention_bwd = flash, flash_bwd
    with torch.no_grad():
        whole = model.layers[0](h, pos, mode="train", cache=None)[0]
        got = tp_layer(tree)
    _, want_grads = S._loss_and_grads(lambda p: whole_layer(p).float().square().mean(),
                                      {k: v for k, v in params.items() if k.startswith(pre)})
    assert launches["flash_attention"] == launches["flash_attention_bwd"] == 2
    assert sorted(set(seen)) == [("bwd", (1, 128, 16, 128), (1, 128, 4, 128)),
                                 ("fwd", (1, 128, 16, 128), (1, 128, 4, 128))]
    scale = float(whole.float().abs().max())
    assert float((got.float() - whole.float()).abs().max()) <= 2 ** -6 * scale
    q = torch.randn(1, 128, 16, 128, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(1, 128, 4, 128, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(1, 128, 4, 128, generator=g, device=dev).to(torch.bfloat16)
    dout = torch.randn(1, 128, 16, 128, generator=g, device=dev).to(torch.bfloat16)
    out = ops.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention(q.float(), k.float(), v.float(), causal=True)
    assert float((out.float() - want).abs().max()) <= 2 ** -7 * float(want.abs().max())
    got_g = ops.flash_attention_bwd(q, k, v, out, dout, causal=True)
    want_g = ref.flash_attention_bwd(q.float(), k.float(), v.float(), want, dout.float(),
                                     causal=True)
    for a, b in zip(got_g, want_g):
        assert float((a.float() - b).abs().max()) <= 2 ** -7 * float(b.abs().max())
    assert all(torch.isfinite(x).all() for x in grads.values())
    err = norm = 0.0
    for k, want_g in want_grads.items():
        d = dims[k]
        got_g = grads[k] if d is None else torch.cat([grads[f"{k}@{j}"] for j in range(2)], d)
        err += float((got_g.float() - want_g.float()).square().sum())
        norm += float(want_g.float().square().sum())
    rel = (err / norm) ** 0.5
    print(f"TP layer gradients: {rel:.3e} of the whole layer's in L2")
    assert rel <= TP_LAYER_GRAD_BOUND


# each family's TP layer at t=2 (bf16, full width, 1 x 128) against the
# whole layer: its output and its gradients in every weight, each in L2
# over all of it, within the bounds (out, grad); the same layer with one
# position's partial dropped from every all-reduce must read above both.
# mamba2 and hymba: the qwen3 layer's 2^-6 (a bf16 CPU rehearsal reads 3.8e-3
# and 9.3e-3 at most).  granite's MoE block alone is held to one bf16
# rounding on the same input (its routes are one position's by
# construction), but in the layer the row-parallel attention's partials
# round once more in bf16, and that ulp of the router's input flips
# near-ties among its top 8 of 40 experts: 1.2e-2 and 3.9e-2 in the CPU
# rehearsal (the fp32 layer reads 7.9e-8), so 2^-5 and 2^-4
FAMILY_TP_LAYERS = {
    # granite: 12:4 heads a position, 20 experts a position
    "granite-moe-3b-a800m": {"flash": [((1, 128, 12, 64), (1, 128, 4, 64))], "ssd": [],
                             "bounds": (2 ** -5, 2 ** -4)},
    # mamba2: 16 SSD heads a position (in_proj, conv gathered)
    "mamba2-370m": {"flash": [], "ssd": [(1, 2, 64, 16, 64, 128)],
                    "bounds": (2 ** -6, 2 ** -6)},
    # hymba: whole KV groups, 15:3 and 10:2; the scan once at 25 heads
    "hymba-1.5b": {"flash": [((1, 128, 15, 64), (1, 128, 3, 64)),
                             ((1, 128, 10, 64), (1, 128, 2, 64))],
                   "ssd": [(1, 2, 64, 25, 64, 16)], "bounds": (2 ** -6, 2 ** -6)},
}


def _tp_layer_run(dev, arch, drop_partial=False):
    """One full-width bf16 layer of ``arch`` (1 layer, vocab 512, no remat)
    tensor-parallel over two logical positions against the whole layer:
    ``(output rel L2, gradient rel L2, launches, flash and SSD calls, the
    MoE block alone's largest |diff| over its scale or None)``;
    ``drop_partial`` drops the last position's partial from every
    all-reduce (a wrong TP layer)."""
    from repro_torch.launch import model_axis, sharding
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_fl_mesh
    cfg = dataclasses.replace(configs.get(arch), n_layers=1, vocab=512, remat=False)
    model = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    with torch.no_grad():                     # the standard fan-in (chip_smoke.to_fan_in)
        for name, p in model.named_parameters():
            if name.startswith("layers.") and p.dim() >= 2 and not name.endswith("conv_w"):
                p.mul_(p.shape[-2] ** -0.5 / cfg.n_layers ** -0.5)
    params = T.train_params(model)
    dims = sharding.placements(T.param_specs(cfg), make_fl_mesh(mediator=1, model=2,
                                                                devices=(dev, dev)))
    tp = T.TensorParallel(model, dims, (dev, dev), dev)
    tree = model_axis.split_tree(params, dims, (dev, dev))
    g = torch.Generator(device=dev).manual_seed(1)
    h = torch.randn(1, 128, cfg.d_model, generator=g, device=dev).to(torch.bfloat16)
    pos = torch.arange(128, device=dev)[None]
    layer, pre = model.layers[0], "layers.0."

    def run(p, par=None):
        whole, par = (p, None) if par is None else par.bind(p)
        bound = {k[len(pre):]: v for k, v in whole.items() if k.startswith(pre)}
        kw = {"mode": "train", "cache": None}
        if par is not None:
            kw["par"] = par
        return torch.func.functional_call(layer, bound, (h, pos), kw)[0]

    calls = []
    flash, flash_bwd, ssd, reduce = (ops.flash_attention, ops.flash_attention_bwd,
                                     ops.ssd_chunk, model_axis.reduce_from_positions)

    def rec(q, k, v, **kw):
        calls.append(("flash", tuple(q.shape), tuple(k.shape)))
        return flash(q, k, v, **kw)

    def rec_ssd(x, *a):
        calls.append(("ssd", tuple(x.shape), tuple(a[-1].shape)))
        return ssd(x, *a)

    def dropped(parts, device):
        return reduce(list(parts[:-1]) + [torch.zeros_like(parts[-1])], device)
    ops.flash_attention, ops.ssd_chunk = rec, rec_ssd
    if drop_partial:
        model_axis.reduce_from_positions = dropped
    try:
        ops.reset_launches()
        _, grads = S._loss_and_grads(lambda t: run(t, tp).float().square().mean(), tree)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        with torch.no_grad():
            got = run(tree, tp)
    finally:
        ops.flash_attention, ops.flash_attention_bwd, ops.ssd_chunk = flash, flash_bwd, ssd
        model_axis.reduce_from_positions = reduce
    with torch.no_grad():
        whole = run(params)
        moe_rel = None
        if cfg.is_moe and not drop_partial:         # the block alone, one input
            x = torch.randn(1, 128, cfg.d_model, generator=g, device=dev).to(torch.bfloat16)
            want_y = layer.moe(cfg, x)[0]
            bound, par = tp.bind(tree)
            got_y = torch.func.functional_call(
                layer.moe, {k[len(pre) + 4:]: v for k, v in bound.items()
                            if k.startswith(pre + "moe.")}, (cfg, x, par))[0]
            moe_rel = float((got_y.float() - want_y.float()).abs().max()) \
                / float(want_y.float().abs().max())
    _, want_grads = S._loss_and_grads(lambda p: run(p).float().square().mean(),
                                      {k: v for k, v in params.items() if k.startswith(pre)})
    out_rel = float((got.float() - whole.float()).norm()) / float(whole.float().norm())
    err = norm = 0.0
    for k, want_g in want_grads.items():
        d = dims[k]
        got_g = grads[k] if d is None else torch.cat([grads[f"{k}@{j}"] for j in range(2)], d)
        assert bool(torch.isfinite(got_g.float()).all()), k
        err += float((got_g.float() - want_g.float()).square().sum())
        norm += float(want_g.float().square().sum())
    return out_rel, (err / norm) ** 0.5, launches, sorted(set(calls)), moe_rel


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(FAMILY_TP_LAYERS))
def test_model_axis_family_tp_layer_on_card(dev, arch):
    """A full-width bf16 layer of granite-moe-3b-a800m (expert-parallel,
    12:4 heads a position), mamba2-370m (16 SSD heads a position, the
    packed in_proj and the conv gathered) and hymba-1.5b (whole KV groups
    15:3 and 10:2, the scan once at 25 heads) tensor-parallel over two
    logical positions against the whole layer at 1 x 128: the output and
    the gradients within ``FAMILY_TP_LAYERS``' bounds in L2 (granite's
    MoE block alone on one input within one bf16 rounding, 2^-8 of its
    scale); one launch of each kernel a position (the SSD once where its
    heads stay whole); each new flash and SSD signature held against its
    plain version, forward and backward; the layer with one position's
    partial dropped from every all-reduce reads above both bounds."""
    want = FAMILY_TP_LAYERS[arch]
    out_bound, grad_bound = want["bounds"]
    out_rel, grad_rel, launches, calls, moe_rel = _tp_layer_run(dev, arch)
    print(f"{arch} TP layer: output {out_rel:.3e}, gradients {grad_rel:.3e} in L2 (bounds "
          f"{out_bound}, {grad_bound}); the MoE block alone {moe_rel}")
    assert out_rel <= out_bound and grad_rel <= grad_bound
    if moe_rel is not None:
        assert moe_rel <= 2 ** -8
    n_flash = 2 * bool(want["flash"])
    n_ssd = (2 if arch == "mamba2-370m" else 1) * bool(want["ssd"])
    assert launches["flash_attention"] == launches["flash_attention_bwd"] == n_flash
    assert launches["ssd_chunk"] == launches["ssd_chunk_bwd"] == n_ssd
    assert [c[1:] for c in calls if c[0] == "flash"] == sorted(
        (q, k) for q, k in want["flash"])
    assert [c[1] for c in calls if c[0] == "ssd"] == [(b, nc, L, h, p) for b, nc, L, h, p, _
                                                      in want["ssd"]]
    g = torch.Generator(device=dev).manual_seed(2)
    window = configs.get(arch).sliding_window
    for qs, ks in want["flash"]:
        q, k, v, dout = (torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
                         for s in (qs, ks, ks, qs))
        out = ops.flash_attention(q, k, v, causal=True, window=window)
        ex = ref.flash_attention(q.float(), k.float(), v.float(), causal=True,
                                 window=window)
        assert float((out.float() - ex).abs().max()) <= 2 ** -7 * float(ex.abs().max())
        got_g = ops.flash_attention_bwd(q, k, v, out, dout, causal=True,
                                        window=window)
        want_g = ref.flash_attention_bwd(q.float(), k.float(), v.float(), ex, dout.float(),
                                         causal=True, window=window)
        for a, b in zip(got_g, want_g):
            assert float((a.float() - b).abs().max()) <= 2 ** -7 * float(b.abs().max())
    for case in want["ssd"]:
        x, dt, A, B, C = _ssd_inputs(dev, torch.float32, *case)
        _ssd_matches_plain(ops.ssd_chunk(x, dt, A, B, C), ref.ssd_chunk(x, dt, A, B, C),
                           torch.float32)
        args = _ssd_bwd_inputs(dev, *case)
        _ssd_bwd_matches_plain(ops.ssd_chunk_bwd(*args), ref.ssd_chunk_bwd(*args))
    bad_out, bad_grad, _, _, _ = _tp_layer_run(dev, arch, drop_partial=True)
    print(f"{arch} TP layer, one partial dropped: output {bad_out:.3e}, gradients "
          f"{bad_grad:.3e}")
    assert bad_out > out_bound and bad_grad > grad_bound


@pytest.mark.cuda
def test_model_axis_two_cards_bitwise_logical(dev, deterministic_convolutions):
    """Positions on ``cuda:0`` and ``cuda:1`` (a 1 x 2 mesh): the
    collectives move exact bytes across the cards (peer copies), and the
    gather oracle's and the TP rows' rounds (``"map"``: one CUDA graph
    cannot span two cards) equal the same runs on two logical positions of
    ``cuda:0`` bit for bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from repro_torch.launch import model_axis
    from repro_torch.launch.mesh import make_fl_mesh
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    x = torch.randn(6, 8, device=d0)
    shards = model_axis.split(x, 1, (d0, d1))
    assert shards[1].device == d1 and torch.equal(model_axis.all_gather(shards, 1, d0), x)
    assert torch.equal(model_axis.all_reduce([x, x.to(d1)], d0), x + x)
    for mode in (False, True):
        outs = []
        for devices in ((d0, d1), (d0, d0)):
            tr = _emnist_full_trainer(d0, "map", tp_rows=mode,
                                      mesh=make_fl_mesh(mediator=1, model=2, devices=devices))
            tr.run_round()
            outs.append(tr.engine.params)
        for k in outs[0]:
            assert torch.equal(outs[0][k], outs[1][k]), (mode, k)


# ---------------------------------------------------------------- the mediator axis as compute

def _tiny_engine(dev, mesh, row_exec, store="sharded", exchange="ragged", oracle=False):
    """Astraea at the reference's tiny federation (12 clients, 8 classes, 16
    px, c=6, gamma=3, B=10, E=1, Adam 1e-3, the online plan, seed 0,
    ``pad_mediators_to=4``, a reschedule each round) on ``mesh``;
    ``oracle`` trains every row on the engine's device in one block."""
    from repro_torch.core import EngineConfig, FLRoundEngine, LocalSpec
    from repro_torch.core.augmentation import augmentation_plan
    from repro_torch.data.federated import EMNIST_LIKE, partition
    from repro_torch.models.cnn import emnist_cnn
    from repro_torch.optim import adam
    fed = partition(dataclasses.replace(EMNIST_LIKE, num_classes=8, image_size=16),
                    num_clients=12, total_samples=600, test_samples=160, sizes="instagram",
                    global_dist="letterfreq", local="random", seed=0)
    cfg = EngineConfig.astraea(clients_per_round=6, gamma=3, local=LocalSpec(10, 1), seed=0,
                               pad_mediators_to=4, reschedule_every_round=True,
                               row_exec=row_exec, store=store, store_exchange=exchange,
                               tp_rows=False)
    e = FLRoundEngine(emnist_cnn(8, 16), adam(1e-3), fed, cfg, mesh=mesh, device=dev,
                      aug_plan=augmentation_plan(fed.client_counts().sum(0), 0.67))
    if oracle:
        e.row_positions = lambda: [(e.device,)]
    return e


@pytest.mark.cuda
@pytest.mark.parametrize("store,exchange", [("replicated", "ragged"), ("sharded", "ragged"),
                                            ("sharded", "gather")])
def test_mediator_axis_logical_positions_bitwise_engine_device(dev, deterministic_convolutions,
                                                               store, exchange):
    """Four logical positions of the card (a 4 x 1 mesh), each mediator row
    trained on its own position: under "map" bit for bit the run with every
    row on the engine's device, the sharded store's exchange moving the
    bytes the ledger charges; under "vmap" four programs, four graphs, one
    warp launch a row a round, within 1e-4 of "map" in L2 of the update."""
    mesh = _model_axis_mesh(dev, 4, 1)
    runs = {}
    for label, row_exec, oracle in (("map", "map", False), ("oracle", "map", True),
                                    ("vmap", "vmap", False)):
        e = _tiny_engine(dev, mesh, row_exec, store, exchange, oracle)
        ops.reset_launches()
        for _ in range(2):
            e.run_round()
        torch.cuda.synchronize()
        assert ops.LAUNCHES["affine_warp"] == 2 * (1 if oracle else 4)
        assert ops.LAUNCHES["fedavg_agg"] == 2
        runs[label] = e
    for k in runs["map"].params:
        assert torch.equal(runs["map"].params[k], runs["oracle"].params[k]), k
    v = runs["vmap"]
    assert v.num_round_traces == 4 and all(p.graph is not None for p in v._programs)
    if store == "sharded":
        assert v.store.moved_bytes == v.comm.store_exchange_bytes > 0
    init = _tiny_engine(dev, mesh, "map").params
    flat = lambda p: torch.cat([p[k].flatten() for k in init])          # noqa: E731
    update = float((flat(runs["map"].params) - flat(init)).norm())
    rel = float((flat(v.params) - flat(runs["map"].params)).norm()) / update
    print(f"{store} {exchange}: vmap on positions {rel:.3e} of the update from map")
    assert rel <= 1e-4


def _reduced_round_inputs(dev, mediators, steps=2):
    cfg = configs.reduced(configs.get("qwen3-4b"))
    model = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (mediators * steps, 32), generator=g, device=dev)
    weights = torch.arange(1, mediators * steps + 1, dtype=torch.float32, device=dev)
    return model, tokens, torch.roll(tokens, -1, 1), weights


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
@pytest.mark.parametrize("lora", [False, True], ids=["full-delta", "lora"])
def test_mediator_axis_reduced_round_bitwise_in_turn(dev, shape, lora):
    """qwen3-4b-reduced's round over ``n`` mediator rows of logical
    positions (one mediator a row at 2 x 1, two at 2 x 2) is the in-turn
    round at the same ``t`` bit for bit, full-delta and over a rank-2
    adapter state; Eq. 6 one launch a row a leaf (the flat adapter tree)."""
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_fl_mesh
    from repro_torch.models import lora as lora_lib
    n, t = shape
    m = 2 * (n * t // 2)
    model, tokens, labels, w = _reduced_round_inputs(dev, m)
    params = T.train_params(model)
    in_turn = make_fl_mesh(mediator=1, model=t, devices=(dev,) * t) if t > 1 else None
    mesh = make_fl_mesh(mediator=n, model=t, devices=(dev,) * (n * t))
    kw = dict(learning_rate=0.05, local_steps=2)
    if lora:
        mapping = T.adapter_mapping(model.cfg, 2)
        a_tree = lora_lib.init_adapter_A(lora_lib.A_SALT, mapping, dev)
        state = {k: v + 0.01 for k, v in lora_lib.init_adapter_state(mapping, params).items()}
        args = (params, a_tree, state, tokens, labels, w)
        kw["lora_mapping"] = mapping
    else:
        args = (params, tokens, labels, w)
    want = steps.make_fl_round(model, m, mesh=in_turn, **kw)(*args)
    ops.reset_launches()
    got = steps.make_fl_round(model, m, mesh=mesh, **kw)(*args)
    torch.cuda.synchronize()
    dims = _placements(model, mesh)
    assert ops.LAUNCHES["fedavg_agg"] == (n if lora else sum(
        len(steps.eq6_blocks(v.numel() // (t if dims[k] is not None else 1), n))
        * (t if dims[k] is not None else 1) for k, v in params.items()))
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _placements(model, mesh):
    from repro_torch.launch import sharding
    if mesh.shape["model"] == 1:
        return {k: None for k in T.train_params(model)}
    return sharding.placements(T.param_specs(model.cfg, model.max_seq), mesh)


@pytest.mark.cuda
def test_mediator_axis_two_cards_bitwise_logical(dev, deterministic_convolutions):
    """Mediator rows on ``cuda:0`` and ``cuda:1`` (a 2 x 1 mesh): the tiny
    federation's rounds over the sharded store (the exchange moving rows
    between the cards) under "map" and "vmap" (a graph on each card,
    replayed before either is waited on), and qwen3-4b-reduced's round
    (one mediator a card), each bit for bit the same run on two logical
    positions of ``cuda:0``."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_fl_mesh
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    for row_exec in ("map", "vmap"):
        outs = []
        for devices in ((d0, d1), (d0, d0)):
            e = _tiny_engine(d0, make_fl_mesh(mediator=2, model=1, devices=devices), row_exec)
            for _ in range(2):
                e.run_round()
            outs.append(e)
        assert outs[0].store.moved_bytes == outs[1].store.moved_bytes > 0
        for k in outs[0].params:
            assert torch.equal(outs[0].params[k], outs[1].params[k]), (row_exec, k)
    model, tokens, labels, w = _reduced_round_inputs(d0, 2)
    params = T.train_params(model)
    rounds = [steps.make_fl_round(model, 2, learning_rate=0.05, local_steps=2,
                                  mesh=make_fl_mesh(mediator=2, model=1, devices=devices))(
        params, tokens, labels, w) for devices in ((d0, d1), (d0, d0))]
    for k in params:
        assert rounds[0][k].device == d0 and torch.equal(rounds[0][k], rounds[1][k]), k
