"""Port parity: the plain versions of the Alg. 3 scoring kernels
(``kld_score``, ``kld_score_matrix``) and the per-step loop that drives
them, against the reference's oracles.

The reference's Pallas ``kld_score``/``kld_score_matrix`` raise under JAX
0.9.0 (``TPUCompilerParams``), so the port is held to
``repro/kernels/ref.py`` and ``distribution.merged_kld_scores``, and the
loop to ``scheduling.reschedule(impl="loop")`` without ``use_kernel``.
tests/test_torch_cuda.py holds the kernels to these plain versions on a
card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import distribution as jdist                      # noqa: E402
from repro.core import scheduling as jsched                       # noqa: E402
from repro.kernels import ref as jref                             # noqa: E402

from repro_torch.core import scheduling                           # noqa: E402
from repro_torch.kernels import ops                               # noqa: E402


def _counts(seed, *shape, hi=60):
    return np.random.default_rng(seed).integers(0, hi, shape).astype(np.float32)


# (mediator, candidates): random counts, a zero mediator against a zero
# row, K = 1, C = 1, fractional (post-augmentation) counts
SCORE_CASES = {
    "random": (_counts(0, 47, hi=200), _counts(1, 64, 47)),
    "zero_mediator_zero_row": (np.zeros(10, np.float32),
                               np.concatenate([np.zeros((1, 10), np.float32),
                                               _counts(2, 5, 10)])),
    "one_candidate": (_counts(3, 10), _counts(4, 1, 10)),
    "one_class": (_counts(5, 1), _counts(6, 7, 1)),
    "fractional": (_counts(7, 10) * np.float32(2.5), _counts(8, 16, 10) * np.float32(1.75)),
    # one class past what the kernel once refused (C <= 12,288)
    "many_classes": (_counts(9, 12_289, hi=200), _counts(10, 8, 12_289)),
}


@pytest.mark.parametrize("case", sorted(SCORE_CASES))
def test_kld_score_matches_reference(case):
    med, cand = SCORE_CASES[case]
    got = ops.kld_score(torch.from_numpy(med), torch.from_numpy(cand)).numpy()
    assert got.dtype == np.float32 and got.shape == (cand.shape[0],)
    np.testing.assert_allclose(got, np.asarray(jref.kld_score(jnp.asarray(med),
                                                              jnp.asarray(cand))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jdist.merged_kld_scores(
        jnp.asarray(med), jnp.asarray(cand))), rtol=0, atol=1e-6)
    if case == "zero_mediator_zero_row":
        assert got[0] == 0.0            # p = 0 / eps = 0: every term masked


@pytest.mark.parametrize("m,k,c", [(1, 1, 10), (1, 33, 47), (6, 1, 8), (16, 512, 47),
                                   (3, 5, 1100)])
def test_kld_score_matrix_matches_reference(m, k, c):
    meds, cand = _counts(m, m, c, hi=200), _counts(k, k, c)
    meds[0] = 0.0
    cand[0] = 0.0
    got = ops.kld_score_matrix(torch.from_numpy(meds), torch.from_numpy(cand)).numpy()
    assert got.shape == (m, k)
    np.testing.assert_allclose(
        got, np.asarray(jref.kld_score_matrix(jnp.asarray(meds), jnp.asarray(cand))),
        rtol=0, atol=1e-6)
    assert got[0, 0] == 0.0
    for i in range(m):          # each row is the single-mediator score
        np.testing.assert_allclose(
            got[i], ops.kld_score(torch.from_numpy(meds[i]), torch.from_numpy(cand)).numpy(),
            rtol=0, atol=1e-6)


def _score_lanes_emulation(meds, cand):
    """``kld_common.cuh::score_lanes``' op order for every (mediator,
    candidate) pair, in numpy: merged counts ``med_j + row_j`` in f32; the
    total summed in ascending j, one separately rounded add at a time, in
    f32 up to 64 classes and in f64 past that (rounded to f32 once);
    ``p_j = m_j / max(total, 1e-12)``; the score summed the same way over
    ``p_j * (log(max(p_j, 1e-12)) - log(max(1/C, 1e-12)))`` where ``p_j > 0``
    (-0.0 elsewhere), every op a separately rounded f32 op."""
    f32 = np.float32
    c = meds.shape[1]
    acc_t = np.float32 if c <= 64 else np.float64
    merged = meds[:, None, :].astype(f32) + cand[None, :, :].astype(f32)   # (M, K, C)
    total = np.zeros(merged.shape[:2], acc_t)
    for j in range(c):
        total = total + merged[..., j].astype(acc_t)
    denom = np.maximum(total.astype(f32), f32(1e-12))
    log_q = np.log(np.maximum(f32(1.0 / c), f32(1e-12)))
    score = np.zeros(merged.shape[:2], acc_t)
    with np.errstate(divide="ignore"):
        for j in range(c):
            p = merged[..., j] / denom
            term = np.where(p > 0, p * (np.log(np.maximum(p, f32(1e-12))) - log_q), f32(-0.0))
            score = score + term.astype(f32).astype(acc_t)
    return score.astype(f32)


@pytest.mark.parametrize("c", [10, 47, 64, 65, 1100])
def test_score_lanes_op_order_matches_reference(c):
    """The card's scorer sums in ascending class order one add at a time
    (f32 up to 64 classes, f64 past), not in the reference's tree order:
    emulated here, its matrix stays within 1e-6 of ``ref.kld_score_matrix``
    (zero rows included)."""
    meds, cand = _counts(c, 6, c, hi=200), _counts(c + 1, 40, c)
    meds[0] = 0.0
    cand[0] = 0.0
    got = _score_lanes_emulation(meds, cand)
    want = np.asarray(jref.kld_score_matrix(jnp.asarray(meds), jnp.asarray(cand)))
    assert got.dtype == np.float32 and got.shape == want.shape == (6, 40)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[0, 0] == 0.0


def test_empty_score_shapes():
    assert ops.kld_score(torch.ones(4), torch.ones(0, 4)).shape == (0,)
    assert ops.kld_score_matrix(torch.ones(0, 4), torch.ones(3, 4)).shape == (0, 3)
    assert ops.kld_score_matrix(torch.ones(2, 4), torch.ones(0, 4)).shape == (2, 0)


def test_score_wrappers_check_inputs():
    with pytest.raises(ValueError):
        ops.kld_score(torch.ones(2, 4), torch.ones(3, 4))            # med not (C,)
    with pytest.raises(ValueError):
        ops.kld_score(torch.ones(5), torch.ones(3, 4))               # C mismatch
    with pytest.raises(ValueError):
        ops.kld_score(torch.ones(4, dtype=torch.float64), torch.ones(3, 4))
    with pytest.raises(ValueError):
        ops.kld_score_matrix(torch.ones(4), torch.ones(3, 4))        # meds not (M, C)
    with pytest.raises(ValueError):
        ops.kld_score_matrix(torch.ones(2, 4), torch.ones(3, 4, dtype=torch.int64))


def _loop_cases():
    """``(counts, gamma, strict)``: strict cases must give the same lists;
    permuted duplicates tie in real arithmetic and their f32 scores may
    round apart differently in torch and XLA (another summation order), so
    there a divergence must be a float64 tie."""
    rng = np.random.default_rng(17)
    cases = []
    for i in range(4):                                   # random histograms
        cases.append((rng.integers(0, 80, (9, (10, 47)[i % 2])),
                      int(rng.integers(1, 5)), True))
    for _ in range(2):                                   # permuted duplicates
        base = rng.integers(0, 40, (3, 10))
        cases.append((np.stack([rng.permutation(base[j % 3]) for j in range(9)]),
                      3, False))
    cases.append((np.tile(rng.integers(1, 9, (1, 10)), (9, 1)), 4, True))  # all tied
    cases.append((np.zeros((9, 10)), 2, True))                             # empty
    # post-augmentation counts, as the engine packs them
    plan = np.array([0, 2, 0, 1, 3, 0, 0, 1, 0, 2], np.float64)
    cases.append((rng.integers(0, 30, (16, 10)) * (1.0 + plan), 4, True))
    return cases


@pytest.mark.parametrize("case", range(9))
def test_device_aware_loop_matches_reference_loop(case):
    """``reschedule(impl="loop", device="cpu")`` (one ``kld_score`` call per
    pick) gives the reference loop's mediator lists, ties included, and
    launches no kernel on the CPU."""
    counts, gamma, strict = _loop_cases()[case]
    expect = jsched.reschedule(counts, gamma, impl="loop")
    ops.reset_launches()
    got = scheduling.reschedule(counts, gamma, impl="loop", device="cpu")
    assert ops.LAUNCHES["kld_score"] == 0
    assert [len(m.clients) for m in got] == [len(m.clients) for m in expect]
    div = scheduling.first_divergence(counts, gamma, scheduling.picks_of(got),
                                      np.array([c for m in expect for c in m.clients]))
    assert div is None if strict else (div is None or div["tie"]), div
    if div is None:
        for a, b in zip(got, expect):
            np.testing.assert_array_equal(a.counts, b.counts)


def test_loop_and_batched_agree_on_fractional_counts_up_to_ties():
    """On post-augmentation (fractional) histograms the loop keeps its
    mediator in float64 and the batched pass in float32; where the picks
    part, ``first_divergence`` must report a float tie."""
    rng = np.random.default_rng(3)
    plan = rng.integers(0, 3, 10).astype(np.float64)
    for _ in range(3):
        counts = rng.integers(0, 40, (16, 10)) * (1.0 + plan)
        loop = scheduling.reschedule(counts, 4, impl="loop", device="cpu")
        batched = scheduling.reschedule(counts, 4, impl="batched", device="cpu")
        div = scheduling.first_divergence(counts, 4, scheduling.picks_of(loop),
                                          scheduling.picks_of(batched))
        assert div is None or div["tie"], div


def test_mediator_client_scores_is_the_score_matrix():
    counts = _counts(11, 12, 10).astype(np.float64)
    meds = scheduling.reschedule(counts, 4, impl="loop", device="cpu")
    got = scheduling.mediator_client_scores(meds, counts, device="cpu")
    med_counts = np.stack([m.counts for m in meds]).astype(np.float32)
    np.testing.assert_allclose(
        got, np.asarray(jref.kld_score_matrix(jnp.asarray(med_counts),
                                              jnp.asarray(counts, jnp.float32))),
        rtol=0, atol=1e-6)
    assert scheduling.mediator_client_scores([], counts, device="cpu").shape == (0, 12)
