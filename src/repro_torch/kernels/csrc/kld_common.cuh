// The Alg. 3 score shared by the three KLD kernels (kld_greedy.cu,
// kld_score.cu): D_KL(normalize(med + row) || U) over C classes.
//
// One device function, one f32 op order -- that of
// distribution.merged_kld_scores: total = sum_j (med_j + row_j) in
// ascending j; p_j = (med_j + row_j) / max(total, eps); the score sums
// p_j * (log(max(p_j, eps)) - log(max(1/C, eps))) over the p_j > 0, again
// in ascending j.  Every op is separately rounded (no fused multiply-add),
// and both sums run in one accumulator in ascending j however many lanes
// share a row's per-class work, so a kernel that scores one candidate per
// step and the one-launch greedy pass give the same bits for the same
// inputs, and their picks agree.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace repro_kld {

constexpr float kEps = 1e-12f;

// log(max(q, eps)) for q = 1/C as the reference builds it: 1.0 / C in
// double, stored as f32.
__device__ __forceinline__ float uniform_log_q(int c) {
  return logf(fmaxf(static_cast<float>(1.0 / c), kEps));
}

// The score of one row, computed by an aligned group of L lanes (lane q of
// the group, L a power of two <= 32; every lane returns the score).  Lane q
// computes the per-class values of the classes j = q (mod L) -- the merged
// count, then the term p_j * (log p_j - log q) -- and every lane adds them
// up in ascending j, taking each from its lane by a shuffle.  So every sum
// is the same sequence of separately rounded adds whatever L is, and a
// group's score equals one thread's (L = 1) bit for bit.  A class with
// p_j <= 0, and a padding class j >= C, adds -0.0f, which leaves every f32
// sum unchanged (x + -0 = x), so no add needs a branch.  The per-class
// values of kRounds rounds of L classes are computed before they are
// added, so their divisions and logarithms overlap.  For L > 1 all 32
// lanes of the warp must make the call.  ``row`` and ``med`` may lie in
// shared or global memory (generic addresses).
constexpr int kRounds = 2;

template <int L>
__device__ __forceinline__ float score_lanes(const float* __restrict__ row,
                                             const float* __restrict__ med, int c,
                                             float log_q, int q) {
  float total = 0.f;
  for (int j0 = 0; j0 < c; j0 += kRounds * L) {
    float m[kRounds];
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      const int j = j0 + u * L + q;
      m[u] = j < c ? __fadd_rn(med[j], row[j]) : -0.f;
    }
#pragma unroll
    for (int u = 0; u < kRounds; ++u)
#pragma unroll
      for (int r = 0; r < L; ++r) {
        float v = m[u];
        if constexpr (L > 1) v = __shfl_sync(0xffffffffu, m[u], r, L);
        total = __fadd_rn(total, v);
      }
  }
  const float denom = fmaxf(total, kEps);
  float s = 0.f;
  for (int j0 = 0; j0 < c; j0 += kRounds * L) {
    float t[kRounds];
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      const int j = j0 + u * L + q;
      t[u] = -0.f;
      if (j < c) {
        const float p = __fdiv_rn(__fadd_rn(med[j], row[j]), denom);
        if (p > 0.f) t[u] = __fmul_rn(p, __fsub_rn(logf(fmaxf(p, kEps)), log_q));
      }
    }
#pragma unroll
    for (int u = 0; u < kRounds; ++u)
#pragma unroll
      for (int r = 0; r < L; ++r) {
        float v = t[u];
        if constexpr (L > 1) v = __shfl_sync(0xffffffffu, t[u], r, L);
        s = __fadd_rn(s, v);
      }
  }
  return s;
}

// One thread scores one row from global memory (kld_score.cu).
__device__ __forceinline__ float score_row(const float* __restrict__ row,
                                           const float* __restrict__ med, int c,
                                           float log_q) {
  return score_lanes<1>(row, med, c, log_q, 0);
}

}  // namespace repro_kld
