// The Alg. 3 score shared by the three KLD kernels (kld_greedy.cu,
// kld_score.cu): D_KL(normalize(med + row) || U) over C classes.
//
// One device function, one op order -- that of
// distribution.merged_kld_scores: total = sum_j (med_j + row_j) in
// ascending j; p_j = (med_j + row_j) / max(total, eps); the score sums
// p_j * (log(max(p_j, eps)) - log(max(1/C, eps))) over the p_j > 0, again
// in ascending j.  Every op is separately rounded (no fused multiply-add),
// and both sums run in one accumulator in ascending j however many lanes
// share a row's per-class work, so a kernel that scores one candidate per
// step and the one-launch greedy pass give the same bits for the same
// inputs, and their picks agree.  The accumulator is f32 up to kWideC
// classes (the main paths' 10 and 47) and f64 past that, each sum rounded
// to f32 once, at its end: a sequential f32 sum drifts from the plain
// version's tree-order sum as C grows (on uniform random rows 4.5e-7 of
// the score at C = 47, 8.9e-7 at 256, 1.9e-6 at 1,100, 1.1e-5 at 60,000,
// against a 1e-6 tolerance), an f64 one stays within its rounding (1.9e-7
// or less); f64 sums at C = 47 cost the greedy pass 11-17 % and kld_score
// 16-40 % of its device time on an H100, so f32 stays where its drift is
// under half the tolerance.  The choice depends on C only, so every kernel
// makes it alike.
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
// sum unchanged (x + -0 = x; neither sum is ever -0, as both start at +0),
// so no add needs a branch and a round of padding classes alone may be
// skipped.  For L > 1 all 32 lanes of the warp must make the call.  ``row``
// and ``med`` may lie in shared or global memory (generic addresses).
//
// R = 0 streams the row: the per-class values of kRounds rounds of L
// classes are computed before they are added, so their divisions and
// logarithms overlap, and the second sum reads the row again.  R > 0
// holds the row: for C <= R * L each lane loads its R classes' merged
// counts once, before either sum, and keeps them in registers for both
// (the same __fadd_rn of the same operands, so the same bits).
constexpr int kRounds = 2;
constexpr int kWideC = 64;

__device__ __forceinline__ float acc_add(float a, float v) { return __fadd_rn(a, v); }
__device__ __forceinline__ double acc_add(double a, float v) {
  return __dadd_rn(a, static_cast<double>(v));
}

template <int L, int R, typename Acc>
__device__ __forceinline__ float score_lanes_in(const float* __restrict__ row,
                                                const float* __restrict__ med, int c,
                                                float log_q, int q) {
  if constexpr (R > 0) {
    float m[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int j = u * L + q;
      m[u] = j < c ? __fadd_rn(med[j], row[j]) : -0.f;
    }
    Acc total = 0;
#pragma unroll
    for (int u = 0; u < R; ++u)
      if (u * L < c)                          // the same for the whole group
#pragma unroll
        for (int r = 0; r < L; ++r) {
          float v = m[u];
          if constexpr (L > 1) v = __shfl_sync(0xffffffffu, m[u], r, L);
          total = acc_add(total, v);
        }
    const float denom = fmaxf(static_cast<float>(total), kEps);
    Acc s = 0;
#pragma unroll
    for (int u = 0; u < R; ++u) {
      float t = -0.f;
      if (u * L + q < c) {
        const float p = __fdiv_rn(m[u], denom);
        if (p > 0.f) t = __fmul_rn(p, __fsub_rn(logf(fmaxf(p, kEps)), log_q));
      }
      if (u * L < c)
#pragma unroll
        for (int r = 0; r < L; ++r) {
          float v = t;
          if constexpr (L > 1) v = __shfl_sync(0xffffffffu, t, r, L);
          s = acc_add(s, v);
        }
    }
    return static_cast<float>(s);
  } else {
    Acc total = 0;
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
          total = acc_add(total, v);
        }
    }
    const float denom = fmaxf(static_cast<float>(total), kEps);
    Acc s = 0;
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
          s = acc_add(s, v);
        }
    }
    return static_cast<float>(s);
  }
}

// The score (see above); R > 0 needs C <= R * L.
template <int L, int R = 0>
__device__ __forceinline__ float score_lanes(const float* __restrict__ row,
                                             const float* __restrict__ med, int c,
                                             float log_q, int q) {
  return c > kWideC ? score_lanes_in<L, R, double>(row, med, c, log_q, q)
                    : score_lanes_in<L, R, float>(row, med, c, log_q, q);
}

}  // namespace repro_kld
