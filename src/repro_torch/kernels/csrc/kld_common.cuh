// The Alg. 3 score shared by the three KLD kernels (kld_greedy.cu,
// kld_score.cu): D_KL(normalize(med + row) || U) over C classes.
//
// One device function, one f32 op order -- that of
// distribution.merged_kld_scores: total = sum_j (med_j + row_j) in
// ascending j; p_j = (med_j + row_j) / max(total, eps); the score sums
// p_j * (log(max(p_j, eps)) - log(max(1/C, eps))) over the p_j > 0, again
// in ascending j.  Every op is separately rounded (no fused multiply-add),
// so a kernel that scores one candidate per step and the one-launch greedy
// pass give the same bits for the same inputs, and their picks agree.
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

// ``med`` may lie in shared memory; ``row`` is read through the read-only
// cache.
__device__ __forceinline__ float score_row(const float* __restrict__ row,
                                           const float* __restrict__ med, int c,
                                           float log_q) {
  float total = 0.f;
  for (int j = 0; j < c; ++j)
    total = __fadd_rn(total, __fadd_rn(med[j], __ldg(row + j)));
  const float denom = fmaxf(total, kEps);
  float s = 0.f;
  for (int j = 0; j < c; ++j) {
    const float p = __fdiv_rn(__fadd_rn(med[j], __ldg(row + j)), denom);
    if (p > 0.f) {
      const float ratio = __fsub_rn(logf(fmaxf(p, kEps)), log_q);
      s = __fadd_rn(s, __fmul_rn(p, ratio));
    }
  }
  return s;
}

}  // namespace repro_kld
