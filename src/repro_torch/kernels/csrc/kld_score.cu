// Alg. 3 scores of one or many open mediators against K candidates:
//   kld_score_f32:        med (C,),   cand (K, C) -> (K,)
//   kld_score_matrix_f32: meds (M, C), cand (K, C) -> (M, K)
// each entry D_KL(normalize(med + cand_k) || U).
//
// Replaces: src/repro/kernels/kld_score.py::kld_score (Pallas, TPU; a 1-D
// grid of BLOCK_K-row candidate tiles against the one mediator row) and
// ::kld_score_matrix (a (BLOCK_M x BLOCK_K) grid that materializes the
// (BLOCK_M, BLOCK_K, C) merged histograms in VMEM and reduces over C).
//
// Bound on the H100: operations for the matrix, launch and latency for the
// single row.  A score costs ~8 f32 operations and one logf per class over
// C*4 bytes of candidate row that every mediator shares, so the (M, K)
// sweep reads (M + K)*C*4 bytes and does ~8*M*K*C operations; one mediator
// row (M = 1) is a few microseconds of work at the main path's K.
//
// Design: both kernels score through kld_common.cuh::score_row, the device
// function of the one-launch greedy pass (kld_greedy.cu), so a host loop
// that scores one step at a time with kld_score sees the greedy kernel's
// bits and takes its picks.  kld_score: one thread per candidate row, the
// mediator's (C,) in shared memory.  kld_score_matrix: a 2-D grid of
// (kTileM mediators x kTileK candidates) tiles, the tile's mediators in
// shared memory, one thread per (m, k); a warp shares one mediator (a
// shared-memory broadcast) and reads 32 candidate rows.  Each thread walks
// its row at stride C, so neighbouring threads do not read neighbouring
// addresses; staging a tile of candidate rows in shared memory is the
// later fix.  Limits (the wrapper checks them): C <= 12,288 for one
// mediator and C <= 1,024 for the matrix, so the mediator row or the
// matrix tile's 8 rows fit in 48 KB of shared memory.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kld_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileK = 32;                      // candidates per matrix tile
constexpr int kTileM = kThreads / kTileK;       // mediators per matrix tile

__global__ void __launch_bounds__(kThreads)
kld_score_kernel(const float* __restrict__ med_g, const float* __restrict__ cand,
                 float* __restrict__ out, int k, int c) {
  extern __shared__ float med[];                                  // (c,)
  for (int j = threadIdx.x; j < c; j += kThreads) med[j] = med_g[j];
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= k) return;
  out[i] = repro_kld::score_row(cand + static_cast<int64_t>(i) * c, med, c,
                                repro_kld::uniform_log_q(c));
}

__global__ void __launch_bounds__(kThreads)
kld_score_matrix_kernel(const float* __restrict__ meds, const float* __restrict__ cand,
                        float* __restrict__ out, int m, int k, int c) {
  extern __shared__ float tile[];                                 // (kTileM, c)
  const int m0 = blockIdx.y * kTileM;
  const int rows = min(kTileM, m - m0);
  for (int idx = threadIdx.x; idx < rows * c; idx += kThreads)
    tile[idx] = meds[static_cast<int64_t>(m0) * c + idx];
  __syncthreads();
  const int mi = threadIdx.x / kTileK;
  const int ki = blockIdx.x * kTileK + threadIdx.x % kTileK;
  if (mi >= rows || ki >= k) return;
  out[static_cast<int64_t>(m0 + mi) * k + ki] =
      repro_kld::score_row(cand + static_cast<int64_t>(ki) * c, tile + mi * c, c,
                           repro_kld::uniform_log_q(c));
}

}  // namespace

extern "C" int kld_score_f32(const void* med, const void* cand, void* out, int k,
                             int c, void* stream) {
  if (k <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (k + kThreads - 1) / kThreads;
  kld_score_kernel<<<blocks, kThreads, sizeof(float) * c,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(med), static_cast<const float*>(cand),
      static_cast<float*>(out), k, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kld_score_matrix_f32(const void* meds, const void* cand, void* out,
                                    int m, int k, int c, void* stream) {
  if (m <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((k + kTileK - 1) / kTileK, (m + kTileM - 1) / kTileM);
  kld_score_matrix_kernel<<<grid, kThreads, sizeof(float) * kTileM * c,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(meds), static_cast<const float*>(cand),
      static_cast<float*>(out), m, k, c);
  return static_cast<int>(cudaGetLastError());
}
