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
// Bound on the H100: operations for the matrix, latency for the single
// row.  A score costs ~8 f32 operations and one logf per class over C*4
// bytes of candidate row that every mediator shares, so the (M, K) sweep
// reads (M + K)*C*4 bytes and does ~8*M*K*C operations; one mediator row
// (M = 1) is well under a microsecond of bytes and operations at the main
// path's K (96 KB at K = 512, C = 47), so what it costs is one trip to
// device memory plus the chain of 2C dependent adds that keeps its bits
// equal to the greedy pass's.
//
// Design.  Both kernels score through kld_common.cuh::score_lanes, the
// device function of the one-launch greedy pass (kld_greedy.cu), so a host
// loop that scores one step at a time with kld_score sees the greedy
// kernel's bits and takes its picks.
//
// kld_score: a group of L lanes scores one candidate row (L a power of two
// <= 32 chosen on the host from C, so that each lane holds <= 4 classes up
// to C = 128), in CTAs of 128 threads, so K = 512 at C = 47 (L = 16) runs
// as 64 CTAs on 64 SMs and K = 1,024 as 128.  A group reads its row in
// class order: lane q takes classes q, q + L, ..., so a warp's loads are
// contiguous.  Up to C = 256 each lane loads its <= 8 merged counts once
// into registers (score_lanes<L, R>), the mediator's values straight from
// global memory beside the row's (no barrier holds the row loads back),
// and both sums run from the registers.  Past that the group streams the
// row twice (score_lanes<32>), the mediator staged in shared memory while
// it fits in 48 KB (C <= 12,288), read from global memory (L2) past that,
// so C has no limit.
//
// kld_score_matrix: a 2-D grid of (kTileM mediators x kTileK candidates)
// tiles, one thread per (m, k) (score_lanes<1>); the tile's mediator rows
// in shared memory while they fit in 48 KB (C <= 1,536), else read from
// global memory, so C has no limit here either.  A warp shares one
// mediator (a shared-memory broadcast) and reads 32 candidate rows at
// stride C; staging a tile of candidate rows is the later fix.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kld_common.cuh"

namespace {

constexpr int kThreads = 128;                   // kld_score's CTA
constexpr int kMatrixThreads = 256;
constexpr int kTileK = 32;                      // candidates per matrix tile
constexpr int kTileM = kMatrixThreads / kTileK; // mediators per matrix tile
constexpr int kSmemFloats = 48 * 1024 / 4;      // the launch's default limit
constexpr int kHeldMaxC = 256;                  // 8 classes per lane at L = 32

// Lanes per candidate row: the least power of two that leaves each lane
// <= 4 classes, capped at a warp.
int score_lanes_for(int c) {
  int lanes = 1;
  while (lanes < 32 && lanes * 4 < c) lanes <<= 1;
  return lanes;
}

// Classes each lane holds in registers (4 or 8), or 0 where the group
// streams the row.
int score_rounds_for(int c, int lanes) {
  if (c <= 4 * lanes) return 4;
  return c <= kHeldMaxC ? 8 : 0;
}

template <int L, int R>
__global__ void __launch_bounds__(kThreads)
kld_score_kernel(const float* __restrict__ med_g, const float* __restrict__ cand,
                 float* __restrict__ out, int k, int c, int med_in_smem) {
  extern __shared__ float med_s[];                 // (c,) when staged
  const float* med = med_g;
  if constexpr (R == 0) {
    if (med_in_smem) {
      for (int j = threadIdx.x; j < c; j += kThreads) med_s[j] = med_g[j];
      __syncthreads();
      med = med_s;
    }
  }
  const int row = blockIdx.x * (kThreads / L) + threadIdx.x / L;
  const int q = threadIdx.x % L;
  // every lane of the warp takes part in the shuffles: a group past the
  // last row scores the last row again and stores nothing
  const float s = repro_kld::score_lanes<L, R>(
      cand + static_cast<int64_t>(min(row, k - 1)) * c, med, c,
      repro_kld::uniform_log_q(c), q);
  if (row < k && q == 0) out[row] = s;
}

template <int L, int R>
cudaError_t launch_score(const float* med, const float* cand, float* out, int k,
                         int c, cudaStream_t stream) {
  const int med_in_smem = R == 0 && c <= kSmemFloats;
  const int ctas = (k + kThreads / L - 1) / (kThreads / L);
  kld_score_kernel<L, R><<<ctas, kThreads, med_in_smem ? sizeof(float) * c : 0,
                           stream>>>(med, cand, out, k, c, med_in_smem);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(kMatrixThreads)
kld_score_matrix_kernel(const float* __restrict__ meds, const float* __restrict__ cand,
                        float* __restrict__ out, int m, int k, int c, int tile_in_smem) {
  extern __shared__ float tile_s[];                               // (kTileM, c)
  const int m0 = blockIdx.y * kTileM;
  const int rows = min(kTileM, m - m0);
  const float* tile = meds + static_cast<int64_t>(m0) * c;
  if (tile_in_smem) {
    for (int idx = threadIdx.x; idx < rows * c; idx += kMatrixThreads)
      tile_s[idx] = tile[idx];
    __syncthreads();
    tile = tile_s;
  }
  const int mi = threadIdx.x / kTileK;
  const int ki = blockIdx.x * kTileK + threadIdx.x % kTileK;
  if (mi >= rows || ki >= k) return;
  out[static_cast<int64_t>(m0 + mi) * k + ki] =
      repro_kld::score_row(cand + static_cast<int64_t>(ki) * c,
                           tile + static_cast<int64_t>(mi) * c, c,
                           repro_kld::uniform_log_q(c));
}

}  // namespace

// The launch kld_score_f32 makes for (k, c): lanes per row, classes each
// lane holds in registers (0: the row is streamed), threads per CTA, CTAs,
// and whether the mediator is staged in shared memory.  No launch.
extern "C" int kld_score_plan(int k, int c, int* lanes, int* rounds, int* threads,
                              int* ctas, int* med_in_smem) {
  if (k < 0 || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  *lanes = score_lanes_for(c);
  *rounds = score_rounds_for(c, *lanes);
  *threads = kThreads;
  *ctas = (k + kThreads / *lanes - 1) / (kThreads / *lanes);
  *med_in_smem = *rounds == 0 && c <= kSmemFloats;
  return 0;
}

extern "C" int kld_score_f32(const void* med_v, const void* cand_v, void* out_v, int k,
                             int c, void* stream_v) {
  if (k <= 0) return static_cast<int>(cudaGetLastError());
  if (c < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* med = static_cast<const float*>(med_v);
  const auto* cand = static_cast<const float*>(cand_v);
  auto* out = static_cast<float*>(out_v);
  auto stream = static_cast<cudaStream_t>(stream_v);
  const int lanes = score_lanes_for(c);
  const int rounds = score_rounds_for(c, lanes);
  cudaError_t err;
  switch (rounds == 0 ? 0 : lanes * 10 + rounds) {
    case 14: err = launch_score<1, 4>(med, cand, out, k, c, stream); break;
    case 24: err = launch_score<2, 4>(med, cand, out, k, c, stream); break;
    case 44: err = launch_score<4, 4>(med, cand, out, k, c, stream); break;
    case 84: err = launch_score<8, 4>(med, cand, out, k, c, stream); break;
    case 164: err = launch_score<16, 4>(med, cand, out, k, c, stream); break;
    case 324: err = launch_score<32, 4>(med, cand, out, k, c, stream); break;
    case 328: err = launch_score<32, 8>(med, cand, out, k, c, stream); break;
    default: err = launch_score<32, 0>(med, cand, out, k, c, stream); break;
  }
  return static_cast<int>(err);
}

extern "C" int kld_score_matrix_f32(const void* meds, const void* cand, void* out,
                                    int m, int k, int c, void* stream) {
  if (m <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  const int tile_in_smem = kTileM * c <= kSmemFloats;
  const dim3 grid((k + kTileK - 1) / kTileK, (m + kTileM - 1) / kTileM);
  kld_score_matrix_kernel<<<grid, kMatrixThreads,
                            tile_in_smem ? sizeof(float) * kTileM * c : 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(meds), static_cast<const float*>(cand),
      static_cast<float*>(out), m, k, c, tile_in_smem);
  return static_cast<int>(cudaGetLastError());
}
