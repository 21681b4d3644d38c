// The whole Alg. 3 greedy pass in one launch: (K, C) histograms -> (K,) picks.
//
// Replaces: src/repro/kernels/kld_score.py::kld_greedy_picks (Pallas, TPU),
// a (K steps x K/BLOCK_K blocks) sequential grid carrying the pick mask and
// the open mediator in VMEM scratch.
//
// Bound on the H100: operations.  Step s scores the K - s unpicked clients
// over C classes (one logf per class), so the pass does ~K^2 C / 2 scorings
// on the same K*C*4 bytes; at K = 4,096, C = 47 that is ~4e8 logf against
// 770 KB of input.  One CTA also means the kernel uses one SM of 132.
//
// Design: one persistent CTA of 1024 threads loops over the K steps; a grid
// has no order between blocks, so the sequential grid axis of the TPU
// kernel becomes this loop.  The open mediator's (C,) histogram and the
// (K,) pick mask live in shared memory.  Per step every thread scores its
// candidates (i = tid, tid + 1024, ... ascending), each score one row summed
// sequentially over ascending classes in f32 (kld_common.cuh::score_row, the
// scorer kld_score.cu shares), keeping the first minimum.  A warp-shuffle
// then shared-memory argmin over (score, index) breaks ties toward the lower
// index, so the pick is the first minimum over all clients, as in the numpy
// loop.  Thread 0 commits the pick; all threads fold its row into the
// mediator, which resets after every gamma picks.  Limits: K <= 16,384
// (pick mask in shared memory) and C <= 1,024; the wrapper checks them.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kld_common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kNone = 0x7fffffff;

// (score, index) order: a real index beats none; then lower score; then
// lower index.
__device__ __forceinline__ bool better(float s, int i, float best, int bidx) {
  if (i == kNone) return false;
  if (bidx == kNone) return true;
  return s < best || (s == best && i < bidx);
}

__device__ __forceinline__ void warp_argmin(float& best, int& bidx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float s = __shfl_down_sync(0xffffffffu, best, off);
    const int i = __shfl_down_sync(0xffffffffu, bidx, off);
    if (better(s, i, best, bidx)) { best = s; bidx = i; }
  }
}

__global__ void __launch_bounds__(kThreads)
kld_greedy_kernel(const float* __restrict__ counts, int32_t* __restrict__ picks,
                  int k, int c, int gamma) {
  extern __shared__ float smem[];
  float* med = smem;                                               // (c,)
  unsigned char* picked = reinterpret_cast<unsigned char*>(smem + c);  // (k,)
  __shared__ float warp_best[kWarps];
  __shared__ int warp_idx[kWarps];
  __shared__ int s_pick;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = tid; j < c; j += kThreads) med[j] = 0.f;
  for (int i = tid; i < k; i += kThreads) picked[i] = 0;
  const float log_q = repro_kld::uniform_log_q(c);
  int fill = 0;
  __syncthreads();

  for (int step = 0; step < k; ++step) {
    float best = INFINITY;
    int bidx = kNone;
    for (int i = tid; i < k; i += kThreads) {
      if (picked[i]) continue;
      const float s = repro_kld::score_row(counts + static_cast<int64_t>(i) * c, med, c, log_q);
      if (better(s, i, best, bidx)) { best = s; bidx = i; }
    }
    warp_argmin(best, bidx);
    if (lane == 0) { warp_best[warp] = best; warp_idx[warp] = bidx; }
    __syncthreads();
    if (warp == 0) {
      best = warp_best[lane];
      bidx = warp_idx[lane];
      warp_argmin(best, bidx);
      if (lane == 0) {
        s_pick = bidx;
        picks[step] = bidx;
        picked[bidx] = 1;
      }
    }
    __syncthreads();
    const int pick = s_pick;
    if (++fill == gamma) {
      fill = 0;
      for (int j = tid; j < c; j += kThreads) med[j] = 0.f;
    } else {
      const float* row = counts + static_cast<int64_t>(pick) * c;
      for (int j = tid; j < c; j += kThreads) med[j] = __fadd_rn(med[j], row[j]);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int kld_greedy_picks(const void* counts, void* picks, int k, int c,
                                int gamma, void* stream) {
  if (k <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = sizeof(float) * c + k;
  kld_greedy_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(counts), static_cast<int32_t*>(picks), k, c,
      gamma);
  return static_cast<int>(cudaGetLastError());
}
