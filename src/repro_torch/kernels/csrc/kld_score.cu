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
// equal to the greedy pass's.  The ~8 operations are a floor on paper: an
// IEEE division (__fdiv_rn) and a logf are each many instructions, so the
// matrix's real floor is the rate at which the SMs issue the instructions
// of a class (kernel_times.py --sass counts them in the built library).
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
// kld_score_matrix: every (mediator, candidate) pair is scored by a group
// of L lanes through the same score_lanes<L>, so each row of the matrix
// equals kld_score's for that mediator bit for bit.  Unlike the single
// row, the matrix has work for the whole card, and that work is issue
// slots: a class costs one lane ~67 SASS instructions, about half of them
// float instructions (the IEEE division and the logf most of those), the
// rest loads, address arithmetic and loop control (kernel_times.py
// --sass), and the sums of a pair run in one accumulator that every lane
// of its group carries (a shuffle and an add per class and sum per lane,
// and an f32 -> f64 conversion past 64 classes).  So L is chosen from C and from the pair count together: the
// fewest lanes that put ~12 warps on every SM of the card (its SM count
// read at the call), half that past 64 classes, never more than
// kld_score's lanes for C.  On an H100's 132 SMs that is L = 1 from
// 50,688 pairs up (Path A's 256 x 1,024 sweep, 256 x 4,096), L = 8 at
// 16 x 512 with C = 47, L = 4 at 16 x 512 with C = 2,000.  Every group
// streams its rows (score_lanes<L> with R = 0): both sums read the two
// rows, and no class is held in registers.  A CTA of 128 threads scores a
// tile of tile_m mediators x tile_k candidates (16 x 16 at L = 1, 8 x 8,
// 8 x 4, then 4 x 4), every pair of it once, with each staged candidate
// row scored against tile_m mediators and each mediator row against
// tile_k candidates.  A tile of consecutive rows is one contiguous block
// of global memory, so thread 0 copies each of the two blocks into shared
// memory with one bulk asynchronous copy (cp.async.bulk, completion on an
// mbarrier); a tile starts at a multiple of 4 rows, so it is 16-byte
// aligned on an aligned tensor at any C, and the < 4 floats a ragged last
// tile leaves past its last 16 bytes are copied by threads.  At L = 1 a
// warp reads one or two mediator rows (broadcast) and 16 candidate rows C
// floats apart: at odd C no two share a bank.  Tiles stay in global
// memory (read through L1) where the two blocks pass 96 KB, or where a
// base pointer is not 16-byte aligned (a contiguous row slice of a larger
// tensor): the direct path.
// kld_score_matrix_plan reports the choice for a shape and pointers.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kld_common.cuh"
#include "mbarrier.cuh"

namespace {

constexpr int kThreads = 128;                   // kld_score's CTA
constexpr int kMatrixThreads = 128;
// lanes x pairs a card needs per SM: ~12 warps (half of it past 64
// classes, where every lane also converts every add to f64)
constexpr int64_t kFillLanesPerSm = 384;
// the largest staged pair of tiles: two CTAs an SM
constexpr int kMaxStageBytes = 96 * 1024;
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

// The matrix launch for (m, k, c) on a card of `sms` SMs: lanes per pair,
// the tile, CTAs, and whether the tiles are staged in shared memory
// (pointers 16-byte aligned, or null for "aligned").
struct MatrixPlan {
  int lanes, tile_m, tile_k;
  int64_t ctas_k, ctas_m;
  int staged, smem;
};

MatrixPlan matrix_plan(int m, int k, int c, int sms, const void* meds, const void* cand) {
  MatrixPlan p{};
  const int64_t pairs = static_cast<int64_t>(m) * k;
  const int most = score_lanes_for(c);
  const int64_t fill =
      sms * (c <= repro_kld::kWideC ? kFillLanesPerSm : kFillLanesPerSm / 2);
  p.lanes = 1;
  while (p.lanes < most && pairs * p.lanes < fill) p.lanes <<= 1;
  // tile_m * tile_k * lanes is a multiple of the CTA's threads, so every
  // group of a warp makes the same number of score_lanes calls
  p.tile_m = p.lanes == 1 ? 16 : p.lanes <= 4 ? 8 : 4;
  p.tile_k = p.lanes == 1 ? 16 : p.lanes == 2 ? 8 : 4;
  p.ctas_k = (k + p.tile_k - 1) / p.tile_k;
  p.ctas_m = (m + p.tile_m - 1) / p.tile_m;
  const int64_t bytes = static_cast<int64_t>(p.tile_m + p.tile_k) * c * 4;
  const bool aligned = reinterpret_cast<uintptr_t>(meds) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(cand) % 16 == 0;
  p.staged = aligned && bytes <= kMaxStageBytes;
  p.smem = p.staged ? static_cast<int>(bytes) : 0;
  return p;
}

// The current device's SM count.
cudaError_t current_sms(int* sms) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

// The < 4 floats of an `n`-float tile past its last whole 16 bytes (which
// one bulk copy brings), from global `src` into shared `dst` by threads
// t0, t0 + 1, ...
__device__ __forceinline__ void stage_tail(float* dst, const float* src, int n, int t0) {
  const int bulk = n & ~3;
  const int i = static_cast<int>(threadIdx.x) - t0;
  if (i >= 0 && i < n - bulk) dst[bulk + i] = src[bulk + i];
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(repro_ptx::smem_u32(dst)), "l"(src), "r"(bytes),
         "r"(repro_ptx::smem_u32(bar))
      : "memory");
}

// Every pair of a tile, its mediator rows at `med_t` and its candidate
// rows at `cand_t`.  Inlined once per path, so that the staged path's
// loads are shared-memory loads (LDS) and the direct path's global ones,
// not generic loads that serve both.
template <int L>
__device__ __forceinline__ void score_tile(const float* med_t, const float* cand_t,
                                           float* __restrict__ out, int k, int c, int m0,
                                           int k0, int rows_m, int rows_k, int tile_m,
                                           int tile_k) {
  const float log_q = repro_kld::uniform_log_q(c);
  const int q = threadIdx.x % L;
  // every lane of a warp takes part in the shuffles: a pair past the edge
  // of the matrix scores the tile's last pair again and stores nothing
  for (int p = threadIdx.x / L; p < tile_m * tile_k; p += kMatrixThreads / L) {
    const int mi = p / tile_k;
    const int ki = p - mi * tile_k;
    const float s = repro_kld::score_lanes<L>(
        cand_t + static_cast<int64_t>(min(ki, rows_k - 1)) * c,
        med_t + static_cast<int64_t>(min(mi, rows_m - 1)) * c, c, log_q, q);
    if (mi < rows_m && ki < rows_k && q == 0)
      out[static_cast<int64_t>(m0 + mi) * k + k0 + ki] = s;
  }
}

template <int L>
__global__ void __launch_bounds__(kMatrixThreads)
kld_score_matrix_kernel(const float* __restrict__ meds, const float* __restrict__ cand,
                        float* __restrict__ out, int m, int k, int c, int tile_m,
                        int tile_k, int staged) {
  extern __shared__ __align__(16) float tiles[];       // (tile_m + tile_k, c)
  __shared__ uint64_t bar;
  const int m0 = blockIdx.y * tile_m;
  const int k0 = blockIdx.x * tile_k;
  const int rows_m = min(tile_m, m - m0);
  const int rows_k = min(tile_k, k - k0);
  const float* med_t = meds + static_cast<int64_t>(m0) * c;
  const float* cand_t = cand + static_cast<int64_t>(k0) * c;
  if (!staged) {
    score_tile<L>(med_t, cand_t, out, k, c, m0, k0, rows_m, rows_k, tile_m, tile_k);
    return;
  }
  float* med_s = tiles;
  float* cand_s = tiles + tile_m * c;                     // 16-byte aligned: tile_m % 4 == 0
  const int nm = rows_m * c, nk = rows_k * c;
  if (threadIdx.x == 0) {
    repro_ptx::mbar_init(&bar, 1);
    repro_ptx::mbar_init_fence();
    const uint32_t bm = 4u * static_cast<uint32_t>(nm & ~3);
    const uint32_t bk = 4u * static_cast<uint32_t>(nk & ~3);
    repro_ptx::mbar_expect_tx(&bar, bm + bk);
    if (bm) bulk_load(med_s, med_t, bm, &bar);
    if (bk) bulk_load(cand_s, cand_t, bk, &bar);
  }
  stage_tail(med_s, med_t, nm, 32);
  stage_tail(cand_s, cand_t, nk, 64);
  __syncthreads();                                        // the barrier and tails
  repro_ptx::mbar_wait(&bar, 0);
  score_tile<L>(med_s, cand_s, out, k, c, m0, k0, rows_m, rows_k, tile_m, tile_k);
}

template <int L>
cudaError_t launch_matrix(const float* meds, const float* cand, float* out, int m, int k,
                          int c, const MatrixPlan& p, cudaStream_t stream) {
  const cudaError_t limit =
      repro_ptx::smem_limit_once<kld_score_matrix_kernel<L>>(kMaxStageBytes);
  if (limit != cudaSuccess) return limit;
  const dim3 grid(static_cast<unsigned>(p.ctas_k), static_cast<unsigned>(p.ctas_m));
  kld_score_matrix_kernel<L><<<grid, kMatrixThreads, p.smem, stream>>>(
      meds, cand, out, m, k, c, p.tile_m, p.tile_k, p.staged);
  return cudaGetLastError();
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

// The launch kld_score_matrix_f32 makes for (m, k, c) on `meds` and
// `cand` (null: taken as 16-byte aligned) on the current device.  No
// launch.
extern "C" int kld_score_matrix_plan(int m, int k, int c, const void* meds,
                                     const void* cand, int* lanes, int* tile_m,
                                     int* tile_k, int* threads, int64_t* ctas,
                                     int* tiles_in_smem, int* smem_bytes) {
  if (m < 0 || k < 0 || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  int sms;
  const cudaError_t err = current_sms(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const MatrixPlan p = matrix_plan(m, k, c, sms, meds, cand);
  *lanes = p.lanes;
  *tile_m = p.tile_m;
  *tile_k = p.tile_k;
  *threads = kMatrixThreads;
  *ctas = p.ctas_k * p.ctas_m;
  *tiles_in_smem = p.staged;
  *smem_bytes = p.smem;
  return 0;
}

extern "C" int kld_score_matrix_f32(const void* meds_v, const void* cand_v, void* out_v,
                                    int m, int k, int c, void* stream_v) {
  if (m <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  if (c < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* meds = static_cast<const float*>(meds_v);
  const auto* cand = static_cast<const float*>(cand_v);
  auto* out = static_cast<float*>(out_v);
  auto stream = static_cast<cudaStream_t>(stream_v);
  int sms;
  cudaError_t err = current_sms(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const MatrixPlan p = matrix_plan(m, k, c, sms, meds_v, cand_v);
  if (p.ctas_m > 65535 || p.ctas_k > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  switch (p.lanes) {
    case 1: err = launch_matrix<1>(meds, cand, out, m, k, c, p, stream); break;
    case 2: err = launch_matrix<2>(meds, cand, out, m, k, c, p, stream); break;
    case 4: err = launch_matrix<4>(meds, cand, out, m, k, c, p, stream); break;
    case 8: err = launch_matrix<8>(meds, cand, out, m, k, c, p, stream); break;
    case 16: err = launch_matrix<16>(meds, cand, out, m, k, c, p, stream); break;
    case 32: err = launch_matrix<32>(meds, cand, out, m, k, c, p, stream); break;
    default: err = cudaErrorInvalidValue; break;
  }
  return static_cast<int>(err);
}
