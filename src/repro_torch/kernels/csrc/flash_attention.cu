// Online-softmax (flash) attention with causal and sliding-window masks,
// a query position offset, and grouped-query KV heads.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (Pallas,
// TPU), a (b, h, q_blocks, k_blocks) grid whose innermost KV axis carries
// the running max, denominator and fp32 accumulator in VMEM scratch, fed by
// src/repro/kernels/ops.py::flash_attention, which materializes the GQA
// repeat and transposes to (b, h, s, d).
//
// Bound on the H100: operations.  Each visible (query, key) pair costs a
// d-long dot product and a d-long update of the output (4d flops) on
// inputs read once, e.g. ~40 GFLOP on 52 MB per Hymba prefill layer (b=4,
// H=25, s=2048, d=64, window 1024): 0.041 ms at the tensor cores' 989
// TFLOP/s in bf16, 0.60 ms at the CUDA cores' 67 TFLOP/s in fp32.
//
// Both kernels share the semantics of the TPU kernel: scores q.k^T scaled
// by 1/sqrt(d) and accumulated in fp32, masked scores -1e30, masked p set to
// 0, fp32 running max, denominator and accumulator, output
// acc / max(l, 1e-30), so a row that sees no key is zero.  Query head h
// reads KV head h / (H / KV) directly from the model layout (b, s, KV, d):
// the GQA repeat is never materialized and no transpose is needed.  KV
// tiles that the causal and window masks leave empty for the whole query
// tile are skipped (exact; it halves the work at s = 2W).  Head dims 64, 80,
// 128 and 256 are instantiated.  Given an `lse` pointer (training asks,
// serving passes null), both kernels also write each row's natural-log
// log-sum-exp of its scaled visible scores, +inf for a row that sees no
// key, for the backward (flash_attention_bwd.cu).
//
// bf16 (flash_bf16_tc_kernel): the tensor cores, through wgmma.  One CTA
// per (64-query tile, query head, batch) holds one consumer warpgroup and
// one producer warp.  The producer's elected lane loads the Q tile once and
// the K and V tiles into a 2-stage ring by TMA (cp.async.bulk.tensor over
// the (d, heads, s, b) view, 128-byte swizzle, mbarrier completion), so the
// next tile's loads are in flight while the consumers compute.  The
// consumers run S = Q K^T as wgmma m64n64k16 with both operands in shared
// memory (K's natural (key, d) rows are the K-major B operand), then the
// online softmax on the fp32 accumulator fragment, then O += P V as wgmma
// with P from registers (the S fragment of 16 keys is exactly the A
// fragment) and V from shared memory with the transpose bit, so V is never
// transposed in memory.  P is rounded to bf16 for that product, as in
// FlashAttention-2/3; l is summed from the unrounded fp32 p.  The rounding
// (8 significant bits) changes each term p.v by at most 2^-8 of p.|v|; the
// terms' errors are independent and mostly cancel, so the output stays
// under one bf16 ulp of its scale, the card tolerance 2^-7 (an emulation of
// this arithmetic in tests/test_torch_kernels.py reaches 0.81 of it).  A
// head dim of 80 is loaded as two 64-column boxes; TMA zero-fills columns
// 80..127, which change neither q.k^T (the product walks only 80 columns)
// nor the stored columns.  Rows and keys past the sequence are zero-filled
// by TMA too.  A head dim of 256 is four boxes (32 KB a tile): Q and the
// two-stage K/V ring take 164,920 bytes of shared memory, so one CTA runs
// per SM, and O's accumulator is 4 x 32 fp32 registers of each consumer
// thread beside S (32) and the packed P (16); ptxas fits it in 199
// registers without spilling, so O stays one warpgroup's.  Only KV tiles
// that a mask cuts take the per-element mask; full tiles take none.  The
// query tiles are launched heaviest first (reversed tile order on the
// grid's slow axis), so the light early tiles of a causal + window pass
// fill the tail.  The dynamic shared memory size is set once per
// instantiation, not per launch.
//
// fp32 (flash_f32_kernel): the CUDA cores (fp32 must stay fp32 here; TF32
// is off, and no TF32 split is used), so the bound is 67 TFLOP/s of FMAs.
// Shared memory and load stalls are what keep a kernel from that rate
// (scalar reads give 2 FMAs a word, half of it; loads between block-wide
// barriers stop all compute).  So a CTA of four warps owns 64 query rows,
// and the tiles come by TMA (32-column fp32 boxes, 128-byte swizzle, zero
// fill past the sequence and past d=80's 80 columns): Q once, then K_0, V_0,
// K_1, V_1, ... into a ring of two tile buffers.  Each warp says when it
// has read a buffer by taking a ticket (a shared atomic); the warp whose
// ticket completes a tile's four issues the load of the tile after next
// into that buffer, so no warp ever waits for another, K_{t+1} loads while
// P V_t runs and V_{t+1} while Q K_{t+1}^T runs.  (A producer warp, as in
// the bf16 kernel, made five warps a CTA, which cost the consumers
// registers on the SM's sub-partitions and spilled.)  At d=256 a 64-key
// fp32 tile is 64 KB, and Q plus the two buffers (192 KB) is what fits.
// Thread (ty, tx) holds an 8 x 4 block of scores (rows ty + 8i, keys tx +
// 16j) and the matching 8 x d/16 block of O (columns 4(tx + 16c) .. +3, and
// 64 + tx at d=80).  Per 16-byte chunk of d, Q K^T takes 4 + 8 float4
// loads for 128 FMAs; P V, per 4 keys, 8 float4 loads of P and d/64 float4
// loads of V per key for 8 d/16 FMAs per key.  The swizzle keeps every
// such load free of bank conflicts (8 rows at one chunk, or one row's
// chunks, hit 8 distinct 16-byte bank groups).  A row's 16 lanes are one
// half-warp, so P passes through shared memory (32-key slices, one 64-key
// slice at d=256) with __syncwarp only: no block-wide barrier in the
// loop.  Per CTA 58,400 B of shared memory at d=64 (3 CTAs an SM), 82,976
// at 80 and 107,552 at 128 (2), 214,048 at 256 (1); the unroll of Q K^T
// is set per head dim so that ptxas spills nothing.  The semantics are the
// TPU kernel's: scale 1/sqrt(d) on the fp32 scores, masked scores -1e30
// and p = 0, m and l in fp32 (l summed from p per lane, reduced at the
// end), output acc / max(l, 1e-30).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"
#include "mbarrier.cuh"

namespace {

using namespace repro_ptx;
using namespace repro_flash;

constexpr float kMasked = -1e30f;

// Fills n floats with `value` (lse of rows that see no key: +inf).
__global__ void fill_f32_kernel(float* __restrict__ p, int64_t n, float value) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    p[i] = value;
}

cudaError_t fill_f32(float* p, int64_t n, float value, cudaStream_t stream) {
  if (n <= 0) return cudaGetLastError();
  const int blocks = static_cast<int>(n / 256 + 1 < 1024 ? n / 256 + 1 : 1024);
  fill_f32_kernel<<<blocks, 256, 0, stream>>>(p, n, value);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16
namespace tc {

constexpr int kRowsQ = 64;                  // query rows per CTA: one warpgroup
constexpr int kKeys = 64;                   // keys per KV tile
constexpr int kStages = 2;                  // K/V ring depth
constexpr int kConsumers = 128;             // the consumer warpgroup
constexpr int kThreadsTc = kConsumers + 32; // + the producer warp

template <int D>
struct Shape {
  static constexpr int kSubs = (D + 63) / 64;        // 64-column boxes per row
  static constexpr int kTileBytes = kSubs * kSubBytes;
  static constexpr int kQkSteps = D / 16;            // k16 steps of Q K^T
  // 1 KB of slack to align the swizzled tiles, Q, the K and V rings, and
  // 1 + 3 * kStages mbarriers
  static constexpr size_t kSmem =
      1024 + static_cast<size_t>(kTileBytes) * (1 + 2 * kStages) + 8 * (1 + 3 * kStages);
};

// Accumulator fragment of m64nNk16 (fp32): register i of thread (warp w,
// lane l) holds row 16w + l/4 + 8*((i/2)%2), column 8*(i/4) + 2*(l%4) + i%2.
//
// `lse` (b, H, sq) fp32, or null: each row's natural-log log-sum-exp of its
// scaled visible scores, (m + log2 l) ln 2 from the log2-domain running max
// m and sum l, and +inf for a row that sees no key (so exp(s - lse) = 0
// there).
template <int D>
__global__ void __launch_bounds__(kThreadsTc)
flash_bf16_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int sq,
                     int skv, int n_heads, int n_kv, int causal, int window, int q_offset,
                     float scale_log2) {
  using S = Shape<D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* q_s = smem_raw + (((raw + 1023u) & ~1023u) - raw);   // 1 KB aligned
  uint8_t* k_s = q_s + S::kTileBytes;
  uint8_t* v_s = k_s + kStages * S::kTileBytes;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(v_s + kStages * S::kTileBytes);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  const int b = blockIdx.x / n_heads;
  const int h = blockIdx.x - b * n_heads;
  const int g = h / (n_heads / n_kv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRowsQ;   // heaviest tiles first

  // keys any row of this tile can see: [k_begin, k_end), in whole tiles
  const int q_first = q0 + q_offset;
  const int q_last = min(q0 + kRowsQ, sq) - 1 + q_offset;
  int k_begin = 0, k_end = skv;
  if (causal) k_end = min(skv, q_last + 1);
  if (window > 0) k_begin = max(0, q_first - window + 1);
  const int kt0 = (k_begin / kKeys) * kKeys;
  const int n_tiles = k_end > kt0 ? (k_end - kt0 + kKeys - 1) / kKeys : 0;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == kConsumers / 32) {
    // ---- producer: one elected lane issues every TMA load
    if (lane == 0) {
      mbar_expect_tx(full_q, S::kTileBytes);
#pragma unroll
      for (int j = 0; j < S::kSubs; ++j)
        tma_load_4d(q_s + j * kSubBytes, &qmap, full_q, 64 * j, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(empty + st, ((t / kStages) - 1) & 1);
        const int k0 = kt0 + t * kKeys;
        uint8_t* kd = k_s + st * S::kTileBytes;
        uint8_t* vd = v_s + st * S::kTileBytes;
        mbar_expect_tx(full_k + st, S::kTileBytes);
#pragma unroll
        for (int j = 0; j < S::kSubs; ++j)
          tma_load_4d(kd + j * kSubBytes, &kmap, full_k + st, 64 * j, g, k0, b);
        mbar_expect_tx(full_v + st, S::kTileBytes);
#pragma unroll
        for (int j = 0; j < S::kSubs; ++j)
          tma_load_4d(vd + j * kSubBytes, &vmap, full_v + st, 64 * j, g, k0, b);
      }
    }
    return;
  }

  // ---- consumers: the warpgroup owns the tile's 64 query rows
  const int row0 = warp * 16 + lane / 4;   // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (lane % 4);
  float o[S::kSubs][32];                   // O's 64-column boxes
#pragma unroll
  for (int j = 0; j < S::kSubs; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
  float m_r[2] = {kMasked, kMasked};
  float l_r[2] = {0.f, 0.f};              // this thread's columns only
  const uint32_t q_addr = smem_u32(q_s);
  mbar_wait(full_q, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    const uint32_t parity = (t / kStages) & 1;
    const int k0 = kt0 + t * kKeys;
    const uint32_t k_addr = smem_u32(k_s + st * S::kTileBytes);
    const uint32_t v_addr = smem_u32(v_s + st * S::kTileBytes);

    // S = Q K^T, fp32
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    mbar_wait(full_k + st, parity);
    fence_regs(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < S::kQkSteps; ++kk) {
      wgmma_ss(s, sw128_desc(q_addr + kmajor_step(kk)), sw128_desc(k_addr + kmajor_step(kk)),
               kk > 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(s);

    // the per-element mask only where a mask cuts this tile
    const bool full = k0 + kKeys <= skv &&
                      (!causal || k0 + kKeys - 1 <= q0 + q_offset) &&
                      (window <= 0 || k0 > q0 + kRowsQ - 1 + q_offset - window);
    uint32_t vis = 0xffffffffu;
    float mx[2] = {m_r[0], m_r[1]};
    if (full) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] *= scale_log2;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qpos = q0 + row0 + 8 * ((i >> 1) & 1) + q_offset;
        const int kpos = k0 + 8 * (i >> 2) + col0 + (i & 1);
        bool ok = kpos < skv;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        if (!ok) vis &= ~(1u << i);
        s[i] = ok ? s[i] * scale_log2 : kMasked;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    }
    // a row's 64 columns live in the 4 lanes of a quad
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m_r[r] - mx[r]);
      m_r[r] = mx[r];
      l_r[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float p = ((vis >> i) & 1u) ? exp2f(s[i] - m_r[r]) : 0.f;
      s[i] = p;
      l_r[r] += p;                          // l from the unrounded p
    }
#pragma unroll
    for (int j = 0; j < S::kSubs; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[j][i] *= corr[(i >> 1) & 1];
    // P in bf16: the S fragment of keys [16kk, 16kk + 16) is the A fragment
    uint32_t pa[4][4];
    pack_a(s, pa);

    // O += P V
    mbar_wait(full_v + st, parity);
#pragma unroll
    for (int j = 0; j < S::kSubs; ++j) fence_regs(o[j]);
    wg_fence();
#pragma unroll
    for (int j = 0; j < S::kSubs; ++j)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(o[j], pa[kk], sw128_desc(v_addr + j * kSubBytes + kk * 16 * 128));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int j = 0; j < S::kSubs; ++j) fence_regs(o[j]);
    mbar_arrive(empty + st);                 // this stage's K and V are free
  }

  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    den[r] = fmaxf(l_r[r], 1e-30f);
    const int row = q0 + row0 + 8 * r;
    if (lse != nullptr && col0 == 0 && row < sq)
      lse[(static_cast<int64_t>(b) * n_heads + h) * sq + row] =
          l_r[r] > 0.f ? (m_r[r] + log2f(l_r[r])) * (1.f / kLog2e) : INFINITY;
  }
#pragma unroll
  for (int j = 0; j < S::kSubs; ++j)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1;
      const int row = q0 + row0 + 8 * r;
      const int col = 64 * j + 8 * (i >> 2) + col0;
      if (row < sq && col < D) {
        __nv_bfloat16* dst =
            out + ((static_cast<int64_t>(b) * sq + row) * n_heads + h) * D + col;
        *reinterpret_cast<uint32_t*>(dst) =
            pack_bf16(o[j][i] / den[r], o[j][i + 1] / den[r]);
      }
    }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int b,
           int sq, int skv, int n_heads, int n_kv, int causal, int window, int q_offset,
           float scale, cudaStream_t stream) {
  if (skv <= 0) {                           // no key: every row is zero
    cudaMemsetAsync(out, 0, static_cast<size_t>(b) * sq * n_heads * D * 2, stream);
    if (lse != nullptr)
      return static_cast<int>(fill_f32(lse, static_cast<int64_t>(b) * n_heads * sq,
                                       INFINITY, stream));
    return static_cast<int>(cudaGetLastError());
  }
  const int q_tiles = (sq + kRowsQ - 1) / kRowsQ;
  if (q_tiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap qmap, kmap, vmap;
  if (!make_map_bf16(&qmap, q, D, n_heads, sq, b) ||
      !make_map_bf16(&kmap, k, D, n_kv, skv, b) ||
      !make_map_bf16(&vmap, v, D, n_kv, skv, b))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(b) * n_heads, q_tiles);
  const cudaError_t err = smem_limit_once<flash_bf16_tc_kernel<D>>(Shape<D>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bf16_tc_kernel<D><<<grid, kThreadsTc, Shape<D>::kSmem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), lse, sq, skv, n_heads, n_kv,
      causal, window, q_offset, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ------------------------------------------------------------------ fp32
namespace f32 {

constexpr int kRowsQ = 64;                  // query rows per CTA
constexpr int kKeys = 64;                   // keys per K or V tile
constexpr int kThreadsF32 = 128;            // four warps, no producer warp
constexpr int kBox = 32;                    // fp32 columns per TMA box: one 128-byte row
constexpr int kBoxBytes = kKeys * 128;      // a 64-row box, 128-byte swizzle
constexpr int kSmemPerSm = 233472;          // an SM's shared memory (228 KB)

template <int D>
struct Shape {
  static constexpr int kBoxes = (D + kBox - 1) / kBox;   // d=80: 3, cols 80..95 zero
  static constexpr int kTileBytes = kBoxes * kBoxBytes;
  static constexpr int kChunks = D / 4;                  // 16-byte d chunks of a row
  static constexpr int kVec = D / 64;                    // float4 output chunks per thread
  static constexpr int kScalar = (D % 64) / 16;          // + one scalar column (d=80)
  static constexpr int kCols = 4 * kVec + kScalar;
  // keys of P staged at a time, and chunks of Q K^T unrolled (registers)
  static constexpr int kSlice = D == 256 ? 64 : 32;
  static constexpr int kQkUnroll = D == 256 ? 4 : 2;
  // 1 KB of slack to align the swizzled tiles; Q, the two-buffer K/V ring,
  // a (64, kSlice) slice of P, 3 mbarriers and 2 tickets
  static constexpr size_t kSmem = 1024 + 3 * static_cast<size_t>(kTileBytes) +
                                  kRowsQ * kSlice * 4 + 8 * 3 + 8;
  // CTAs an SM holds at this size (1 KB reserved per CTA), at most 3
  static constexpr int kPerSm =
      kSmemPerSm / (kSmem + 1024) < 3 ? static_cast<int>(kSmemPerSm / (kSmem + 1024)) : 3;
};

// Byte offset of 16-byte chunk `c` of row `r` in a tile of 128B-swizzled
// boxes (TMA's pattern: chunk c of a 128-byte row r sits at c ^ (r % 8)).
// `rsw` is 16 * (r % 8), which the callers hoist.
__device__ __forceinline__ uint32_t sw_off(int r, int c, uint32_t rsw) {
  return static_cast<uint32_t>((c >> 3) * kBoxBytes + r * 128) +
         ((16u * static_cast<uint32_t>(c & 7)) ^ rsw);
}

// One K or V tile into a ring buffer by TMA, completing on `bar`.
template <int D>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int g, int k0, int b) {
  mbar_expect_tx(bar, Shape<D>::kTileBytes);
#pragma unroll
  for (int j = 0; j < Shape<D>::kBoxes; ++j)
    tma_load_4d(dst + j * kBoxBytes, map, bar, kBox * j, g, k0, b);
}

// A warp is done reading ring buffer `buf`: the last of the four warps to
// say so for this tile (its ticket ends a group of four) refills it with
// the tile after next, if any.  Nobody waits.
template <int D>
__device__ __forceinline__ void release(uint32_t* ticket, int buf, int lane, uint8_t* dst,
                                        const CUtensorMap* map, uint64_t* bar, int g,
                                        int k0, int b, bool more) {
  __syncwarp();                             // the warp's reads of the buffer are done
  if (lane == 0) {
    __threadfence_block();
    if ((atomicAdd(ticket + buf, 1u) & 3u) == 3u && more) {
      __threadfence_block();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load_tile<D>(dst, map, bar, g, k0, b);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsF32, Shape<D>::kPerSm)
flash_f32_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, float* __restrict__ out,
                 float* __restrict__ lse, int sq, int skv, int n_heads, int n_kv,
                 int causal, int window, int q_offset, float scale) {
  using S = Shape<D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* q_s = smem_raw + (((raw + 1023u) & ~1023u) - raw);   // 1 KB aligned
  uint8_t* k_s = q_s + S::kTileBytes;        // ring buffer 0: K tiles
  uint8_t* v_s = k_s + S::kTileBytes;        // ring buffer 1: V tiles
  float* p_s = reinterpret_cast<float*>(v_s + S::kTileBytes);     // (64, kSlice)
  uint64_t* full_q = reinterpret_cast<uint64_t*>(p_s + kRowsQ * S::kSlice);
  uint64_t* full = full_q + 1;               // [K, V]
  uint32_t* ticket = reinterpret_cast<uint32_t*>(full + 2);       // [K, V]

  const int b = blockIdx.x / n_heads;
  const int h = blockIdx.x - b * n_heads;
  const int g = h / (n_heads / n_kv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRowsQ;   // heaviest tiles first

  // keys any row of this tile can see: [k_begin, k_end), in whole tiles
  const int q_first = q0 + q_offset;
  const int q_last = min(q0 + kRowsQ, sq) - 1 + q_offset;
  int k_begin = 0, k_end = skv;
  if (causal) k_end = min(skv, q_last + 1);
  if (window > 0) k_begin = max(0, q_first - window + 1);
  const int kt0 = (k_begin / kKeys) * kKeys;
  const int n_tiles = k_end > kt0 ? (k_end - kt0 + kKeys - 1) / kKeys : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(full_q + i, 1);
    ticket[0] = ticket[1] = 0;
    mbar_init_fence();
    mbar_expect_tx(full_q, S::kTileBytes);
#pragma unroll
    for (int j = 0; j < S::kBoxes; ++j)
      tma_load_4d(q_s + j * kBoxBytes, &qmap, full_q, kBox * j, h, q0, b);
    if (n_tiles > 0) {
      load_tile<D>(k_s, &kmap, full + 0, g, kt0, b);
      load_tile<D>(v_s, &vmap, full + 1, g, kt0, b);
    }
  }
  __syncthreads();

  // thread (ty, tx) owns query rows ty + 8i (i < 8), score keys tx + 16j
  // (j < 4) and output columns 4(tx + 16c) .. +3 (c < kVec), plus 64 kVec
  // + tx at d=80.  The 16 lanes of a row are one half-warp, so P goes
  // between them through shared memory with __syncwarp only.
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ty = warp * 2 + (lane >> 4);
  const int tx = lane & 15;
  const uint32_t qsw = 16u * static_cast<uint32_t>(ty & 7);   // rows ty + 8i
  const uint32_t ksw = 16u * static_cast<uint32_t>(tx & 7);   // keys tx + 16j
  const int psw = 16 * (ty & 1);                              // P's key swizzle

  float acc[8][S::kCols];
  float m_r[8], l_r[8];                     // l_r: this lane's keys only
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_r[i] = kMasked;
    l_r[i] = 0.f;
#pragma unroll
    for (int c = 0; c < S::kCols; ++c) acc[i][c] = 0.f;
  }
  mbar_wait(full_q, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = kt0 + t * kKeys;
    const uint32_t parity = t & 1;
    const bool more = t + 1 < n_tiles;

    // S = Q K^T: per 16-byte d chunk, 4 + 8 vector loads for 128 FMAs
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    mbar_wait(full + 0, parity);
#pragma unroll (S::kQkUnroll)
    for (int c = 0; c < S::kChunks; ++c) {
      float4 kf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kf[j] = *reinterpret_cast<const float4*>(k_s + sw_off(tx + 16 * j, c, ksw));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qf = *reinterpret_cast<const float4*>(q_s + sw_off(ty + 8 * i, c, qsw));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qf.x, kf[j].x, s[i][j]);
          s[i][j] = fmaf(qf.y, kf[j].y, s[i][j]);
          s[i][j] = fmaf(qf.z, kf[j].z, s[i][j]);
          s[i][j] = fmaf(qf.w, kf[j].w, s[i][j]);
        }
      }
    }
    release<D>(ticket, 0, lane, k_s, &kmap, full + 0, g, k0 + kKeys, b, more);

    // online softmax; the per-element mask only where a mask cuts the tile
    const bool full_tile = k0 + kKeys <= skv &&
                           (!causal || k0 + kKeys - 1 <= q0 + q_offset) &&
                           (window <= 0 || k0 > q0 + kRowsQ - 1 + q_offset - window);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qpos = q0 + ty + 8 * i + q_offset;
      bool vis[4];
      float mx = m_r[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = full_tile || kpos < skv;
        if (!full_tile && causal) ok = ok && kpos <= qpos;
        if (!full_tile && window > 0) ok = ok && kpos > qpos - window;
        vis[j] = ok;
        s[i][j] = ok ? s[i][j] * scale : kMasked;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)   // a row's 16 lanes
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float corr = expf(m_r[i] - mx);
      m_r[i] = mx;
      l_r[i] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = vis[j] ? expf(s[i][j] - mx) : 0.f;
        s[i][j] = p;
        l_r[i] += p;                        // l from p
      }
#pragma unroll
      for (int c = 0; c < S::kCols; ++c) acc[i][c] *= corr;
    }

    // O += P V, in slices of kSlice keys through this half-warp's rows of P
    mbar_wait(full + 1, parity);
#pragma unroll 1
    for (int hh = 0; hh < kKeys / S::kSlice; ++hh) {
      __syncwarp();                         // the last slice's reads are done
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < S::kSlice / 16; ++jj)
          p_s[(ty + 8 * i) * S::kSlice + ((tx + 16 * jj) ^ psw)] =
              S::kSlice == kKeys ? s[i][jj] : hh ? s[i][2 + (jj & 1)] : s[i][jj & 1];
      __syncwarp();
#pragma unroll 1
      for (int k8 = 0; k8 < S::kSlice; k8 += 8)
#pragma unroll
      for (int kk = k8; kk < k8 + 8; kk += 4) {
        float4 pf[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          pf[i] = *reinterpret_cast<const float4*>(p_s + (ty + 8 * i) * S::kSlice +
                                                   (kk ^ psw));
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int key = S::kSlice * hh + kk + u;
          const uint32_t vsw = 16u * static_cast<uint32_t>((kk - k8 + u) & 7);  // key % 8
          const uint8_t* vrow = v_s + key * 128;
          float pu[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            pu[i] = u == 0 ? pf[i].x : u == 1 ? pf[i].y : u == 2 ? pf[i].z : pf[i].w;
#pragma unroll
          for (int c = 0; c < S::kVec; ++c) {
            const int chunk = tx + 16 * c;
            const float4 vf = *reinterpret_cast<const float4*>(
                vrow + (chunk >> 3) * kBoxBytes + ((16u * (chunk & 7)) ^ vsw));
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              acc[i][4 * c + 0] = fmaf(pu[i], vf.x, acc[i][4 * c + 0]);
              acc[i][4 * c + 1] = fmaf(pu[i], vf.y, acc[i][4 * c + 1]);
              acc[i][4 * c + 2] = fmaf(pu[i], vf.z, acc[i][4 * c + 2]);
              acc[i][4 * c + 3] = fmaf(pu[i], vf.w, acc[i][4 * c + 3]);
            }
          }
          if constexpr (S::kScalar > 0) {
            // column 64 kVec + tx: box 2 kVec, chunk tx / 4, word tx % 4
            const float vv = *reinterpret_cast<const float*>(
                vrow + 2 * S::kVec * kBoxBytes + ((16u * (tx >> 2)) ^ vsw) + 4 * (tx & 3));
#pragma unroll
            for (int i = 0; i < 8; ++i)
              acc[i][4 * S::kVec] = fmaf(pu[i], vv, acc[i][4 * S::kVec]);
          }
        }
      }
    }
    release<D>(ticket, 1, lane, v_s, &vmap, full + 1, g, k0 + kKeys, b, more);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float l = l_r[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    const float den = fmaxf(l, 1e-30f);
    const int row = q0 + ty + 8 * i;
    if (row >= sq) continue;
    // the row's natural-log log-sum-exp, +inf where it sees no key
    if (lse != nullptr && tx == 0)
      lse[(static_cast<int64_t>(b) * n_heads + h) * sq + row] =
          l > 0.f ? m_r[i] + logf(l) : INFINITY;
    float* o = out + ((static_cast<int64_t>(b) * sq + row) * n_heads + h) * D;
#pragma unroll
    for (int c = 0; c < S::kVec; ++c)
      *reinterpret_cast<float4*>(o + 4 * (tx + 16 * c)) =
          make_float4(acc[i][4 * c] / den, acc[i][4 * c + 1] / den,
                      acc[i][4 * c + 2] / den, acc[i][4 * c + 3] / den);
    if constexpr (S::kScalar > 0) o[64 * S::kVec + tx] = acc[i][4 * S::kVec] / den;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int b,
           int sq, int skv, int n_heads, int n_kv, int causal, int window, int q_offset,
           float scale, cudaStream_t stream) {
  if (skv <= 0) {                           // no key: every row is zero
    cudaMemsetAsync(out, 0, static_cast<size_t>(b) * sq * n_heads * D * 4, stream);
    if (lse != nullptr)
      return static_cast<int>(fill_f32(lse, static_cast<int64_t>(b) * n_heads * sq,
                                       INFINITY, stream));
    return static_cast<int>(cudaGetLastError());
  }
  const int q_tiles = (sq + kRowsQ - 1) / kRowsQ;
  if (q_tiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap qmap, kmap, vmap;
  if (!make_map_f32(&qmap, q, D, n_heads, sq, b, kRowsQ) ||
      !make_map_f32(&kmap, k, D, n_kv, skv, b, kKeys) ||
      !make_map_f32(&vmap, v, D, n_kv, skv, b, kKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_f32_kernel<D>;
  const cudaError_t err = smem_limit_once<flash_f32_kernel<D>>(Shape<D>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(b) * n_heads, q_tiles);
  kern<<<grid, kThreadsF32, Shape<D>::kSmem, stream>>>(
      qmap, kmap, vmap, static_cast<float*>(out), lse, sq, skv, n_heads, n_kv, causal,
      window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// window <= 0 means no sliding window; causal is 0 or 1; lse may be null.
template <bool kBf16>
int dispatch(const void* q, const void* k, const void* v, void* out, float* lse, int b,
             int sq, int skv, int n_heads, int n_kv, int d, int causal, int window,
             int q_offset, float scale, void* stream) {
  if (b <= 0 || sq <= 0 || n_heads <= 0) return static_cast<int>(cudaGetLastError());
  if (n_kv <= 0 || n_heads % n_kv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return kBf16 ? tc::launch<D>(q, k, v, out, lse, b, sq, skv, n_heads, n_kv, causal,
                                 window, q_offset, scale, s)
                 : f32::launch<D>(q, k, v, out, lse, b, sq, skv, n_heads, n_kv, causal,
                                  window, q_offset, scale, s);
  };
  switch (d) {
    case 64: return go(std::integral_constant<int, 64>());
    case 80: return go(std::integral_constant<int, 80>());
    case 128: return go(std::integral_constant<int, 128>());
    case 256: return go(std::integral_constant<int, 256>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// lse: null, or (b, n_heads, sq) fp32 to receive each row's natural-log
// log-sum-exp (+inf for a row with no visible key); serving passes null.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, float* lse, int b, int sq, int skv,
                                   int n_heads, int n_kv, int d, int causal,
                                   int window, int q_offset, float scale,
                                   void* stream) {
  return dispatch<false>(q, k, v, out, lse, b, sq, skv, n_heads, n_kv, d, causal, window,
                         q_offset, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* out, float* lse, int b, int sq, int skv,
                                    int n_heads, int n_kv, int d, int causal,
                                    int window, int q_offset, float scale,
                                    void* stream) {
  return dispatch<true>(q, k, v, out, lse, b, sq, skv, n_heads, n_kv, d, causal, window,
                        q_offset, scale, stream);
}
