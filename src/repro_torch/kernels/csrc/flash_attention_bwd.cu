// The backward pass of the flash-attention kernel: dq, dk, dv of
// softmax(q k^T / sqrt(d)) v under the causal and sliding-window masks, a
// query position offset and grouped-query KV heads.
//
// Replaces: no pallas_call.  The reference differentiates its attention in
// XLA (src/repro/kernels/ref.py::flash_attention and
// src/repro/models/layers.py::blockwise_attention under jax.grad); its
// Pallas forward (src/repro/kernels/flash_attention.py) has no backward
// kernel.  The plain version is src/repro_torch/kernels/ref.py::
// flash_attention_bwd, the formula
//
//   P = exp(S - lse), S = q k^T / sqrt(d) masked;   D_i = sum_c dO_ic O_ic
//   dS = P * (dO v^T - D);   dq = dS k / sqrt(d);   dk = dS^T q / sqrt(d);
//   dv = P^T dO,  dk and dv summed over the H / KV query heads of a KV head.
//
// lse is each row's natural-log log-sum-exp of its scaled visible scores,
// +inf for a row that sees no key (so its P is 0): the forward kernels
// write it when asked (flash_attention.cu), and every launch here reads it
// (the wrapper runs the forward first for a caller without one).  D comes
// from the given out and dout.
//
// Bound on the H100: operations.  Five d-long products per visible (query,
// key) pair (S and dO v^T recomputed, then dv, dk and dq), 10 d flops a
// pair: e.g. qwen3-4b's training layer (b=4, s=128, H=32, KV=8, d=128,
// causal) is 1.4 GFLOP, 1.4 us at the tensor cores' 989 TFLOP/s in bf16,
// under its bytes (6.3 us), and 20.2 us at the CUDA cores' 67 TFLOP/s in
// fp32, over its bytes (12.5 us).  Keeping dq in a kernel of its own (no
// atomics) recomputes S and dO v^T there: 7 products a pair against the
// bound's 5, so both paths reach at most 5/7 of the operations bound.
//
// bf16: the tensor cores, three kernels in one launch, in the order (c),
// (b), (d).
//
//   (b) dK/dV: one CTA per (batch, KV head, key tile, head split).  One
//       producer lane loads the K and V tiles once and streams the (Q, dO)
//       tiles of its query heads through a 2-stage ring by TMA (128-byte
//       swizzle, mbarriers, the forward's maps); each consumer warpgroup
//       runs S^T = K Q^T and dP^T = V dO^T as wgmma m64n64k16 from shared
//       memory (K, V, Q, dO all K-major in their natural (pos, d) rows),
//       forms P^T = exp2(S^T scale log2 e - lse log2 e) and dS^T = P^T *
//       (dP^T - D) in fp32 registers (the rows' lse and D staged in shared
//       memory per tile), rounds both to bf16 (as FlashAttention-2/3 do),
//       and runs dV += P^T dO and dK += dS^T Q with those fragments as the A
//       operand from registers and dO, Q as MN-major B operands (the
//       transpose bit, as the forward reads V): nothing is transposed in
//       memory.  Only tiles that a mask or a sequence end cuts take the
//       per-element mask; the query tiles no key of the tile sees are
//       skipped.  Two consumer warpgroups (and a producer warpgroup that
//       gives them its registers by setmaxnreg) share the CTA: below d =
//       256 each owns 64 of its 128 keys; at d = 256 a 64-key tile's dK and
//       dV (2 x 64 x 256 fp32) are more than one warpgroup's registers, so
//       each owns 128 columns and both compute S^T and dP^T (6 products a
//       pair there instead of 4).
//   (c) dQ: one CTA per (batch, query head, 64-query tile) first forms D
//       of its rows from the bf16 values of out and dout (and writes it for
//       (b): no other CTA visits those rows), then walks its visible key
//       tiles through a 2-stage (K, V) ring: S = Q K^T and dP = dO V^T by
//       wgmma from shared memory, then dQ += dS K with dS from registers
//       and K MN-major.
//   (d) reduce (only when the query heads of a KV head are split over
//       CTAs, to fill the card: the wrapper's split): (b) writes fp32
//       partial dK, dV per split to scratch, and this pass sums them in
//       split order and rounds to bf16.  (Summing them instead inside a
//       thread-block cluster of the splits, through distributed shared
//       memory, measured slower on an H100: 0.045 against 0.033 ms at
//       qwen3-4b's training layer.)
//
// No atomics: every sum runs in one fixed order (the heads of a split in
// order inside a CTA's accumulators, the splits in order), so two runs
// agree bit for bit.  Rounding P and dS to bf16 changes each term of dv,
// dk and dq by at most 2^-8 of it; the errors are independent and mostly
// cancel, and an emulation of this arithmetic stays within 2^-7 of each
// gradient's largest magnitude (tests/test_torch_train.py).  Head dims 64,
// 80 (two 64-column boxes, TMA zero-fills columns 80..127), 128 and 256.
//
// fp32: the CUDA cores (no TF32, no split-precision trick), whose bound is
// 67 TFLOP/s of FMAs, in the same three kernels and order: dQ (which writes
// D), dK/dV over the same head split, and the splits' sum in order.  What
// keeps a CUDA-core kernel from that rate is shared memory and load stalls,
// so the design is the fp32 forward's (flash_attention.cu): no producer
// warp; the held tiles and a 2-stage ring of streamed tiles come by TMA
// (32-column boxes, 128-byte swizzle, zero fill past the sequence and past
// d = 80's 80 columns), each stage refilled by the warp whose ticket
// completes the CTA's releases of it, so no warp waits for another and no
// block-wide barrier sits in the loop.  Thread (ty, tx) (ty the half-warp,
// H of them) owns rows ty + H i of the held tile (keys for dK/dV, query
// rows for dQ) and, per step, a register block of their scores against rows
// tx + 16j of the streamed tile, from float4 loads of the swizzled rows: 4
// x 4 at 64 x 64 tiles (eight warps, d = 80 and 128), 4 x 2 at 32 x 32
// (four warps, d = 64 and 256), 4-8 FMAs a load.  P^T and dS^T (or dS) go
// through the half-warp's own weight tile (__syncwarp only) to the
// accumulators of dV += P^T dO, dK += dS^T Q (or dQ += dS K): the lane's
// columns 4 (tx + 16c) .. + 3 (and 64 + tx at d = 80) of its rows, float4
// loads again.  The sums stay in one order (columns in order, then rows or
// keys in order, then heads, then splits): two runs agree bit for bit.  Shared
// memory: 224 KB a dK/dV CTA at d = 128, 200 KB at 256 (K, V and the ring
// take 192 KB; a thread's 2 x 4 x 16 dK, dV accumulators are 128 registers).
// A dK/dV CTA with no visible step writes zeros.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "mbarrier.cuh"

namespace {

using namespace repro_ptx;
using namespace repro_flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  const float* lse;   // (b, H, sq) natural-log log-sum-exp, +inf for a row with no key
  float* dsum;        // (b, H, sq) D = rowsum(dO * O)
  float* part;        // (2, split, b, skv, KV, d) fp32 partial dk, dv; null at split 1
  int b, sq, skv, n_heads, n_kv, causal, window, q_offset, split;
  float scale;
};

// key j is visible to query row i (absolute position q_offset + i)
__device__ __forceinline__ bool visible(int causal, int window, int q_offset, int i, int j) {
  const int qpos = q_offset + i;
  if (causal && j > qpos) return false;
  if (window > 0 && j <= qpos - window) return false;
  return true;
}

// [lo, hi) of the keys any row of [i0, i1) sees
__device__ __forceinline__ void key_range(const Params& p, int i0, int i1, int* lo, int* hi) {
  *lo = p.window > 0 ? max(0, p.q_offset + i0 - p.window + 1) : 0;
  *hi = p.causal ? min(p.skv, p.q_offset + i1) : p.skv;
}

// [lo, hi) of the query rows that see any key of [j0, j1)
__device__ __forceinline__ void row_range(const Params& p, int j0, int j1, int* lo, int* hi) {
  *lo = p.causal ? max(0, j0 - p.q_offset) : 0;
  *hi = p.window > 0 ? min(p.sq, j1 - 1 + p.window - p.q_offset) : p.sq;
}

// ---------------------------------------------------------------- fp32
namespace f32 {

constexpr int kStages = 2;           // (Q, dO) or (K, V) ring depth
constexpr int kSmemPerSm = 233472;   // an SM's shared memory (228 KB)

// CTAs an SM holds at `bytes` of shared memory each (1 KB reserved per
// CTA), 1 to 3
constexpr int per_sm(size_t bytes) {
  return kSmemPerSm / (bytes + 1024) < 1 ? 1
         : kSmemPerSm / (bytes + 1024) > 3 ? 3
                                           : static_cast<int>(kSmemPerSm / (bytes + 1024));
}

// The fp32 tiles at head dim D: the dK/dV CTA holds kKeys keys of K and V
// and streams kRows-row tiles of Q and dO; the dQ CTA holds kRows query
// rows of Q and dO and streams kKeys-key tiles of K and V.  So each tensor
// has one TMA box height, shared by both kernels.  64 x 64 tiles and eight
// warps (two a scheduler) at d = 80 and 128; 32 x 32 and four warps at d =
// 256, where K, V and a 2-stage (Q, dO) ring of 32 rows already take 192
// KB, and at d = 64, whose one use, the reduced configs' small layer, needs
// CTAs more than large tiles.
template <int D>
struct Tiles {
  static constexpr int kKeys = D == 64 || D == 256 ? 32 : 64;
  static constexpr int kRows = kKeys;
  static constexpr int kThreads = kKeys == 64 ? 256 : 128;
  static constexpr int kHalves = kThreads / 16;          // half-warps: rows ty + kHalves i
  static constexpr int kBoxes = (D + 31) / 32;           // 32-column boxes; d=80: 3
  static constexpr int kVec = D / 64;                    // float4 columns a lane accumulates
  static constexpr int kScalar = (D % 64) / 16;          // + one scalar column (d=80)
  static constexpr int kCols = 4 * kVec + kScalar;
  static constexpr int kKeyBytes = kBoxes * kKeys * 128;    // a K or V tile
  static constexpr int kRowBytes = kBoxes * kRows * 128;    // a Q or dO tile
  // 1 KB of slack to align the swizzled tiles; the held pair, the ring of
  // pairs, the fp32 weight tiles (P^T and dS^T, or dS), 1 + kStages
  // mbarriers and kStages tickets
  static constexpr size_t kSmemKV = 1024 + 2 * static_cast<size_t>(kKeyBytes) +
                                    2 * kStages * static_cast<size_t>(kRowBytes) +
                                    2 * kKeys * kRows * 4 + 8 * (1 + kStages) + 4 * kStages;
  static constexpr size_t kSmemQ = 1024 + 2 * static_cast<size_t>(kRowBytes) +
                                   2 * kStages * static_cast<size_t>(kKeyBytes) +
                                   kKeys * kRows * 4 + 8 * (1 + kStages) + 4 * kStages;
  static constexpr int kPerSmKV = per_sm(kSmemKV);
  static constexpr int kPerSmQ = per_sm(kSmemQ);
};

// Byte offset of 16-byte chunk `c` of row `r` in a tile of `rows`-row
// boxes of 32 fp32 columns, 128-byte swizzled (TMA's pattern: chunk c of a
// 128-byte row r sits at c ^ (r % 8)); `rsw` is 16 (r % 8), hoisted.
template <int kRowsBox>
__device__ __forceinline__ uint32_t sw_off(int r, int c, uint32_t rsw) {
  return static_cast<uint32_t>((c >> 3) * kRowsBox * 128 + r * 128) +
         ((16u * static_cast<uint32_t>(c & 7)) ^ rsw);
}

// One `rows`-row tile of head `head` from position `pos` by TMA.
template <int D, int kRowsBox>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                          int head, int pos, int b) {
#pragma unroll
  for (int j = 0; j < Tiles<D>::kBoxes; ++j)
    tma_load_4d(dst + j * kRowsBox * 128, map, bar, 32 * j, head, pos, b);
}

// s[i][j] = A[ty + H i] . B[tx + 16j] over the D columns, in column order
// (H the CTA's half-warps): A the CTA's held tile (OWN rows), B a streamed
// tile (STR rows).  Per 16-byte chunk of d a lane loads OWN / H A chunks
// (one address per half-warp: a broadcast) and STR / 16 B chunks for 4
// (OWN / H) (STR / 16) FMAs; the swizzle keeps both free of bank conflicts.
template <int D, int OWN, int STR>
__device__ __forceinline__ void dot_block(float (&s)[OWN / Tiles<D>::kHalves][STR / 16],
                                          const uint8_t* a, const uint8_t* b, int ty, int tx) {
  constexpr int H = Tiles<D>::kHalves, KI = OWN / H, RJ = STR / 16;
  const uint32_t asw = 16u * static_cast<uint32_t>(ty & 7);   // rows ty + H i
  const uint32_t bsw = 16u * static_cast<uint32_t>(tx & 7);   // rows tx + 16j
#pragma unroll
  for (int i = 0; i < KI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D / 4; ++c) {
    float4 bf[RJ];
#pragma unroll
    for (int j = 0; j < RJ; ++j)
      bf[j] = *reinterpret_cast<const float4*>(b + sw_off<STR>(tx + 16 * j, c, bsw));
#pragma unroll
    for (int i = 0; i < KI; ++i) {
      const float4 af = *reinterpret_cast<const float4*>(a + sw_off<OWN>(ty + H * i, c, asw));
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        s[i][j] = fmaf(af.x, bf[j].x, s[i][j]);
        s[i][j] = fmaf(af.y, bf[j].y, s[i][j]);
        s[i][j] = fmaf(af.z, bf[j].z, s[i][j]);
        s[i][j] = fmaf(af.w, bf[j].w, s[i][j]);
      }
    }
  }
}

// acc[i][.] += sum over r < STR, in order, of w[i][r] B[r][columns of lane
// tx]: w the half-warp's staged (OWN / H, STR) weights (index r stored at
// r ^ psw), B a streamed tile.  A lane owns columns 4 (tx + 16 c) .. + 3
// (c < kVec), plus 64 kVec + tx at d = 80.  Per 4 rows, OWN / H float4
// weight loads (broadcast) and 4 D / 64 row chunks feed (OWN / H) D / 4 FMAs.
template <int D, int OWN, int STR>
__device__ __forceinline__ void accumulate(float (&acc)[OWN / Tiles<D>::kHalves][Tiles<D>::kCols],
                                           const float* w, const uint8_t* b, int tx, int psw) {
  using T = Tiles<D>;
  constexpr int KI = OWN / T::kHalves;
  constexpr int kBoxBytes = STR * 128;
  // two 8-row groups in flight, but one where the lane holds 64 or more
  // accumulators (d = 256: more would spill or slow the dK/dV kernel)
#pragma unroll (KI * T::kCols < 64 ? 2 : 1)
  for (int r8 = 0; r8 < STR; r8 += 8)
#pragma unroll
    for (int r4 = r8; r4 < r8 + 8; r4 += 4) {
      float4 wf[KI];
#pragma unroll
      for (int i = 0; i < KI; ++i)
        wf[i] = *reinterpret_cast<const float4*>(w + i * STR + (r4 ^ psw));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t rsw = 16u * static_cast<uint32_t>((r4 - r8 + u) & 7);   // row % 8
        const uint8_t* row = b + (r4 + u) * 128;
        float wu[KI];
#pragma unroll
        for (int i = 0; i < KI; ++i)
          wu[i] = u == 0 ? wf[i].x : u == 1 ? wf[i].y : u == 2 ? wf[i].z : wf[i].w;
#pragma unroll
        for (int c = 0; c < T::kVec; ++c) {
          const int chunk = tx + 16 * c;
          const float4 vf = *reinterpret_cast<const float4*>(
              row + (chunk >> 3) * kBoxBytes + ((16u * (chunk & 7)) ^ rsw));
#pragma unroll
          for (int i = 0; i < KI; ++i) {
            acc[i][4 * c + 0] = fmaf(wu[i], vf.x, acc[i][4 * c + 0]);
            acc[i][4 * c + 1] = fmaf(wu[i], vf.y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(wu[i], vf.z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(wu[i], vf.w, acc[i][4 * c + 3]);
          }
        }
        if constexpr (T::kScalar > 0) {
          // column 64 kVec + tx: box 2 kVec, chunk tx / 4, word tx % 4
          const float vv = *reinterpret_cast<const float*>(
              row + 2 * T::kVec * kBoxBytes + ((16u * (tx >> 2)) ^ rsw) + 4 * (tx & 3));
#pragma unroll
          for (int i = 0; i < KI; ++i)
            acc[i][4 * T::kVec] = fmaf(wu[i], vv, acc[i][4 * T::kVec]);
        }
      }
    }
}

// A warp is done with ring stage `st` (step t): the last of the CTA's
// kWarps warps to say so (its ticket ends a group of kWarps) loads step
// t + kStages into it, if there is one, by calling `load`.  Nobody waits.
template <int kWarps, typename Load>
__device__ __forceinline__ void release(uint32_t* ticket, int st, int lane, bool more,
                                        const Load& load) {
  __syncwarp();                             // the warp's reads of the stage are done
  if (lane == 0) {
    __threadfence_block();
    if ((atomicAdd(ticket + st, 1u) & (kWarps - 1u)) == kWarps - 1u && more) {
      __threadfence_block();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load();
    }
  }
}

// Stores a lane's columns of row `row` (4 (tx + 16 c) .. + 3, and 64 kVec +
// tx at d = 80), times `mul`.
template <int D>
__device__ __forceinline__ void store_row(float* row, const float (&acc)[Tiles<D>::kCols],
                                          int tx, float mul) {
  using T = Tiles<D>;
#pragma unroll
  for (int c = 0; c < T::kVec; ++c)
    *reinterpret_cast<float4*>(row + 4 * (tx + 16 * c)) =
        make_float4(acc[4 * c] * mul, acc[4 * c + 1] * mul, acc[4 * c + 2] * mul,
                    acc[4 * c + 3] * mul);
  if constexpr (T::kScalar > 0) row[64 * T::kVec + tx] = acc[4 * T::kVec] * mul;
}

// dK/dV: one CTA per (batch, KV head, kKeys-key tile, head split).  Thread
// (ty, tx) (ty = the half-warp) owns keys ty + H i and their dK, dV columns
// (`accumulate`'s); per (head, query tile) step it forms the S^T and dP^T
// blocks of its keys against query rows tx + 16j (`dot_block`), P^T =
// exp2(S^T scale log2 e - lse log2 e) and dS^T = P^T (dP^T - D), stages them
// in the half-warp's weight tiles (so only __syncwarp guards them), then
// dV += P^T dO and dK += dS^T Q.  The (Q, dO) tiles of the CTA's query
// heads (head-major, then query tiles) stream through the ring.
template <int D>
__global__ void __launch_bounds__(Tiles<D>::kThreads, Tiles<D>::kPerSmKV)
bwd_dkdv_f32_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap domap, Params p, float scale_log2) {
  using T = Tiles<D>;
  constexpr int OWN = T::kKeys, STR = T::kRows, H = T::kHalves, KI = OWN / H, RJ = STR / 16;
  constexpr int kOwnBytes = T::kKeyBytes, kStrBytes = T::kRowBytes;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* k_s = smem_raw + (((raw + 1023u) & ~1023u) - raw);   // 1 KB aligned
  uint8_t* v_s = k_s + kOwnBytes;
  uint8_t* ring = v_s + kOwnBytes;                  // stage st: Q, then dO
  float* w_s = reinterpret_cast<float*>(ring + 2 * kStages * kStrBytes);   // P^T, dS^T
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(w_s + 2 * OWN * STR);
  uint64_t* full = full_kv + 1;
  uint32_t* ticket = reinterpret_cast<uint32_t*>(full + kStages);

  const int sp = blockIdx.x % p.split;
  const int bg = blockIdx.x / p.split;
  const int b = bg / p.n_kv, g = bg - b * p.n_kv;
  const int j0 = blockIdx.y * OWN;                  // key tile 0 first (causal: heaviest)
  const int per = p.n_heads / p.n_kv / p.split;     // query heads of this CTA
  const int h0 = (g * p.split + sp) * per;
  int lo, hi;
  row_range(p, j0, min(j0 + OWN, p.skv), &lo, &hi);
  const int it0 = (lo / STR) * STR;
  const int n_qt = hi > lo ? (hi - it0 + STR - 1) / STR : 0;
  const int n = per * n_qt;                         // (head, query tile) steps, head-major
  auto load_step = [&](int t) {
    uint8_t* dst = ring + 2 * (t % kStages) * kStrBytes;
    const int h = h0 + t / n_qt, i0 = it0 + (t % n_qt) * STR;
    mbar_expect_tx(full + t % kStages, 2 * kStrBytes);
    load_tile<D, STR>(dst, &qmap, full + t % kStages, h, i0, b);
    load_tile<D, STR>(dst + kStrBytes, &domap, full + t % kStages, h, i0, b);
  };

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      ticket[s] = 0;
    }
    mbar_init_fence();
    if (n > 0) {
      mbar_expect_tx(full_kv, 2 * kOwnBytes);
      load_tile<D, OWN>(k_s, &kmap, full_kv, g, j0, b);
      load_tile<D, OWN>(v_s, &vmap, full_kv, g, j0, b);
      for (int t = 0; t < kStages && t < n; ++t) load_step(t);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ty = warp * 2 + (lane >> 4);
  const int tx = lane & 15;
  const int psw = 16 * (ty & 1);                    // the weight tiles' row-index swizzle
  float* pw = w_s + ty * KI * STR;                  // this half-warp's P^T
  float* dsw = pw + OWN * STR;                      // and dS^T
  float dk[KI][T::kCols], dv[KI][T::kCols];
#pragma unroll
  for (int i = 0; i < KI; ++i)
#pragma unroll
    for (int c = 0; c < T::kCols; ++c) dk[i][c] = dv[i][c] = 0.f;
  if (n > 0) mbar_wait(full_kv, 0);

  for (int t = 0; t < n; ++t) {
    const int st = t % kStages;
    const int h = h0 + t / n_qt, i0 = it0 + (t % n_qt) * STR;
    const uint8_t* q_t = ring + 2 * st * kStrBytes;
    const uint8_t* do_t = q_t + kStrBytes;
    float nl[RJ], dd[RJ];                           // the rows' -lse log2 e and D
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const int row = i0 + tx + 16 * j;
      const int64_t idx = (static_cast<int64_t>(b) * p.n_heads + h) * p.sq + row;
      nl[j] = row < p.sq ? -p.lse[idx] * kLog2e : 0.f;
      dd[j] = row < p.sq ? p.dsum[idx] : 0.f;
    }
    // the per-element mask only where a mask or an end cuts the tile
    const bool whole = j0 + OWN <= p.skv && i0 + STR <= p.sq &&
                       (!p.causal || j0 + OWN - 1 <= i0 + p.q_offset) &&
                       (p.window <= 0 || j0 > i0 + STR - 1 + p.q_offset - p.window);
    mbar_wait(full + st, (t / kStages) & 1);

    float s[KI][RJ];
    dot_block<D, OWN, STR>(s, k_s, q_t, ty, tx);    // S^T = K Q^T
#pragma unroll
    for (int i = 0; i < KI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        float pv = exp2f(fmaf(s[i][j], scale_log2, nl[j]));
        if (!whole) {
          const int key = j0 + ty + H * i, row = i0 + tx + 16 * j;
          const bool ok = key < p.skv && row < p.sq &&
                          visible(p.causal, p.window, p.q_offset, row, key);
          pv = ok ? pv : 0.f;
        }
        pw[i * STR + ((tx + 16 * j) ^ psw)] = pv;
      }
    dot_block<D, OWN, STR>(s, v_s, do_t, ty, tx);   // dP^T = V dO^T
#pragma unroll
    for (int i = 0; i < KI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int at = i * STR + ((tx + 16 * j) ^ psw);   // this lane's own P^T
        dsw[at] = pw[at] * (s[i][j] - dd[j]);
      }
    __syncwarp();                                   // the half-warp's P^T and dS^T
    accumulate<D, OWN, STR>(dv, pw, do_t, tx, psw);
    accumulate<D, OWN, STR>(dk, dsw, q_t, tx, psw);
    release<T::kThreads / 32>(ticket, st, lane, t + kStages < n, [&] { load_step(t + kStages); });
  }

  // dK (scaled) and dV at split 1, else this split's fp32 partials
  const int64_t part_n = static_cast<int64_t>(p.b) * p.skv * p.n_kv * D;
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int key = j0 + ty + H * i;
    if (key >= p.skv) continue;
    const int64_t at = ((static_cast<int64_t>(b) * p.skv + key) * p.n_kv + g) * D;
    if (p.part == nullptr) {
      store_row<D>(static_cast<float*>(p.dk) + at, dk[i], tx, p.scale);
      store_row<D>(static_cast<float*>(p.dv) + at, dv[i], tx, 1.f);
    } else {
      store_row<D>(p.part + sp * part_n + at, dk[i], tx, 1.f);
      store_row<D>(p.part + (p.split + sp) * part_n + at, dv[i], tx, 1.f);
    }
  }
}

// dQ: one CTA per (batch, query head, kRows-query tile).  The half-warp ty
// owns query rows ty + H i; the CTA first forms D = rowsum(dO O) of its rows
// from out and dout (and writes it for the dK/dV pass: no other CTA visits
// these rows), then walks its visible key tiles through the (K, V) ring:
// the S and dP blocks against keys tx + 16j, dS = P (dP - D) staged in the
// half-warp's weight tile, dQ += dS K.
template <int D>
__global__ void __launch_bounds__(Tiles<D>::kThreads, Tiles<D>::kPerSmQ)
bwd_dq_f32_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap domap, Params p, float scale_log2) {
  using T = Tiles<D>;
  constexpr int OWN = T::kRows, STR = T::kKeys, H = T::kHalves, KI = OWN / H, RJ = STR / 16;
  constexpr int kOwnBytes = T::kRowBytes, kStrBytes = T::kKeyBytes;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* q_s = smem_raw + (((raw + 1023u) & ~1023u) - raw);   // 1 KB aligned
  uint8_t* do_s = q_s + kOwnBytes;
  uint8_t* ring = do_s + kOwnBytes;                 // stage st: K, then V
  float* w_s = reinterpret_cast<float*>(ring + 2 * kStages * kStrBytes);   // dS
  uint64_t* full_q = reinterpret_cast<uint64_t*>(w_s + OWN * STR);
  uint64_t* full = full_q + 1;
  uint32_t* ticket = reinterpret_cast<uint32_t*>(full + kStages);

  const int b = blockIdx.x / p.n_heads;
  const int h = blockIdx.x - b * p.n_heads;
  const int g = h / (p.n_heads / p.n_kv);
  const int i0 = (gridDim.y - 1 - blockIdx.y) * OWN;   // heaviest tiles first
  int k_begin, k_end;
  key_range(p, i0, min(i0 + OWN, p.sq), &k_begin, &k_end);
  const int kt0 = (k_begin / STR) * STR;
  const int n = k_end > k_begin ? (k_end - kt0 + STR - 1) / STR : 0;
  auto load_step = [&](int t) {
    uint8_t* dst = ring + 2 * (t % kStages) * kStrBytes;
    mbar_expect_tx(full + t % kStages, 2 * kStrBytes);
    load_tile<D, STR>(dst, &kmap, full + t % kStages, g, kt0 + t * STR, b);
    load_tile<D, STR>(dst + kStrBytes, &vmap, full + t % kStages, g, kt0 + t * STR, b);
  };

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      ticket[s] = 0;
    }
    mbar_init_fence();
    if (n > 0) {
      mbar_expect_tx(full_q, 2 * kOwnBytes);
      load_tile<D, OWN>(q_s, &qmap, full_q, h, i0, b);
      load_tile<D, OWN>(do_s, &domap, full_q, h, i0, b);
      for (int t = 0; t < kStages && t < n; ++t) load_step(t);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ty = warp * 2 + (lane >> 4);
  const int tx = lane & 15;
  const int psw = 16 * (ty & 1);
  float* dsw = w_s + ty * KI * STR;                 // this half-warp's dS
  // -lse log2 e and D of rows ty + H i: the half-warp's 16 lanes take the
  // row's 16-byte chunks in turn, then sum over the half-warp
  float nl[KI], dd[KI];
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int row = i0 + ty + H * i;
    const int64_t idx = (static_cast<int64_t>(b) * p.n_heads + h) * p.sq + row;
    nl[i] = row < p.sq ? -p.lse[idx] * kLog2e : 0.f;
    float acc = 0.f;
    if (row < p.sq) {
      const int64_t base = ((static_cast<int64_t>(b) * p.sq + row) * p.n_heads + h) * D;
      const float4* o = reinterpret_cast<const float4*>(static_cast<const float*>(p.out) + base);
      const float4* go = reinterpret_cast<const float4*>(static_cast<const float*>(p.dout) + base);
#pragma unroll
      for (int c = tx; c < D / 4; c += 16) {
        const float4 ov = o[c], gv = go[c];
        acc = fmaf(gv.x, ov.x, acc);
        acc = fmaf(gv.y, ov.y, acc);
        acc = fmaf(gv.z, ov.z, acc);
        acc = fmaf(gv.w, ov.w, acc);
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    dd[i] = acc;
    if (row < p.sq && tx == 0) p.dsum[idx] = acc;
  }
  float dq[KI][T::kCols];
#pragma unroll
  for (int i = 0; i < KI; ++i)
#pragma unroll
    for (int c = 0; c < T::kCols; ++c) dq[i][c] = 0.f;
  if (n > 0) mbar_wait(full_q, 0);

  for (int t = 0; t < n; ++t) {
    const int st = t % kStages;
    const int k0 = kt0 + t * STR;
    const uint8_t* k_t = ring + 2 * st * kStrBytes;
    const uint8_t* v_t = k_t + kStrBytes;
    const bool whole = k0 + STR <= p.skv && i0 + OWN <= p.sq &&
                       (!p.causal || k0 + STR - 1 <= i0 + p.q_offset) &&
                       (p.window <= 0 || k0 > i0 + OWN - 1 + p.q_offset - p.window);
    mbar_wait(full + st, (t / kStages) & 1);
    float s[KI][RJ], dp[KI][RJ];
    dot_block<D, OWN, STR>(s, q_s, k_t, ty, tx);    // S = Q K^T
    dot_block<D, OWN, STR>(dp, do_s, v_t, ty, tx);  // dP = dO V^T
#pragma unroll
    for (int i = 0; i < KI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        float pv = exp2f(fmaf(s[i][j], scale_log2, nl[i]));
        if (!whole) {
          const int row = i0 + ty + H * i, key = k0 + tx + 16 * j;
          const bool ok = key < p.skv && row < p.sq &&
                          visible(p.causal, p.window, p.q_offset, row, key);
          pv = ok ? pv : 0.f;
        }
        dsw[i * STR + ((tx + 16 * j) ^ psw)] = pv * (dp[i][j] - dd[i]);
      }
    __syncwarp();                                   // the half-warp's dS
    accumulate<D, OWN, STR>(dq, dsw, k_t, tx, psw);
    release<T::kThreads / 32>(ticket, st, lane, t + kStages < n, [&] { load_step(t + kStages); });
  }

#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int row = i0 + ty + H * i;
    if (row < p.sq)
      store_row<D>(static_cast<float*>(p.dq) +
                       ((static_cast<int64_t>(b) * p.sq + row) * p.n_heads + h) * D,
                   dq[i], tx, p.scale);
  }
}

// dk = scale * sum of the split partials, dv = their sum, in split order;
// 4 elements a thread
__global__ void __launch_bounds__(256) bwd_reduce_f32_kernel(const float* __restrict__ part,
                                                             float* __restrict__ dk,
                                                             float* __restrict__ dv,
                                                             int64_t part_n, int split,
                                                             float scale) {
  for (int64_t e = 4 * (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x);
       e < part_n; e += 4 * static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float4 sk = *reinterpret_cast<const float4*>(part + e);
    float4 sv = *reinterpret_cast<const float4*>(part + split * part_n + e);
    for (int s = 1; s < split; ++s) {
      const float4 a = *reinterpret_cast<const float4*>(part + s * part_n + e);
      const float4 c = *reinterpret_cast<const float4*>(part + (split + s) * part_n + e);
      sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
      sv.x += c.x; sv.y += c.y; sv.z += c.z; sv.w += c.w;
    }
    *reinterpret_cast<float4*>(dk + e) =
        make_float4(sk.x * scale, sk.y * scale, sk.z * scale, sk.w * scale);
    *reinterpret_cast<float4*>(dv + e) = sv;
  }
}

template <int D>
int launch(const Params& p, cudaStream_t stream) {
  using T = Tiles<D>;
  const int q_tiles = (p.sq + T::kRows - 1) / T::kRows;
  const int k_tiles = (p.skv + T::kKeys - 1) / T::kKeys;
  if (q_tiles > 65535 || k_tiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (p.split < 1 || (p.n_heads / p.n_kv) % p.split != 0 || (p.split > 1) != (p.part != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qmap, kmap, vmap, domap;
  if (!make_map_f32(&qmap, p.q, D, p.n_heads, p.sq, p.b, T::kRows) ||
      !make_map_f32(&kmap, p.k, D, p.n_kv, p.skv, p.b, T::kKeys) ||
      !make_map_f32(&vmap, p.v, D, p.n_kv, p.skv, p.b, T::kKeys) ||
      !make_map_f32(&domap, p.dout, D, p.n_heads, p.sq, p.b, T::kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = smem_limit_once<bwd_dkdv_f32_kernel<D>>(T::kSmemKV);
  if (err == cudaSuccess) err = smem_limit_once<bwd_dq_f32_kernel<D>>(T::kSmemQ);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = p.scale * kLog2e;
  bwd_dq_f32_kernel<D><<<dim3(static_cast<unsigned>(p.b) * p.n_heads, q_tiles), T::kThreads,
                         T::kSmemQ, stream>>>(qmap, kmap, vmap, domap, p, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv_f32_kernel<D><<<dim3(static_cast<unsigned>(p.b) * p.n_kv * p.split, k_tiles),
                           T::kThreads, T::kSmemKV, stream>>>(qmap, kmap, vmap, domap, p,
                                                           scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.split == 1) return static_cast<int>(err);
  const int64_t part_n = static_cast<int64_t>(p.b) * p.skv * p.n_kv * D;
  const int64_t blocks = (part_n / 4 + 255) / 256;
  bwd_reduce_f32_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0,
                          stream>>>(p.part, static_cast<float*>(p.dk), static_cast<float*>(p.dv),
                                    part_n, p.split, p.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ---------------------------------------------------------------- bf16
namespace tc {

constexpr int kRows = 64;            // query rows per tile
constexpr int kKeys = 64;            // keys per tile
constexpr int kStages = 2;           // (Q, dO) or (K, V) ring depth

template <int D>
struct Shape {
  static constexpr int kSubs = (D + 63) / 64;        // 64-column boxes per row
  static constexpr int kTileBytes = kSubs * kSubBytes;
  static constexpr int kSteps = D / 16;              // k16 steps of a d-long product
  // The dK/dV CTA's two consumer warpgroups split its dK and dV by
  // columns at d = 256 (a 64-key tile: its dK and dV are more than one
  // warpgroup's registers), else by keys (a 128-key tile, 64 each, the
  // (Q, dO) tiles shared).
  static constexpr bool kColSplit = D == 256;
  static constexpr int kWG = 2;                      // dK/dV consumer warpgroups
  static constexpr int kKeysCta = kColSplit ? 64 : 128;
  static constexpr int kKeyTiles = kKeysCta / 64;    // 64-key K and V tiles held
  static constexpr int kOwn = kColSplit ? kSubs / 2 : kSubs;   // dK, dV boxes each owns
  // + a producer warpgroup, so that setmaxnreg can move its registers to
  // the consumers
  static constexpr int kThreadsKV = 128 * kWG + 128;
  static constexpr int kThreadsQ = 128 + 32;
  // 1 KB of slack to align the swizzled tiles; K, V and a (Q, dO) ring, two
  // (lse, D) row buffers per warpgroup, 1 + 2 kStages mbarriers
  static constexpr size_t kSmemKV = 1024 +
                                    static_cast<size_t>(kTileBytes) * (2 * kKeyTiles + 2 * kStages) +
                                    kWG * 2 * 2 * kRows * 4 + 8 * (1 + 2 * kStages);
  // Q, dO and a (K, V) ring, 1 + 2 kStages mbarriers
  static constexpr size_t kSmemQ =
      1024 + static_cast<size_t>(kTileBytes) * (2 + 2 * kStages) + 8 * (1 + 2 * kStages);
};

// the warpgroup's own barrier (id 1 + wg; 0 is __syncthreads); immediate
// ids, so the kernel holds 3 of the SM's 16 named barriers, not all of them
__device__ __forceinline__ void wg_barrier(int wg) {
  if (wg == 0) asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// Loads the `kSubs` 64-column boxes of one 64-row tile of (pos, head, b).
template <int D>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                          int head, int pos, int b) {
#pragma unroll
  for (int j = 0; j < Shape<D>::kSubs; ++j)
    tma_load_4d(dst + j * kSubBytes, map, bar, 64 * j, head, pos, b);
}

// Accumulator fragment of m64n64k16 (fp32): register i of thread (warp w of
// its warpgroup, lane l) holds row 16w + l/4 + 8*((i/2)%2), column 8*(i/4)
// + 2*(l%4) + i%2.  Here the rows are keys and the columns query rows.
template <int D>
__global__ void __launch_bounds__(Shape<D>::kThreadsKV, 1)
bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap domap, Params p, float scale_log2) {
  using S = Shape<D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* k_s = smem_raw + (((raw + 1023u) & ~1023u) - raw);   // 1 KB aligned
  uint8_t* v_s = k_s + S::kKeyTiles * S::kTileBytes;
  uint8_t* q_s = v_s + S::kKeyTiles * S::kTileBytes;  // kStages tiles
  uint8_t* do_s = q_s + kStages * S::kTileBytes;      // kStages tiles
  float* stat_s = reinterpret_cast<float*>(do_s + kStages * S::kTileBytes);
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(stat_s + S::kWG * 2 * 2 * kRows);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + kStages;

  const int sp = blockIdx.x % p.split;
  const int bg = blockIdx.x / p.split;
  const int b = bg / p.n_kv, g = bg - b * p.n_kv;
  const int j0 = blockIdx.y * S::kKeysCta;            // key tile 0 first (causal: heaviest)
  const int per = p.n_heads / p.n_kv / p.split;       // query heads of this CTA
  const int h0 = (g * p.split + sp) * per;
  int lo, hi;
  row_range(p, j0, min(j0 + S::kKeysCta, p.skv), &lo, &hi);
  const int it0 = (lo / kRows) * kRows;
  const int n_qt = hi > lo ? (hi - it0 + kRows - 1) / kRows : 0;
  const int n = per * n_qt;                           // (head, query tile) steps, head-major

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 128 * S::kWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= 4 * S::kWG) {
    // ---- producer: one elected lane issues every TMA load.  The CTA has
    // 384 threads, 168 registers each at launch; the producer warpgroup
    // gives its registers to the consumers: 24 + 2 x 240 per SM
    // sub-partition's three warps.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == 4 * S::kWG && lane == 0 && n > 0) {
      mbar_expect_tx(full_kv, 2 * S::kKeyTiles * S::kTileBytes);
#pragma unroll
      for (int kt = 0; kt < S::kKeyTiles; ++kt) {
        load_tile<D>(k_s + kt * S::kTileBytes, &kmap, full_kv, g, j0 + 64 * kt, b);
        load_tile<D>(v_s + kt * S::kTileBytes, &vmap, full_kv, g, j0 + 64 * kt, b);
      }
      for (int t = 0; t < n; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(empty + st, ((t / kStages) - 1) & 1);
        const int h = h0 + t / n_qt, i0 = it0 + (t % n_qt) * kRows;
        mbar_expect_tx(full + st, 2 * S::kTileBytes);
        load_tile<D>(q_s + st * S::kTileBytes, &qmap, full + st, h, i0, b);
        load_tile<D>(do_s + st * S::kTileBytes, &domap, full + st, h, i0, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns dK and dV columns [64 cb, 64 (cb +
  // kOwn)) of keys [jw, jw + 64)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wg = warp / 4;
  const int tw = threadIdx.x % 128;
  const int cb = S::kColSplit ? wg * S::kOwn : 0;     // first column box
  const int kw = S::kColSplit ? 0 : wg;               // key tile
  const int jw = j0 + 64 * kw;
  const int key0 = (warp % 4) * 16 + lane / 4;        // this thread's keys: key0, key0 + 8
  const int qc0 = 2 * (lane % 4);
  float* stat = stat_s + wg * 2 * 2 * kRows;          // [2 buffers][-lse log2 e | D]
  float dk[S::kOwn][32], dv[S::kOwn][32];
#pragma unroll
  for (int j = 0; j < S::kOwn; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[j][i] = dv[j][i] = 0.f;
  const uint32_t k_addr = smem_u32(k_s + kw * S::kTileBytes);
  const uint32_t v_addr = smem_u32(v_s + kw * S::kTileBytes);
  if (n > 0) mbar_wait(full_kv, 0);

  for (int t = 0; t < n; ++t) {
    const int st = t % kStages;
    const uint32_t parity = (t / kStages) & 1;
    const int h = h0 + t / n_qt, i0 = it0 + (t % n_qt) * kRows;
    const uint32_t q_addr = smem_u32(q_s + st * S::kTileBytes);
    const uint32_t do_addr = smem_u32(do_s + st * S::kTileBytes);

    // the tile's rows' -lse log2 e and D into this warpgroup's buffer t % 2
    // (the other buffer may still be read by the previous step)
    float* sb = stat + (t & 1) * 2 * kRows;
    {
      const int r = tw & (kRows - 1), row = i0 + r;
      const int64_t idx = (static_cast<int64_t>(b) * p.n_heads + h) * p.sq + row;
      if (tw < kRows) sb[r] = row < p.sq ? -p.lse[idx] * kLog2e : 0.f;
      else sb[kRows + r] = row < p.sq ? p.dsum[idx] : 0.f;
    }

    // S^T = K Q^T and dP^T = V dO^T, fp32
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    mbar_wait(full + st, parity);
    fence_regs(s);
    fence_regs(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < S::kSteps; ++kk)
      wgmma_ss(s, sw128_desc(k_addr + kmajor_step(kk)), sw128_desc(q_addr + kmajor_step(kk)),
               kk > 0);
#pragma unroll
    for (int kk = 0; kk < S::kSteps; ++kk)
      wgmma_ss(dp, sw128_desc(v_addr + kmajor_step(kk)),
               sw128_desc(do_addr + kmajor_step(kk)), kk > 0);
    wg_commit();
    wg_barrier(wg);                                  // sb written by the warpgroup
    wg_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T; the per-element mask only where a mask or an end cuts
    const bool whole = jw + kKeys <= p.skv && i0 + kRows <= p.sq &&
                       (!p.causal || jw + kKeys - 1 <= i0 + p.q_offset) &&
                       (p.window <= 0 || jw > i0 + kRows - 1 + p.q_offset - p.window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qc = 8 * (i >> 2) + qc0 + (i & 1);
      float pv = exp2f(fmaf(s[i], scale_log2, sb[qc]));
      if (!whole) {
        const int kpos = jw + key0 + 8 * ((i >> 1) & 1);
        const bool ok = kpos < p.skv && i0 + qc < p.sq &&
                        visible(p.causal, p.window, p.q_offset, i0 + qc, kpos);
        pv = ok ? pv : 0.f;
      }
      s[i] = pv;
      dp[i] = pv * (dp[i] - sb[kRows + qc]);
    }
    uint32_t pa[4][4], da[4][4];
    pack_a(s, pa);
    pack_a(dp, da);

    // dV += P^T dO, dK += dS^T Q over this warpgroup's columns
#pragma unroll
    for (int j = 0; j < S::kOwn; ++j) {
      fence_regs(dv[j]);
      fence_regs(dk[j]);
    }
    wg_fence();
#pragma unroll
    for (int j = 0; j < S::kOwn; ++j)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dv[j], pa[kk], sw128_desc(do_addr + (cb + j) * kSubBytes + kk * 16 * 128));
#pragma unroll
    for (int j = 0; j < S::kOwn; ++j)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dk[j], da[kk], sw128_desc(q_addr + (cb + j) * kSubBytes + kk * 16 * 128));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int j = 0; j < S::kOwn; ++j) {
      fence_regs(dv[j]);
      fence_regs(dk[j]);
    }
    mbar_arrive(empty + st);                         // this stage's Q and dO are free
  }

  // dK (scaled) and dV: bf16 at split 1, else this split's fp32 partials
  const int64_t part_n = static_cast<int64_t>(p.b) * p.skv * p.n_kv * D;
#pragma unroll
  for (int j = 0; j < S::kOwn; ++j)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int key = jw + key0 + 8 * ((i >> 1) & 1);
      const int col = 64 * (cb + j) + 8 * (i >> 2) + qc0;
      if (key >= p.skv || col >= D) continue;
      const int64_t at = ((static_cast<int64_t>(b) * p.skv + key) * p.n_kv + g) * D + col;
      if (p.part == nullptr) {
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.dk) + at) =
            pack_bf16(dk[j][i] * p.scale, dk[j][i + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.dv) + at) =
            pack_bf16(dv[j][i], dv[j][i + 1]);
      } else {
        *reinterpret_cast<float2*>(p.part + sp * part_n + at) =
            make_float2(dk[j][i], dk[j][i + 1]);
        *reinterpret_cast<float2*>(p.part + (p.split + sp) * part_n + at) =
            make_float2(dv[j][i], dv[j][i + 1]);
      }
    }
}

template <int D>
__global__ void __launch_bounds__(Shape<D>::kThreadsQ)
bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap domap, Params p, float scale_log2) {
  using S = Shape<D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* q_s = smem_raw + (((raw + 1023u) & ~1023u) - raw);   // 1 KB aligned
  uint8_t* do_s = q_s + S::kTileBytes;
  uint8_t* k_s = do_s + S::kTileBytes;                // kStages tiles
  uint8_t* v_s = k_s + kStages * S::kTileBytes;       // kStages tiles
  uint64_t* full_q = reinterpret_cast<uint64_t*>(v_s + kStages * S::kTileBytes);
  uint64_t* full = full_q + 1;
  uint64_t* empty = full + kStages;

  const int b = blockIdx.x / p.n_heads;
  const int h = blockIdx.x - b * p.n_heads;
  const int g = h / (p.n_heads / p.n_kv);
  const int i0 = (gridDim.y - 1 - blockIdx.y) * kRows;   // heaviest tiles first
  int k_begin, k_end;
  key_range(p, i0, min(i0 + kRows, p.sq), &k_begin, &k_end);
  const int kt0 = (k_begin / kKeys) * kKeys;
  const int n_tiles = k_end > k_begin ? (k_end - kt0 + kKeys - 1) / kKeys : 0;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == 4) {
    // ---- producer
    if (lane == 0 && n_tiles > 0) {
      mbar_expect_tx(full_q, 2 * S::kTileBytes);
      load_tile<D>(q_s, &qmap, full_q, h, i0, b);
      load_tile<D>(do_s, &domap, full_q, h, i0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(empty + st, ((t / kStages) - 1) & 1);
        const int k0 = kt0 + t * kKeys;
        mbar_expect_tx(full + st, 2 * S::kTileBytes);
        load_tile<D>(k_s + st * S::kTileBytes, &kmap, full + st, g, k0, b);
        load_tile<D>(v_s + st * S::kTileBytes, &vmap, full + st, g, k0, b);
      }
    }
    return;
  }

  // ---- consumers: the warpgroup owns the tile's 64 query rows
  const int row0 = warp * 16 + lane / 4;   // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (lane % 4);
  // -lse log2 e and D of the two rows.  D from the bf16 out and dout: the
  // row's quad of lanes takes its 16-byte chunks in turn, then sums the
  // four lanes; this CTA is the only one that visits these rows, so it
  // writes D for the dK/dV pass (launched after this one).
  float nl[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = i0 + row0 + 8 * r;
    const int64_t idx = (static_cast<int64_t>(b) * p.n_heads + h) * p.sq + row;
    nl[r] = row < p.sq ? -p.lse[idx] * kLog2e : 0.f;
    float acc = 0.f;
    if (row < p.sq) {
      const int64_t base = ((static_cast<int64_t>(b) * p.sq + row) * p.n_heads + h) * D;
      const uint4* o = reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p.out) + base);
      const uint4* g = reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p.dout) + base);
#pragma unroll
      for (int c = lane % 4; c < D / 8; c += 4) {
        const uint4 ov = o[c], gv = g[c];
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 of = __bfloat1622float2(o2[u]), gf = __bfloat1622float2(g2[u]);
          acc = fmaf(gf.x, of.x, acc);
          acc = fmaf(gf.y, of.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dd[r] = acc;
    if (row < p.sq && lane % 4 == 0) p.dsum[idx] = acc;
  }
  float dq[S::kSubs][32];
#pragma unroll
  for (int j = 0; j < S::kSubs; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[j][i] = 0.f;
  const uint32_t q_addr = smem_u32(q_s), do_addr = smem_u32(do_s);
  if (n_tiles > 0) mbar_wait(full_q, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    const uint32_t parity = (t / kStages) & 1;
    const int k0 = kt0 + t * kKeys;
    const uint32_t k_addr = smem_u32(k_s + st * S::kTileBytes);
    const uint32_t v_addr = smem_u32(v_s + st * S::kTileBytes);

    // S = Q K^T and dP = dO V^T, fp32
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    mbar_wait(full + st, parity);
    fence_regs(s);
    fence_regs(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < S::kSteps; ++kk)
      wgmma_ss(s, sw128_desc(q_addr + kmajor_step(kk)), sw128_desc(k_addr + kmajor_step(kk)),
               kk > 0);
#pragma unroll
    for (int kk = 0; kk < S::kSteps; ++kk)
      wgmma_ss(dp, sw128_desc(do_addr + kmajor_step(kk)),
               sw128_desc(v_addr + kmajor_step(kk)), kk > 0);
    wg_commit();
    wg_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // dS; the per-element mask only where a mask or the key end cuts
    const bool whole = k0 + kKeys <= p.skv &&
                       (!p.causal || k0 + kKeys - 1 <= i0 + p.q_offset) &&
                       (p.window <= 0 || k0 > i0 + kRows - 1 + p.q_offset - p.window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float pv = exp2f(fmaf(s[i], scale_log2, nl[r]));
      if (!whole) {
        const int kpos = k0 + 8 * (i >> 2) + col0 + (i & 1);
        const bool ok = kpos < p.skv &&
                        visible(p.causal, p.window, p.q_offset, i0 + row0 + 8 * r, kpos);
        pv = ok ? pv : 0.f;
      }
      dp[i] = pv * (dp[i] - dd[r]);
    }
    uint32_t da[4][4];
    pack_a(dp, da);

    // dQ += dS K
#pragma unroll
    for (int j = 0; j < S::kSubs; ++j) fence_regs(dq[j]);
    wg_fence();
#pragma unroll
    for (int j = 0; j < S::kSubs; ++j)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dq[j], da[kk], sw128_desc(k_addr + j * kSubBytes + kk * 16 * 128));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int j = 0; j < S::kSubs; ++j) fence_regs(dq[j]);
    mbar_arrive(empty + st);               // this stage's K and V are free
  }

#pragma unroll
  for (int j = 0; j < S::kSubs; ++j)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = i0 + row0 + 8 * ((i >> 1) & 1);
      const int col = 64 * j + 8 * (i >> 2) + col0;
      if (row < p.sq && col < D) {
        __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(p.dq) +
                             ((static_cast<int64_t>(b) * p.sq + row) * p.n_heads + h) * D + col;
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(dq[j][i] * p.scale, dq[j][i + 1] * p.scale);
      }
    }
}

// dk = scale * sum of the split partials, dv = their sum, in split order,
// rounded to bf16; 4 elements a thread
__global__ void __launch_bounds__(256) bwd_reduce_tc_kernel(const float* __restrict__ part,
                                                            __nv_bfloat16* __restrict__ dk,
                                                            __nv_bfloat16* __restrict__ dv,
                                                            int64_t part_n, int split,
                                                            float scale) {
  for (int64_t e = 4 * (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x);
       e < part_n; e += 4 * static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float4 sk = *reinterpret_cast<const float4*>(part + e);
    float4 sv = *reinterpret_cast<const float4*>(part + split * part_n + e);
    for (int s = 1; s < split; ++s) {
      const float4 a = *reinterpret_cast<const float4*>(part + s * part_n + e);
      const float4 c = *reinterpret_cast<const float4*>(part + (split + s) * part_n + e);
      sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
      sv.x += c.x; sv.y += c.y; sv.z += c.z; sv.w += c.w;
    }
    *reinterpret_cast<uint2*>(dk + e) =
        make_uint2(pack_bf16(sk.x * scale, sk.y * scale), pack_bf16(sk.z * scale, sk.w * scale));
    *reinterpret_cast<uint2*>(dv + e) = make_uint2(pack_bf16(sv.x, sv.y), pack_bf16(sv.z, sv.w));
  }
}

template <int D>
int launch(const Params& p, cudaStream_t stream) {
  using S = Shape<D>;
  const int q_tiles = (p.sq + kRows - 1) / kRows;
  const int k_tiles = (p.skv + S::kKeysCta - 1) / S::kKeysCta;
  if (q_tiles > 65535 || k_tiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (p.split < 1 || (p.n_heads / p.n_kv) % p.split != 0 || (p.split > 1) != (p.part != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qmap, kmap, vmap, domap;
  if (!make_map_bf16(&qmap, p.q, D, p.n_heads, p.sq, p.b) ||
      !make_map_bf16(&kmap, p.k, D, p.n_kv, p.skv, p.b) ||
      !make_map_bf16(&vmap, p.v, D, p.n_kv, p.skv, p.b) ||
      !make_map_bf16(&domap, p.dout, D, p.n_heads, p.sq, p.b))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = smem_limit_once<bwd_dkdv_tc_kernel<D>>(S::kSmemKV);
  if (err == cudaSuccess) err = smem_limit_once<bwd_dq_tc_kernel<D>>(S::kSmemQ);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = p.scale * kLog2e;
  bwd_dq_tc_kernel<D><<<dim3(static_cast<unsigned>(p.b) * p.n_heads, q_tiles), S::kThreadsQ,
                        S::kSmemQ, stream>>>(qmap, kmap, vmap, domap, p, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv_tc_kernel<D><<<dim3(static_cast<unsigned>(p.b) * p.n_kv * p.split, k_tiles),
                          S::kThreadsKV, S::kSmemKV, stream>>>(qmap, kmap, vmap, domap, p,
                                                               scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.split == 1) return static_cast<int>(err);
  const int64_t part_n = static_cast<int64_t>(p.b) * p.skv * p.n_kv * D;
  const int64_t blocks = (part_n / 4 + 255) / 256;
  bwd_reduce_tc_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0,
                         stream>>>(p.part, static_cast<__nv_bfloat16*>(p.dk),
                                   static_cast<__nv_bfloat16*>(p.dv), part_n, p.split,
                                   p.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// window <= 0 means no sliding window; causal is 0 or 1.  lse: the
// forward's b H sq floats (required).  dsum: b H sq floats.  split: CTAs
// per KV head's query heads in the dK/dV pass, a divisor of H / KV.  part:
// 2 split b skv KV d floats when split > 1, else null.
template <bool kBf16>
int dispatch(const void* q, const void* k, const void* v, const void* out, const void* dout,
             const float* lse, void* dq, void* dk, void* dv, float* dsum, float* part, int b, int sq, int skv, int n_heads, int n_kv, int d, int causal,
             int window, int q_offset, int split, float scale, void* stream) {
  if (b <= 0 || sq <= 0 || n_heads <= 0) return static_cast<int>(cudaGetLastError());
  if (n_kv <= 0 || n_heads % n_kv != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t esize = kBf16 ? 2 : 4;
  if (skv <= 0) {                                   // no key: dq is zero, dk and dv empty
    cudaMemsetAsync(dq, 0, static_cast<size_t>(b) * sq * n_heads * d * esize, s);
    return static_cast<int>(cudaGetLastError());
  }
  const Params p{q, k, v, out, dout, dq, dk, dv, lse, dsum, part,
                 b, sq, skv, n_heads, n_kv, causal, window, q_offset, split, scale};
  switch (d) {
    case 64: return kBf16 ? tc::launch<64>(p, s) : f32::launch<64>(p, s);
    case 80: return kBf16 ? tc::launch<80>(p, s) : f32::launch<80>(p, s);
    case 128: return kBf16 ? tc::launch<128>(p, s) : f32::launch<128>(p, s);
    case 256: return kBf16 ? tc::launch<256>(p, s) : f32::launch<256>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* out, const void* dout, const float* lse,
                                       void* dq, void* dk, void* dv, float* dsum,
                                       float* part, int b, int sq,
                                       int skv, int n_heads, int n_kv, int d, int causal,
                                       int window, int q_offset, int split, float scale,
                                       void* stream) {
  return dispatch<false>(q, k, v, out, dout, lse, dq, dk, dv, dsum, part, b, sq,
                         skv, n_heads, n_kv, d, causal, window, q_offset, split, scale, stream);
}

extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* out, const void* dout, const float* lse,
                                        void* dq, void* dk, void* dv, float* dsum,
                                        float* part, int b, int sq,
                                        int skv, int n_heads, int n_kv, int d, int causal,
                                        int window, int q_offset, int split, float scale,
                                        void* stream) {
  return dispatch<true>(q, k, v, out, dout, lse, dq, dk, dv, dsum, part, b, sq,
                        skv, n_heads, n_kv, d, causal, window, q_offset, split, scale, stream);
}
