// Mamba-2 SSD intra-chunk block: for every (batch, chunk, head)
//
//   cum      = cumsum(dt * A[h])                                 (L,)
//   y_diag_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j  (L, p)
//   S        = sum_l exp(cum_{L-1} - cum_l) dt_l B_l x_l^T         (n, p) fp32
//   g        = exp(cum_{L-1})                                      ()     fp32
//
// Replaces: src/repro/kernels/ssd_chunk.py::ssd_chunk (Pallas, TPU), a
// (b, nc, h) grid with one VMEM tile per step.
//
// Bound on the H100: bytes.  Per (batch, chunk, head) the block does
// ~L^2 p / 2 + L n p multiply-adds (y_diag on the lower triangle, S) on L p
// inputs and L p + n p outputs: at a Hymba prefill layer (b=4, nc=32,
// L=64, h=25, p=64, n=16, fp32) ~1.3 GFLOP, 0.02 ms at the CUDA cores'
// 67 TFLOP/s, against ~120 MB, 0.036 ms at 3.35 TB/s.  So fp32 FMAs on
// the CUDA cores (TF32 stays off) can keep up with the bytes, if they are
// fed from registers rather than from shared memory.
//
// Design: a persistent grid, as many CTAs as fit on the card (3 per SM at
// the Hymba shape: 74 KB of shared memory in fp32, 58 KB in bf16, 160
// threads), each walking a contiguous range of the flat (batch, chunk,
// head) items, heads innermost, in two barrier-separated phases per head:
//   * C B^T does not depend on the head: a CTA computes it once per
//     (batch, chunk) it meets (about 3 times per (batch, chunk) at Hymba's
//     25 heads, against 25 before), in 4x4 register tiles, from B and C
//     loaded eight per thread in flight.
//   * x and dt of the next head are in flight by cp.async (16-byte pieces:
//     one head's x is L runs of p contiguous elements at stride h p) while
//     this head computes.
//   * Warp 0 forms the L cumulative sums by a shuffle scan (each lane sums
//     a run, the lanes' totals are scanned, each run is offset), for the
//     next head, in the slack its short product units leave it.
//   * Forming: the decay matrix M'[i][j] = (C_i . B_j) exp(cum_i - cum_j)
//     dt_j on the lower triangle in blocks of 8 rows i, a warp per 8
//     columns j and its lanes along i, stored transposed beside W[l][s] =
//     exp(cum_end - cum_l) dt_l B_l[s]: the same formula with cum_end for
//     cum_i and B for C B^T, so no lane branches, and y_diag and S are one
//     product [M'; W^T] x over l.  The exp is used only where j <= i, where
//     the segment sum cum_i - cum_j is <= 0 (A < 0, dt >= 0), so it stays
//     finite for any dt and A, as the plain version's -inf mask does; a
//     select puts 0 above the diagonal.  It is the hardware exp2, ~1e-6
//     relative on the segment sums that matter, under the 1e-5 tolerance.
//   * Product: register-tiled; a thread owns an 8-row block of y_diag (its
//     steps end at the block's diagonal) or of S by 4 columns of p, 32
//     accumulators, each step's three 16-byte shared-memory reads (two of
//     [M'; W^T], a broadcast within the warp, one of x; 8 bytes for bf16)
//     issued a step ahead of its 32 FMAs.  A 16-byte shared read costs a
//     warp ~4 cycles of the shared-memory pipe (2.5 broadcast), so wider
//     rows of x per thread would starve the FMA pipes less but cost
//     registers the third CTA needs.  y and S leave from registers in
//     16-byte pieces (8 for bf16 y).
// Any L, p, n: shared memory holds L and n rounded up to 8 and p to 4
// (zeros in the padding).  A layout that does not fit drops the second x
// stage (x loaded at the head's start), then the cached C B^T (recomputed
// per head from C and B in shared memory).  The least layout takes no
// more bytes than the per-head kernel before it did for L and n that are
// multiples of 8, so every such shape still runs; where L or n is not, a
// shape that comes within the padding's bytes of the 227 KB limit is
// refused.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mbarrier.cuh"

namespace {

constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ float bf16_to_f32(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

// Round to nearest even, NaN -> canonical quiet NaN (torch's rule).
__device__ __forceinline__ uint16_t f32_to_bf16(float f) {
  uint32_t x = __float_as_uint(f);
  if ((x & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  x += 0x7fffu + ((x >> 16) & 1u);
  return static_cast<uint16_t>(x >> 16);
}

struct F32 {
  using T = float;
  static constexpr int kPer16 = 4;          // elements in 16 bytes
  __device__ __forceinline__ static float load(const T* p) { return __ldg(p); }
  __device__ __forceinline__ static void store(T* p, float v) { *p = v; }
  // 4 consecutive outputs (16-byte aligned)
  __device__ __forceinline__ static void store4(T* p, const float v[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

struct BF16 {
  using T = uint16_t;
  static constexpr int kPer16 = 8;
  __device__ __forceinline__ static float load(const T* p) { return bf16_to_f32(__ldg(p)); }
  __device__ __forceinline__ static void store(T* p, float v) { *p = f32_to_bf16(v); }
  // 4 consecutive outputs (8-byte aligned)
  __device__ __forceinline__ static void store4(T* p, const float v[4]) {
    const uint32_t lo = f32_to_bf16(v[0]) | (static_cast<uint32_t>(f32_to_bf16(v[1])) << 16);
    const uint32_t hi = f32_to_bf16(v[2]) | (static_cast<uint32_t>(f32_to_bf16(v[3])) << 16);
    *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(repro_ptx::smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(repro_ptx::smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 4 consecutive x values of a shared-memory row, as fp32 (16 or 8 bytes)
__device__ __forceinline__ float4 xload4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 xload4(const uint16_t* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}

int round8(int v) { return (v + 7) & ~7; }
int round4(int v) { return (v + 3) & ~3; }

constexpr int kMaxThreads = 256;

// One CTA's shared memory, in floats, chosen on the host (ops.py's
// ssd_chunk_smem_bytes counts the least one); L and n rounded up to 8
// (Lp, np8), p to 4 (pp: a 16-byte x row of fp32, and two stages take
// only 16-byte x rows, so p itself).  Regions, each a multiple of 8 floats:
//   b   [Lp][np8]        B of the (batch, chunk)
//   cb  [Lp][Lp]         cb[j][i] = C_i . B_j (cached mode)
//   at  [Lp][Lp + np8]   at[k][i] = M'[i][k], at[k][Lp + s] = W[k][s]
//   ct  [np8][Lp]        C transposed (cached mode: inside `at`, read only
//                        to form cb, before `at` is formed)
//   x   [2][Lp][pp] of T (stages 2: the next head's by cp.async) or
//       [Lp][pp] fp32 (stages 1: loaded at the head's start)
//   cum [Lp], dt [stages][Lp]
struct Layout {
  int Lp, np8, pp, ldA;
  int cache_cb, stages;
  int o_b, o_cb, o_at, o_ct, o_x, o_cum, o_dt, floats;
};

Layout make_layout(int L, int p, int n, int esize, int cache_cb, int stages) {
  Layout y{};
  y.Lp = round8(L);
  y.np8 = round8(n);
  y.pp = round4(p);
  y.ldA = y.Lp + y.np8;
  y.cache_cb = cache_cb;
  y.stages = stages;
  int off = 0;
  y.o_b = off;
  off += y.Lp * y.np8;
  y.o_cb = off;
  if (cache_cb) off += y.Lp * y.Lp;
  y.o_at = off;
  off += y.Lp * y.ldA;
  y.o_ct = y.o_at;
  if (!cache_cb) {
    y.o_ct = off;
    off += y.np8 * y.Lp;
  }
  y.o_x = off;
  off += stages == 2 ? 2 * y.Lp * y.pp * esize / 4 : y.Lp * y.pp;
  y.o_cum = off;
  off += y.Lp;
  y.o_dt = off;
  off += stages * y.Lp;
  y.floats = off;
  return y;
}

// The richest layout that fits: two x stages (16-byte x rows only), then
// the cached C B^T.  False if none fits.
bool choose_layout(int L, int p, int n, int esize, int xvec, Layout* out) {
  const int order[4][2] = {{1, 2}, {0, 2}, {1, 1}, {0, 1}};
  for (const auto& o : order) {
    if (o[1] == 2 && !xvec) continue;
    const Layout y = make_layout(L, p, n, esize, o[0], o[1]);
    if (static_cast<size_t>(y.floats) * 4 <= kMaxSmem) {
      *out = y;
      return true;
    }
  }
  return false;
}

// Work units per head: 8-row blocks of y_diag and of S, times the
// 4-column tiles of p; threads per CTA for one unit each (64..256).
int units_of(const Layout& y, int p) { return (y.Lp / 8 + y.np8 / 8) * ((p + 3) / 4); }

int threads_of(const Layout& y, int p) {
  const int u = (units_of(y, p) + 31) / 32 * 32;
  return u < 64 ? 64 : (u > kMaxThreads ? kMaxThreads : u);
}

template <typename Tr>
__global__ void __launch_bounds__(kMaxThreads, 2)
ssd_chunk_kernel(const typename Tr::T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const typename Tr::T* __restrict__ B,
                 const typename Tr::T* __restrict__ C, typename Tr::T* __restrict__ y,
                 float* __restrict__ S, float* __restrict__ g, int64_t items, int L,
                 int nh, int p, int n, int yvec, Layout lay) {
  using T = typename Tr::T;
  extern __shared__ __align__(16) float smem[];
  const int Lp = lay.Lp, np8 = lay.np8, pp = lay.pp, ldA = lay.ldA;
  const bool cache = lay.cache_cb;
  float* Bs = smem + lay.o_b;
  float* CB = smem + lay.o_cb;
  float* At = smem + lay.o_at;
  float* Ct = smem + lay.o_ct;
  float* Xs = smem + lay.o_x;
  float* cum = smem + lay.o_cum;
  float* dt0 = smem + lay.o_dt;                 // stage k at + k Lp

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int64_t first = items * blockIdx.x / gridDim.x;
  const int64_t last = items * (blockIdx.x + 1) / gridDim.x;
  if (first >= last) return;

  // x and dt of `item` into stage `st` by cp.async (two stages): 16-byte
  // pieces of x's L rows (runs of p elements at stride h p), dt's L steps
  const int chunks = p / Tr::kPer16;
  auto prefetch = [&](int64_t bc, int h, int st) {
    const T* src = x + (bc * L * nh + h) * p;
    T* dst = reinterpret_cast<T*>(Xs) + static_cast<int64_t>(st) * Lp * pp;
    if (nthreads % chunks == 0) {            // a thread's piece is fixed
      const int rows = nthreads / chunks, piece = tid % chunks;
      for (int l = tid / chunks; l < L; l += rows)
        cp_async16(dst + l * pp + piece * Tr::kPer16,
                   src + static_cast<int64_t>(l) * nh * p + piece * Tr::kPer16);
    } else {
      for (int e = tid; e < L * chunks; e += nthreads) {
        const int l = e / chunks, piece = e - l * chunks;
        cp_async16(dst + l * pp + piece * Tr::kPer16,
                   src + static_cast<int64_t>(l) * nh * p + piece * Tr::kPer16);
      }
    }
    if (warp == 0)
      for (int l = lane; l < L; l += 32)
        cp_async4(dt0 + st * Lp + l, dt + (bc * L + l) * nh + h);
  };

  // B and C of a (batch, chunk), zero-padded, and C B^T in 4x4 register
  // tiles
  auto load_bc = [&](int64_t bc) {
    // eight loads in flight per thread before any is stored
    const T* Bg = B + bc * L * n;
    const T* Cg = C + bc * L * n;
    const int total = Lp * np8;
    for (int e0 = tid; e0 < total; e0 += 8 * nthreads) {
      float bv[8], cv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * nthreads;
        const int l = e / np8, s = e - l * np8;           // Bs order
        const int s2 = e / Lp, l2 = e - s2 * Lp;          // Ct order
        bv[u] = e < total && l < L && s < n ? Tr::load(Bg + l * n + s) : 0.f;
        cv[u] = e < total && l2 < L && s2 < n ? Tr::load(Cg + l2 * n + s2) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * nthreads;
        if (e < total) {
          Bs[e] = bv[u];
          Ct[e] = cv[u];
        }
      }
    }
  };
  auto cb_tiles = [&]() {
    const int nt = Lp / 4;
    for (int t = tid; t < nt * nt; t += nthreads) {
      const int jb = t / nt, ib = t - jb * nt;
      float acc[4][4] = {};
      for (int s = 0; s < n; ++s) {
        const float4 cv = *reinterpret_cast<const float4*>(Ct + s * Lp + 4 * ib);
        const float cs[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float bv = Bs[(4 * jb + r) * np8 + s];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(cs[c], bv, acc[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float4*>(CB + (4 * jb + r) * Lp + 4 * ib) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  };

  // cum of `item` by a shuffle scan (warp 0): each lane sums a run of
  // ceil(L/32) steps, the lanes' totals are scanned, each run is offset;
  // then g
  auto scan = [&](int64_t bc, int h, const float* dts) {
    const float a = __ldg(A + h);
    const int per = (L + 31) / 32;
    const int l0 = min(lane * per, L), l1 = min(l0 + per, L);
    float run = 0.f;
    for (int l = l0; l < l1; ++l) {
      run = __fadd_rn(run, __fmul_rn(dts[l], a));
      cum[l] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl = __fadd_rn(incl, v);
    }
    const float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane > 0)
      for (int l = l0; l < l1; ++l) cum[l] = __fadd_rn(cum[l], excl);
    __syncwarp();
    if (lane == 0) g[bc * nh + h] = expf(cum[L - 1]);
  };
  // the head's x and dt at the start of the pass (one stage)
  auto load_now = [&](int64_t bc, int h) {
    const int64_t row0 = bc * L;
    for (int e = tid; e < L * pp; e += nthreads) {
      const int l = e / pp, col = e - l * pp;
      Xs[e] = col < p ? Tr::load(x + ((row0 + l) * nh + h) * p + col) : 0.f;
    }
    for (int l = tid; l < L; l += nthreads) dt0[l] = __ldg(dt + (row0 + l) * nh + h);
  };

  // (batch, chunk) and head of this item and the next, stepped without a
  // division
  int64_t bc = first / nh;
  int h = static_cast<int>(first - bc * nh);
  int64_t bc1 = h + 1 < nh ? bc : bc + 1;
  int h1 = h + 1 < nh ? h + 1 : 0;
  int64_t cur_bc = -1;
  if (lay.stages == 2) {
    prefetch(bc, h, 0);
    cp_async_commit();
    if (warp == 0) {                  // the first head's cum
      cp_async_wait<0>();
      __syncwarp();
      scan(bc, h, dt0);
    }
  } else {
    cp_async_commit();
  }
  for (int64_t t = first; t < last; ++t) {
    const int st = lay.stages == 2 ? static_cast<int>((t - first) & 1) : 0;
    if (bc != cur_bc) {
      cur_bc = bc;
      load_bc(bc);
      if (cache) {
        __syncthreads();
        cb_tiles();
      }
    }
    if (lay.stages == 2) {
      if (t + 1 < last) prefetch(bc1, h1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();             // this head's x and dt have landed
    } else {                          // one stage: load this head's now
      load_now(bc, h);
      __syncthreads();
      if (warp == 0) scan(bc, h, dt0);
    }
    const float* dts = dt0 + st * Lp;
    __syncthreads();

    // [M'; W^T] transposed, a warp per block of 8 rows j and its lanes
    // along the columns i from the block's diagonal on: at[j][i] =
    // M'[i][j] (0 above the diagonal and in padding rows i >= L), at[j][Lp
    // + s] = W[j][s], the same formula with cum_end for cum_i and B for
    // C B^T, so no lane branches
    {
      const float cend = cum[L - 1];
      for (int jb = warp; 8 * jb < L; jb += nwarps) {
        const int j0 = 8 * jb;
        float cj[8], dj[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int j = min(j0 + r, L - 1);
          cj[r] = cum[j];
          dj[r] = dts[j];
        }
        for (int i = j0 + lane; i < ldA; i += 32) {
          const bool m = i < Lp;                 // a column of M', else of W
          const float ci = m ? cum[min(i, L - 1)] : cend;
          float cb[8];
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const int j = j0 + r;
            if (cache || !m) {
              cb[r] = *(m ? CB + j * Lp + i : Bs + j * np8 + (i - Lp));
            } else {
              cb[r] = 0.f;
              for (int s = 0; s < n; ++s) cb[r] = fmaf(Ct[s * Lp + i], Bs[j * np8 + s], cb[r]);
            }
          }
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const int j = j0 + r;
            const float v = __fmul_rn(__fmul_rn(cb[r], __expf(ci - cj[r])), dj[r]);
            At[j * ldA + i] = (!m || (i >= j && i < L)) ? v : 0.f;
          }
        }
      }
    }
    __syncthreads();

    // the product: a unit is an 8-row block of y_diag (rows i, steps k <
    // i's block end) or of S (steps k < L) by 4 columns, 32 accumulators;
    // each step reads two 16-byte pieces of [M'; W^T]'s column k (a
    // broadcast within the warp's two units) and one of x's row k (8 bytes
    // for bf16 x) for 32 FMAs, the next step's already in flight
    auto product = [&](const auto* X) {
      const int nP = Lp / 8, nJ = (p + 3) / 4;
      const int units = (nP + np8 / 8) * nJ;
      T* yh = y + (bc * L * nh + h) * p;                 // row i at + i nh p
      float* sh = S + (bc * nh + h) * static_cast<int64_t>(n) * p;
      for (int u = tid; u < units; u += nthreads) {
        const int slot = u / nJ, J = u - slot * nJ;
        const bool is_y = slot < nP;
        const int c0 = is_y ? 8 * slot : Lp + 8 * (slot - nP);
        const int steps = is_y ? min(8 * slot + 8, L) : L;
        float acc[8][4];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
        const float* ap = At + c0;
        const auto* xp = X + 4 * J;
        float4 a0 = *reinterpret_cast<const float4*>(ap);
        float4 a1 = *reinterpret_cast<const float4*>(ap + 4);
        float4 xv = xload4(xp);
        for (int k = 0; k < steps; ++k) {
          const int kn = min(k + 1, steps - 1);
          const float4 a0n = *reinterpret_cast<const float4*>(ap + kn * ldA);
          const float4 a1n = *reinterpret_cast<const float4*>(ap + kn * ldA + 4);
          const float4 xn = xload4(xp + kn * pp);
          const float as[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(as[r], xs[c], acc[r][c]);
          a0 = a0n;
          a1 = a1n;
          xv = xn;
        }
        const int col = 4 * J;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          if (is_y) {
            const int i = 8 * slot + r;
            if (i >= L) continue;
            T* dst = yh + static_cast<int64_t>(i) * nh * p + col;
            if (yvec) {
              Tr::store4(dst, acc[r]);
            } else {
#pragma unroll
              for (int c = 0; c < 4; ++c)
                if (col + c < p) Tr::store(dst + c, acc[r][c]);
            }
          } else {
            const int s = 8 * (slot - nP) + r;
            if (s >= n) continue;
            float* dst = sh + static_cast<int64_t>(s) * p + col;
            if (p % 4 == 0) {
              *reinterpret_cast<float4*>(dst) =
                  make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
            } else {
#pragma unroll
              for (int c = 0; c < 4; ++c)
                if (col + c < p) dst[c] = acc[r][c];
            }
          }
        }
      }
    };
    if (lay.stages == 2) {
      const T* xb = reinterpret_cast<const T*>(Xs) + static_cast<int64_t>(st) * Lp * pp;
      product(xb);
      // warp 0 holds the shortest units: then it forms the next head's cum
      if (warp == 0 && t + 1 < last) {
        cp_async_wait<0>();
        __syncwarp();
        scan(bc1, h1, dt0 + (st ^ 1) * Lp);
      }
    } else {
      product(static_cast<const float*>(Xs));
    }
    __syncthreads();
    bc = bc1;
    h = h1;
    if (++h1 == nh) {
      h1 = 0;
      ++bc1;
    }
  }
  cp_async_wait<0>();
}

// Per device and kernel: the dynamic shared memory ceiling is raised once,
// and the CTAs per SM of the last (shared memory, threads) asked for are
// kept, so a call of an unchanged shape queries nothing.
struct Occupancy {
  int device = -1, threads = 0, ctas_per_sm = 0, sms = 0;
  size_t smem = 0;
};

template <typename Tr>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B,
                   const void* C, void* y, void* S, void* g, int b, int nc, int L,
                   int nh, int p, int n, void* stream) {
  using T = typename Tr::T;
  if (b <= 0 || nc <= 0 || nh <= 0) return cudaGetLastError();
  if (L <= 0 || p <= 0 || n <= 0) return cudaErrorInvalidValue;
  const int esize = static_cast<int>(sizeof(T));
  const int xvec = (p * esize) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int yvec = p % 4 == 0 && reinterpret_cast<uintptr_t>(y) % (4 * esize) == 0;
  Layout lay;
  if (!choose_layout(L, p, n, esize, xvec, &lay)) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(lay.floats) * 4;
  const int threads = threads_of(lay, p);
  auto kern = ssd_chunk_kernel<Tr>;
  static Occupancy occ;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (occ.device != dev) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxSmem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&occ.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    occ.device = dev;
    occ.smem = 0;
  }
  if (occ.smem != smem || occ.threads != threads) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ.ctas_per_sm, kern, threads, smem);
    if (err != cudaSuccess) return err;
    if (occ.ctas_per_sm < 1) return cudaErrorInvalidConfiguration;
    occ.smem = smem;
    occ.threads = threads;
  }
  const int64_t items = static_cast<int64_t>(b) * nc * nh;
  const int64_t slots = static_cast<int64_t>(occ.sms) * occ.ctas_per_sm;
  const int ctas = static_cast<int>(items < slots ? items : slots);
  kern<<<ctas, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y), static_cast<float*>(S),
      static_cast<float*>(g), items, L, nh, p, n, yvec, lay);
  return cudaGetLastError();
}

}  // namespace

// The layout a call takes for (L, p, n), element size `esize` (4 or 2) and
// 16-byte x rows or not: C B^T cached (1) or recomputed per head (0), x
// stages (2: prefetched by cp.async), threads per CTA, dynamic shared
// memory in bytes.  No launch; an error where no layout fits.
extern "C" int ssd_chunk_plan(int L, int p, int n, int esize, int xvec, int* cache_cb,
                              int* stages, int* threads, int64_t* smem_bytes) {
  Layout lay;
  if (L <= 0 || p <= 0 || n <= 0 || (esize != 4 && esize != 2) ||
      !choose_layout(L, p, n, esize, xvec, &lay))
    return static_cast<int>(cudaErrorInvalidValue);
  *cache_cb = lay.cache_cb;
  *stages = lay.stages;
  *threads = threads_of(lay, p);
  *smem_bytes = static_cast<int64_t>(lay.floats) * 4;
  return 0;
}

extern "C" int ssd_chunk_f32(const void* x, const void* dt, const void* A,
                             const void* B, const void* C, void* y, void* S,
                             void* g, int b, int nc, int L, int nh, int p, int n,
                             void* stream) {
  return static_cast<int>(launch<F32>(x, dt, A, B, C, y, S, g, b, nc, L, nh, p, n, stream));
}

extern "C" int ssd_chunk_bf16(const void* x, const void* dt, const void* A,
                              const void* B, const void* C, void* y, void* S,
                              void* g, int b, int nc, int L, int nh, int p, int n,
                              void* stream) {
  return static_cast<int>(launch<BF16>(x, dt, A, B, C, y, S, g, b, nc, L, nh, p, n, stream));
}
