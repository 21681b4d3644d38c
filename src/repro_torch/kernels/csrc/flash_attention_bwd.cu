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
//   P = softmax(S), S = q k^T / sqrt(d) masked;   D_i = sum_c dO_ic O_ic
//   dS = P * (dO v^T - D);   dq = dS k / sqrt(d);   dk = dS^T q / sqrt(d);
//   dv = P^T dO,  dk and dv summed over the H / KV query heads of a KV head.
//
// Bound on the H100: operations.  Five d-long products per visible (query,
// key) pair (S and dO v^T recomputed, then dv, dk and dq), 10 d flops a
// pair, on the CUDA cores here (fp32 FMAs, 67 TFLOP/s): e.g. qwen3-4b's
// training layer (b=4, s=128, H=32, KV=8, d=128, causal) is 0.14 GFLOP.
//
// A first design, simple and exact: fp32 arithmetic from f32 or bf16 inputs
// (D from the bf16 values of out and dout, as the plain version computes
// it), 32 x 32 tiles in shared memory with rows padded to d + 1 floats (so
// a column read across rows hits distinct banks), 256 threads a CTA, no
// tensor cores, no TMA and no atomics: every sum runs in one fixed order,
// so two runs agree bit for bit.  Three kernels in one launch:
//
//   (a) stats: one CTA per (b, h, 32-query tile) recomputes each row's max
//       m and 1 / l over its visible keys (the forward kernels write only
//       out) and D; a row that sees no key gets 1 / l = 0, so its P is 0.
//   (b) dk, dv: one CTA per (b, kv head, 32-key tile) holds k and v and
//       loops over the H / KV query heads of its group and, for each, over
//       the query tiles the masks leave visible; each thread owns d / 8
//       columns of one key's dk and dv in registers.
//   (c) dq: one CTA per (b, h, 32-query tile) loops over the visible key
//       tiles; each thread owns d / 8 columns of one row's dq.
//
// (b) and (c) both recompute P and dS of a (query tile, key tile) pair in
// p_ds_tile: thread t owns query row t / 8 and keys t % 8 + 8 r.  Shared
// memory: 2 tiles (a) or 4 tiles (b, c) of 32 (d + 1) floats, 140,416 bytes
// at d = 256.  Head dims 64, 80, 128 and 256, the forward's, are
// instantiated.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;            // query rows and keys per tile
constexpr int kPLd = kTile + 1;      // row stride of the P and dS tiles

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* m;        // (b, H, sq) row max of the scaled scores
  float* inv_l;    // (b, H, sq) 1 / row sum of exp(s - m), 0 for a row with no key
  float* dsum;     // (b, H, sq) D = rowsum(dO * O)
  int b, sq, skv, n_heads, n_kv, causal, window, q_offset;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// key j is visible to query row i (absolute position q_offset + i)
__device__ __forceinline__ bool visible(const Params& p, int i, int j) {
  const int qpos = p.q_offset + i;
  if (p.causal && j > qpos) return false;
  if (p.window > 0 && j <= qpos - p.window) return false;
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

// rows row0 .. row0 + 31 of head hh of a (b, seq, heads, D) tensor into a
// 32 x (D + 1) fp32 tile, zeros past the sequence
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int seq, int heads, int bi,
                                          int hh, int row0) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    const int pos = row0 + r;
    float x = 0.f;
    if (pos < seq)
      x = to_f(src[((static_cast<int64_t>(bi) * seq + pos) * heads + hh) * D + c]);
    dst[r * (D + 1) + c] = x;
  }
}

// P and dS of query rows [i0, i0 + 32) against keys [j0, j0 + 32): thread t
// owns row t / 8 and keys t % 8 + 8 r; S and dO v^T are d-long fp32 sums
// in column order.  Masked pairs and pairs past either sequence get 0.
template <int D>
__device__ __forceinline__ void p_ds_tile(const Params& p, const float* Qs, const float* dOs,
                                          const float* Ks, const float* Vs, const float* ms,
                                          const float* ils, const float* Ds, float* Ps,
                                          float* dSs, int i0, int j0) {
  const int i = threadIdx.x >> 3, jl = threadIdx.x & 7;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
  const float* qrow = Qs + i * (D + 1);
  const float* grow = dOs + i * (D + 1);
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    const float qv = qrow[c], gv = grow[c];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = jl + 8 * r;
      s[r] = fmaf(qv, Ks[j * (D + 1) + c], s[r]);
      dp[r] = fmaf(gv, Vs[j * (D + 1) + c], dp[r]);
    }
  }
  const int qi = i0 + i;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = jl + 8 * r, kj = j0 + j;
    float pv = 0.f;
    if (qi < p.sq && kj < p.skv && visible(p, qi, kj))
      pv = expf(s[r] * p.scale - ms[i]) * ils[i];
    Ps[i * kPLd + j] = pv;
    dSs[i * kPLd + j] = pv * (dp[r] - Ds[i]);
  }
}

// ---------------------------------------------------------------- (a) stats
template <int D, typename T>
__global__ void __launch_bounds__(kThreads) stats_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * (D + 1);
  float* Ss = Ks + kTile * (D + 1);                 // 32 x kPLd scaled scores
  const int bi = blockIdx.x / p.n_heads, h = blockIdx.x % p.n_heads;
  const int kvh = h / (p.n_heads / p.n_kv);
  const int i0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  load_tile<D>(Qs, q, p.sq, p.n_heads, bi, h, i0);

  // warp w keeps rows 4w .. 4w + 3; lane = key within the tile
  float m_run[4], l_run[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }
  int lo, hi;
  key_range(p, i0, min(i0 + kTile, p.sq), &lo, &hi);
  const int i = threadIdx.x >> 3, jl = threadIdx.x & 7;
  for (int j0 = (lo / kTile) * kTile; j0 < hi; j0 += kTile) {
    __syncthreads();                                // the previous tile's readers
    load_tile<D>(Ks, k, p.skv, p.n_kv, bi, kvh, j0);
    __syncthreads();
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const float* qrow = Qs + i * (D + 1);
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float qv = qrow[c];
#pragma unroll
      for (int r = 0; r < 4; ++r) s[r] = fmaf(qv, Ks[(jl + 8 * r) * (D + 1) + c], s[r]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) Ss[i * kPLd + jl + 8 * r] = s[r] * p.scale;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 4 * warp + r, qi = i0 + row, kj = j0 + lane;
      const bool vis = qi < p.sq && kj < p.skv && visible(p, qi, kj);
      const float sv = vis ? Ss[row * kPLd + lane] : -INFINITY;
      const float tmax = warp_max(sv);
      if (tmax != -INFINITY) {                      // uniform across the warp
        const float nm = fmaxf(m_run[r], tmax);
        const float tsum = warp_sum(vis ? expf(sv - nm) : 0.f);
        l_run[r] = l_run[r] * expf(m_run[r] - nm) + tsum;
        m_run[r] = nm;
      }
    }
  }

  const T* o = static_cast<const T*>(p.out);
  const T* g = static_cast<const T*>(p.dout);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = i0 + 4 * warp + r;
    if (qi >= p.sq) continue;                       // uniform across the warp
    const int64_t base = ((static_cast<int64_t>(bi) * p.sq + qi) * p.n_heads + h) * D;
    float acc = 0.f;
    for (int c = lane; c < D; c += 32) acc = fmaf(to_f(g[base + c]), to_f(o[base + c]), acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      const int64_t row = (static_cast<int64_t>(bi) * p.n_heads + h) * p.sq + qi;
      const bool any = l_run[r] > 0.f;
      p.m[row] = any ? m_run[r] : 0.f;
      p.inv_l[row] = any ? 1.f / l_run[r] : 0.f;
      p.dsum[row] = acc;
    }
  }
}

// the row statistics of query rows [i0, i0 + 32) of (bi, h) into shared
// memory, zeros past the sequence
__device__ __forceinline__ void load_stats(const Params& p, float* ms, float* ils, float* Ds,
                                           int bi, int h, int i0) {
  if (threadIdx.x < kTile) {
    const int qi = i0 + threadIdx.x;
    const int64_t row = (static_cast<int64_t>(bi) * p.n_heads + h) * p.sq + qi;
    const bool in = qi < p.sq;
    ms[threadIdx.x] = in ? p.m[row] : 0.f;
    ils[threadIdx.x] = in ? p.inv_l[row] : 0.f;
    Ds[threadIdx.x] = in ? p.dsum[row] : 0.f;
  }
}

template <int D>
struct Smem {
  static constexpr size_t kStatsBytes = (2 * kTile * (D + 1) + kTile * kPLd) * sizeof(float);
  static constexpr size_t kGradBytes =
      (4 * kTile * (D + 1) + 2 * kTile * kPLd + 3 * kTile) * sizeof(float);
};

// ---------------------------------------------------------------- (b) dk, dv
template <int D, typename T>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * (D + 1);
  float* Qs = Vs + kTile * (D + 1);
  float* dOs = Qs + kTile * (D + 1);
  float* Ps = dOs + kTile * (D + 1);
  float* dSs = Ps + kTile * kPLd;
  float* ms = dSs + kTile * kPLd;
  float* ils = ms + kTile;
  float* Ds = ils + kTile;
  constexpr int kCols = D / 8;                      // columns a thread owns
  const int bi = blockIdx.x / p.n_kv, kvh = blockIdx.x % p.n_kv;
  const int j0 = blockIdx.y * kTile;
  const int rep = p.n_heads / p.n_kv;
  const T* q = static_cast<const T*>(p.q);
  const T* g = static_cast<const T*>(p.dout);
  load_tile<D>(Ks, static_cast<const T*>(p.k), p.skv, p.n_kv, bi, kvh, j0);
  load_tile<D>(Vs, static_cast<const T*>(p.v), p.skv, p.n_kv, bi, kvh, j0);

  const int jr = threadIdx.x >> 3, cl = threadIdx.x & 7;
  float dk[kCols], dv[kCols];
#pragma unroll
  for (int u = 0; u < kCols; ++u) dk[u] = dv[u] = 0.f;
  int lo, hi;
  row_range(p, j0, min(j0 + kTile, p.skv), &lo, &hi);
  for (int r = 0; r < rep; ++r) {                   // the group's query heads, in order
    const int h = kvh * rep + r;
    for (int i0 = (lo / kTile) * kTile; i0 < hi; i0 += kTile) {
      __syncthreads();                              // the previous tile's readers
      load_tile<D>(Qs, q, p.sq, p.n_heads, bi, h, i0);
      load_tile<D>(dOs, g, p.sq, p.n_heads, bi, h, i0);
      load_stats(p, ms, ils, Ds, bi, h, i0);
      __syncthreads();
      p_ds_tile<D>(p, Qs, dOs, Ks, Vs, ms, ils, Ds, Ps, dSs, i0, j0);
      __syncthreads();
      for (int i = 0; i < kTile; ++i) {
        const float pv = Ps[i * kPLd + jr], dsv = dSs[i * kPLd + jr];
        const float* qrow = Qs + i * (D + 1);
        const float* grow = dOs + i * (D + 1);
#pragma unroll
        for (int u = 0; u < kCols; ++u) {
          const int c = cl + 8 * u;
          dv[u] = fmaf(pv, grow[c], dv[u]);
          dk[u] = fmaf(dsv, qrow[c], dk[u]);
        }
      }
    }
  }
  const int kj = j0 + jr;
  if (kj < p.skv) {
    const int64_t base = ((static_cast<int64_t>(bi) * p.skv + kj) * p.n_kv + kvh) * D;
    T* dkp = static_cast<T*>(p.dk);
    T* dvp = static_cast<T*>(p.dv);
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int c = cl + 8 * u;
      put(dkp + base + c, dk[u] * p.scale);
      put(dvp + base + c, dv[u]);
    }
  }
}

// ---------------------------------------------------------------- (c) dq
template <int D, typename T>
__global__ void __launch_bounds__(kThreads) dq_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * (D + 1);
  float* Qs = Vs + kTile * (D + 1);
  float* dOs = Qs + kTile * (D + 1);
  float* Ps = dOs + kTile * (D + 1);
  float* dSs = Ps + kTile * kPLd;
  float* ms = dSs + kTile * kPLd;
  float* ils = ms + kTile;
  float* Ds = ils + kTile;
  constexpr int kCols = D / 8;
  const int bi = blockIdx.x / p.n_heads, h = blockIdx.x % p.n_heads;
  const int kvh = h / (p.n_heads / p.n_kv);
  const int i0 = blockIdx.y * kTile;
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  load_tile<D>(Qs, static_cast<const T*>(p.q), p.sq, p.n_heads, bi, h, i0);
  load_tile<D>(dOs, static_cast<const T*>(p.dout), p.sq, p.n_heads, bi, h, i0);
  load_stats(p, ms, ils, Ds, bi, h, i0);

  const int ir = threadIdx.x >> 3, cl = threadIdx.x & 7;
  float dq[kCols];
#pragma unroll
  for (int u = 0; u < kCols; ++u) dq[u] = 0.f;
  int lo, hi;
  key_range(p, i0, min(i0 + kTile, p.sq), &lo, &hi);
  for (int j0 = (lo / kTile) * kTile; j0 < hi; j0 += kTile) {
    __syncthreads();                                // the previous tile's readers
    load_tile<D>(Ks, k, p.skv, p.n_kv, bi, kvh, j0);
    load_tile<D>(Vs, v, p.skv, p.n_kv, bi, kvh, j0);
    __syncthreads();
    p_ds_tile<D>(p, Qs, dOs, Ks, Vs, ms, ils, Ds, Ps, dSs, i0, j0);
    __syncthreads();
    for (int j = 0; j < kTile; ++j) {
      const float dsv = dSs[ir * kPLd + j];
      const float* krow = Ks + j * (D + 1);
#pragma unroll
      for (int u = 0; u < kCols; ++u) dq[u] = fmaf(dsv, krow[cl + 8 * u], dq[u]);
    }
  }
  const int qi = i0 + ir;
  if (qi < p.sq) {
    const int64_t base = ((static_cast<int64_t>(bi) * p.sq + qi) * p.n_heads + h) * D;
    T* dqp = static_cast<T*>(p.dq);
#pragma unroll
    for (int u = 0; u < kCols; ++u) put(dqp + base + cl + 8 * u, dq[u] * p.scale);
  }
}

// Raises a kernel's dynamic shared memory limit once per instantiation.
template <auto kKernel>
cudaError_t smem_limit_once(size_t bytes) {
  static const cudaError_t err = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  return err;
}

template <int D, typename T>
int launch(const Params& p, cudaStream_t stream) {
  const int q_tiles = (p.sq + kTile - 1) / kTile;
  const int k_tiles = (p.skv + kTile - 1) / kTile;
  if (q_tiles > 65535 || k_tiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = smem_limit_once<stats_kernel<D, T>>(Smem<D>::kStatsBytes);
  if (err == cudaSuccess) err = smem_limit_once<dkdv_kernel<D, T>>(Smem<D>::kGradBytes);
  if (err == cudaSuccess) err = smem_limit_once<dq_kernel<D, T>>(Smem<D>::kGradBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned bh = static_cast<unsigned>(p.b) * p.n_heads;
  const unsigned bkv = static_cast<unsigned>(p.b) * p.n_kv;
  stats_kernel<D, T><<<dim3(bh, q_tiles), kThreads, Smem<D>::kStatsBytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<D, T><<<dim3(bkv, k_tiles), kThreads, Smem<D>::kGradBytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<D, T><<<dim3(bh, q_tiles), kThreads, Smem<D>::kGradBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// window <= 0 means no sliding window; causal is 0 or 1.  scratch holds
// 3 b H sq floats (m, 1 / l, D).
template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* out, const void* dout,
             void* dq, void* dk, void* dv, void* scratch, int b, int sq, int skv, int n_heads,
             int n_kv, int d, int causal, int window, int q_offset, float scale,
             void* stream) {
  if (b <= 0 || sq <= 0 || n_heads <= 0) return static_cast<int>(cudaGetLastError());
  if (n_kv <= 0 || n_heads % n_kv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (skv <= 0) {                                   // no key: dq is zero, dk and dv empty
    cudaMemsetAsync(dq, 0, static_cast<size_t>(b) * sq * n_heads * d * sizeof(T), s);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t rows = static_cast<size_t>(b) * n_heads * sq;
  float* f = static_cast<float*>(scratch);
  const Params p{q, k, v, out, dout, dq, dk, dv, f, f + rows, f + 2 * rows,
                 b, sq, skv, n_heads, n_kv, causal, window, q_offset, scale};
  switch (d) {
    case 64: return launch<64, T>(p, s);
    case 80: return launch<80, T>(p, s);
    case 128: return launch<128, T>(p, s);
    case 256: return launch<256, T>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* out, const void* dout, void* dq, void* dk,
                                       void* dv, void* scratch, int b, int sq, int skv,
                                       int n_heads, int n_kv, int d, int causal, int window,
                                       int q_offset, float scale, void* stream) {
  return dispatch<float>(q, k, v, out, dout, dq, dk, dv, scratch, b, sq, skv, n_heads, n_kv,
                         d, causal, window, q_offset, scale, stream);
}

extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* out, const void* dout, void* dq, void* dk,
                                        void* dv, void* scratch, int b, int sq, int skv,
                                        int n_heads, int n_kv, int d, int causal, int window,
                                        int q_offset, float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, dout, dq, dk, dv, scratch, b, sq, skv,
                                 n_heads, n_kv, d, causal, window, q_offset, scale, stream);
}
