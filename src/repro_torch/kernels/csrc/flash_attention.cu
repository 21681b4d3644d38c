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
// H=25, s=2048, d=64, window 1024), far above the card's ridge point.
//
// Design: this first kernel runs on the fp32 CUDA cores, not the tensor
// cores (a wgmma/TMA design is later work).  One block of 256 threads per
// (64-query tile, query head, batch) loops over 64-key tiles staged in
// shared memory as fp32, with the running max m, denominator l and the
// (64, d) accumulator in registers, all fp32.  KV tiles that the causal and
// window masks leave empty for the whole query tile are skipped, which is
// exact and halves the work at s = 2W.  Query head h reads KV head
// h / (H / KV) directly from the model layout (b, s, KV, d): the GQA repeat
// is never materialized and no transpose is needed.  Thread (ty, tx) owns
// score rows ty + 16i and key columns tx + 16j (i, j < 4), and output
// columns tx + 16j (j < d/16); with rows padded to d+1 floats every shared
// read in the two inner loops is conflict-free or a broadcast.  The ragged
// edges are masked (zero-filled loads, keys >= skv masked, rows >= sq not
// stored).  Semantics follow the TPU kernel: scores scaled by 1/sqrt(d),
// masked scores -1e30, masked p set to 0, output acc / max(l, 1e-30), so a
// row that sees no key is zero.  Head dims 64, 80 and 128 are instantiated.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;          // 16 x 16
constexpr int kRows = kBlockQ / 16;    // score rows per thread
constexpr int kCols = kBlockK / 16;    // score columns per thread
constexpr float kMasked = -1e30f;

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
  __device__ static float load(const T* p) { return __ldg(p); }
  __device__ static void store(T* p, float v) { *p = v; }
};

struct BF16 {
  using T = uint16_t;
  __device__ static float load(const T* p) { return bf16_to_f32(__ldg(p)); }
  __device__ static void store(T* p, float v) { *p = f32_to_bf16(v); }
};

constexpr size_t smem_bytes(int d) {
  return (3 * static_cast<size_t>(kBlockK) * (d + 1) +
          static_cast<size_t>(kBlockQ) * (kBlockK + 1)) * sizeof(float);
}

// Loads rows [row0, row0 + 64) of head `head` from a (b, s, heads, D)
// tensor into dst[64][D + 1] as fp32; rows >= s are zero.
template <typename Tr, int D>
__device__ __forceinline__ void load_tile(float* dst, const typename Tr::T* src,
                                          int batch, int row0, int s, int heads,
                                          int head) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int row = row0 + r;
    float v = 0.f;
    if (row < s)
      v = Tr::load(src + ((static_cast<int64_t>(batch) * s + row) * heads + head) * D + c);
    dst[r * (D + 1) + c] = v;
  }
}

template <typename Tr, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const typename Tr::T* __restrict__ q,
                 const typename Tr::T* __restrict__ k,
                 const typename Tr::T* __restrict__ v,
                 typename Tr::T* __restrict__ out, int sq, int skv, int n_heads,
                 int n_kv, int causal, int window, int q_offset, float scale) {
  constexpr int kDCols = D / 16;       // output columns per thread
  constexpr int kLd = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                    // [64][D + 1]
  float* Ks = Qs + kBlockQ * kLd;      // [64][D + 1]
  float* Vs = Ks + kBlockK * kLd;      // [64][D + 1]
  float* Ps = Vs + kBlockK * kLd;      // [64][65]

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (n_heads / n_kv);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<Tr, D>(Qs, q, b, q0, sq, n_heads, h);

  float m_i[kRows], l_i[kRows], acc[kRows][kDCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_i[i] = kMasked;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDCols; ++j) acc[i][j] = 0.f;
  }

  // Keys any row of this tile can see: [k_begin, k_end).
  const int q_first = q0 + q_offset;
  const int q_last = min(q0 + kBlockQ, sq) - 1 + q_offset;
  int k_begin = 0, k_end = skv;
  if (causal) k_end = min(skv, q_last + 1);
  if (window > 0) k_begin = max(0, q_first - window + 1);

  for (int k0 = (k_begin / kBlockK) * kBlockK; k0 < k_end; k0 += kBlockK) {
    __syncthreads();                   // the previous tile's Ks/Vs/Ps are free
    load_tile<Tr, D>(Ks, k, b, k0, skv, n_kv, g);
    load_tile<Tr, D>(Vs, v, b, k0, skv, n_kv, g);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty + 16 * i) * kLd + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(tx + 16 * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty + 16 * i + q_offset;
      bool ok[kCols];
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool vis = kpos < skv;
        if (causal) vis = vis && kpos <= qpos;
        if (window > 0) vis = vis && kpos > qpos - window;
        ok[j] = vis;
        s[i][j] = vis ? s[i][j] * scale : kMasked;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float corr = expf(m_i[i] - m_new);
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * (kBlockK + 1) + tx + 16 * j] = p;
        rowsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rowsum += __shfl_xor_sync(0xffffffffu, rowsum, off);
      l_i[i] = corr * l_i[i] + rowsum;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDCols; ++j) acc[i][j] *= corr;
    }
    __syncthreads();                   // Ps complete

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[kRows], vv[kDCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty + 16 * i) * (kBlockK + 1) + kk];
#pragma unroll
      for (int j = 0; j < kDCols; ++j) vv[j] = Vs[kk * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kDCols; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
    typename Tr::T* o = out + ((static_cast<int64_t>(b) * sq + row) * n_heads + h) * D;
#pragma unroll
    for (int j = 0; j < kDCols; ++j) Tr::store(o + tx + 16 * j, acc[i][j] / denom);
  }
}

template <typename Tr, int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int b,
             int sq, int skv, int n_heads, int n_kv, int causal, int window,
             int q_offset, float scale, cudaStream_t stream) {
  using T = typename Tr::T;
  auto kern = flash_fwd_kernel<Tr, D>;
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, n_heads, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, skv, n_heads, n_kv, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tr>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int skv, int n_heads, int n_kv, int d, int causal,
           int window, int q_offset, float scale, void* stream) {
  if (b <= 0 || sq <= 0 || n_heads <= 0) return static_cast<int>(cudaGetLastError());
  if (n_kv <= 0 || n_heads % n_kv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_d<Tr, 64>(q, k, v, out, b, sq, skv, n_heads, n_kv, causal,
                              window, q_offset, scale, s);
    case 80:
      return launch_d<Tr, 80>(q, k, v, out, b, sq, skv, n_heads, n_kv, causal,
                              window, q_offset, scale, s);
    case 128:
      return launch_d<Tr, 128>(q, k, v, out, b, sq, skv, n_heads, n_kv, causal,
                               window, q_offset, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// window <= 0 means no sliding window; causal is 0 or 1.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, int b, int sq, int skv,
                                   int n_heads, int n_kv, int d, int causal,
                                   int window, int q_offset, float scale,
                                   void* stream) {
  return launch<F32>(q, k, v, out, b, sq, skv, n_heads, n_kv, d, causal, window,
                     q_offset, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* out, int b, int sq, int skv,
                                    int n_heads, int n_kv, int d, int causal,
                                    int window, int q_offset, float scale,
                                    void* stream) {
  return launch<BF16>(q, k, v, out, b, sq, skv, n_heads, n_kv, d, causal, window,
                      q_offset, scale, stream);
}
