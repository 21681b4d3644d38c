// Eq. 6 aggregation: out[n] = sum_m (w[m] / max(sum w, 1e-12)) * d[m, n],
// from the raw weights, in one launch.
//
// Replaces: src/repro/kernels/fedavg_agg.py::fedavg_agg (Pallas, TPU), the
// 2-D (param block x mediator block) grid with an fp32 VMEM accumulator,
// fed weights that src/repro/kernels/ops.py normalizes before the call.
//
// Bound on the H100: memory.  Each delta element is read once and used for
// one multiply-add, so the kernel moves M*N*sizeof(T) bytes for 2*M*N flops
// (0.5 flop/byte in fp32, far below the card's ridge point).
//
// Design: a 1-D grid over N, sized for the card's 132 SMs (narrower blocks
// when N is small, so every SM gets a block; at most one full wave of
// blocks, striding over N, when N is large).  Each CTA first normalizes
// the raw weights into shared memory: sum w in a fixed order (lane-strided
// partial sums, then a butterfly over one warp), then w[m] / max(sum,
// 1e-12); a zero-weight row stays an exact no-op.  Each thread then owns 16
// bytes of output columns (4 fp32 or 8 bf16) and walks m = 0..M-1 in fixed
// order into fp32 registers, writing once in the input dtype.  There is no
// split over M and no atomics, so the result does not depend on the launch
// shape: a fused (M, total) launch over a whole parameter tree is bitwise
// equal to one launch per leaf.
//
// Vector loads at every width: when N is not a multiple of the vector (or
// the deltas start unaligned), row m starts s_m elements past a 16-byte
// boundary, the same s_m for every thread of the row.  Each thread then
// reads the one aligned 16-byte vector that starts s_m elements before its
// columns; the s_m columns it lacks are the head of its right neighbour's
// vector, passed by a warp shuffle (lane 31 loads that vector itself).  A
// row's head columns thus come from the vector straddling the row start,
// and its tail columns are stored one by one.  An aligned 16-byte vector
// that holds at least one element of the deltas is never loaded past the
// allocation's pages; vectors that hold none are not loaded.  Four rows'
// loads are issued before their multiply-adds.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kSms = 132;
constexpr int kUnroll = 4;             // rows whose loads are in flight together

__device__ __forceinline__ float bf16_to_f32(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

// Round to nearest even, NaN -> canonical quiet NaN (torch's rule).
__device__ __forceinline__ uint32_t f32_to_bf16(float f) {
  uint32_t x = __float_as_uint(f);
  if ((x & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  x += 0x7fffu + ((x >> 16) & 1u);
  return x >> 16;
}

__device__ __forceinline__ uint4 shfl_down(uint4 v) {
  v.x = __shfl_down_sync(0xffffffffu, v.x, 1);
  v.y = __shfl_down_sync(0xffffffffu, v.y, 1);
  v.z = __shfl_down_sync(0xffffffffu, v.z, 1);
  v.w = __shfl_down_sync(0xffffffffu, v.w, 1);
  return v;
}

struct F32 {
  using T = float;
  static constexpr int kVec = 4;
  // the 2*kVec values of two neighbouring vectors, in column order
  __device__ static void unpack(const uint4& lo, const uint4& hi, float (&a)[8]) {
    const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = __uint_as_float(w[i]);
  }
  __device__ static void store1(T* p, float v) { *p = v; }
  __device__ static void store(T* p, const float (&v)[kVec]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

struct BF16 {
  using T = uint16_t;
  static constexpr int kVec = 8;
  __device__ static void unpack(const uint4& lo, const uint4& hi, float (&a)[16]) {
    const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      a[2 * i] = bf16_to_f32(w[i] & 0xffffu);
      a[2 * i + 1] = bf16_to_f32(w[i] >> 16);
    }
  }
  __device__ static void store1(T* p, float v) {
    *p = static_cast<uint16_t>(f32_to_bf16(v));
  }
  __device__ static void store(T* p, const float (&v)[kVec]) {
    uint32_t words[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      words[i] = f32_to_bf16(v[2 * i]) | (f32_to_bf16(v[2 * i + 1]) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(words[0], words[1], words[2],
                                              words[3]);
  }
};

// acc[v] += w * (column v of the thread): element v + S of the two vectors.
template <typename Tr, int S>
__device__ __forceinline__ void fma_shifted(const uint4& lo, const uint4& hi,
                                            float w, float (&acc)[Tr::kVec]) {
  float a[2 * Tr::kVec];
  Tr::unpack(lo, hi, a);
#pragma unroll
  for (int v = 0; v < Tr::kVec; ++v) acc[v] = fmaf(w, a[v + S], acc[v]);
}

template <typename Tr, int S = 0>
__device__ __forceinline__ void fma_row(const uint4& lo, const uint4& hi, int s,
                                        float w, float (&acc)[Tr::kVec]) {
  if constexpr (S + 1 < Tr::kVec) {
    if (s != S) {
      fma_row<Tr, S + 1>(lo, hi, s, w, acc);
      return;
    }
  }
  fma_shifted<Tr, S>(lo, hi, w, acc);   // s is warp-uniform: no divergence
}

// One row's operands: the thread's aligned vector and its right neighbour's.
struct RowVec {
  uint4 lo, hi;
  int s;
};

template <typename Tr>
__device__ __forceinline__ RowVec load_row(const uint4* __restrict__ base,
                                           int64_t row_start, int64_t n_vecs,
                                           int64_t t) {
  constexpr int kVec = Tr::kVec;
  RowVec r;
  r.s = static_cast<int>(row_start % kVec);
  const int64_t v = row_start / kVec + t;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  r.lo = v < n_vecs ? __ldg(base + v) : zero;
  r.hi = zero;
  return r;
}

template <typename Tr>
__device__ __forceinline__ void neighbour(RowVec& r, const uint4* __restrict__ base,
                                          int64_t row_start, int64_t n_vecs,
                                          int64_t t, int lane) {
  r.hi = shfl_down(r.lo);
  if (lane == 31 && r.s != 0) {
    const int64_t v = row_start / Tr::kVec + t + 1;
    r.hi = v < n_vecs ? __ldg(base + v) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// base: the deltas' start rounded down to 16 bytes; a0: elements from base
// to the first delta; out: 16-byte aligned.
template <typename Tr>
__global__ void __launch_bounds__(kMaxThreads)
agg_kernel(const uint4* __restrict__ base, int a0, const float* __restrict__ w,
           typename Tr::T* __restrict__ out, int m, int64_t n) {
  constexpr int kVec = Tr::kVec;
  extern __shared__ float wn[];             // (m,) normalized weights
  __shared__ float denom;
  for (int r = threadIdx.x; r < m; r += blockDim.x) wn[r] = __ldg(w + r);
  __syncthreads();
  if (threadIdx.x < 32) {
    float sum = 0.f;
    for (int r = threadIdx.x; r < m; r += 32) sum += wn[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (threadIdx.x == 0) denom = fmaxf(sum, 1e-12f);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < m; r += blockDim.x) wn[r] = wn[r] / denom;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  // aligned vectors that hold at least one delta; output vectors
  const int64_t n_vecs = (a0 + static_cast<int64_t>(m) * n + kVec - 1) / kVec;
  const int64_t n_out = (n + kVec - 1) / kVec;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  // grid-stride over output vectors; the bound is tested per warp, so every
  // lane of a warp takes part in each shuffle
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t - lane < n_out; t += stride) {
    float acc[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) acc[v] = 0.f;
    int r = 0;
    for (; r + kUnroll <= m; r += kUnroll) {
      RowVec rows[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        rows[u] = load_row<Tr>(base, a0 + (r + u) * n, n_vecs, t);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        neighbour<Tr>(rows[u], base, a0 + (r + u) * n, n_vecs, t, lane);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        fma_row<Tr>(rows[u].lo, rows[u].hi, rows[u].s, wn[r + u], acc);
    }
    for (; r < m; ++r) {
      RowVec row = load_row<Tr>(base, a0 + r * n, n_vecs, t);
      neighbour<Tr>(row, base, a0 + r * n, n_vecs, t, lane);
      fma_row<Tr>(row.lo, row.hi, row.s, wn[r], acc);
    }

    const int64_t col = t * kVec;
    if (col + kVec <= n) {
      Tr::store(out + col, acc);
    } else {
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        if (col + v < n) Tr::store1(out + col + v, acc[v]);
    }
  }
}

template <typename Tr>
int launch(const void* d, const void* w, void* out, int64_t m, int64_t n,
           void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  using T = typename Tr::T;
  constexpr int kVec = Tr::kVec;
  // the weights live in shared memory: at most 48 KB without an opt-in
  if (m <= 0 || m > 12288) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t dp = reinterpret_cast<uintptr_t>(d);
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0 || dp % sizeof(T) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const uint4* base = reinterpret_cast<const uint4*>(dp & ~static_cast<uintptr_t>(15));
  const int a0 = static_cast<int>((dp & 15) / sizeof(T));
  // one thread per output vector, blocks narrow enough to cover the 132 SMs
  // when N is small, and at most one full wave (2,048 threads per SM) when
  // it is large: then each thread walks several vectors
  const int64_t threads = (n + kVec - 1) / kVec;
  int64_t block = threads / kSms / 32 * 32;
  block = block < 64 ? 64 : (block > kMaxThreads ? kMaxThreads : block);
  int64_t blocks = (threads + block - 1) / block;
  const int64_t wave = static_cast<int64_t>(kSms) * (2048 / block);
  if (blocks > wave) blocks = wave;
  agg_kernel<Tr><<<static_cast<unsigned>(blocks), static_cast<unsigned>(block),
                   static_cast<size_t>(m) * sizeof(float),
                   static_cast<cudaStream_t>(stream)>>>(
      base, a0, static_cast<const float*>(w), static_cast<T*>(out),
      static_cast<int>(m), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// d (M, N) f32 or bf16, any element-aligned start; w (M,) raw f32 weights;
// out (N,) 16-byte aligned.
extern "C" int fedavg_agg_f32(const void* d, const void* w, void* out,
                              int64_t m, int64_t n, void* stream) {
  return launch<F32>(d, w, out, m, n, stream);
}

extern "C" int fedavg_agg_bf16(const void* d, const void* w, void* out,
                               int64_t m, int64_t n, void* stream) {
  return launch<BF16>(d, w, out, m, n, stream);
}

// Shared by every wrapper of this library to name a non-zero return code.
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Makes `device`'s primary context current on the calling host thread
// (cudaSetDevice does since CUDA 12).  The wrappers call it on a thread's
// first launch: cuTensorMapEncodeTiled encodes the TMA maps before this
// library's first runtime call there, and it refuses them on a thread
// with no current context (autograd runs the backward on a thread of its
// own, where a warm caching allocator may have made no runtime call yet).
extern "C" int repro_bind_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}
