// Eq. 6 aggregation: out[n] = sum_m w[m] * d[m, n], weights pre-normalized.
//
// Replaces: src/repro/kernels/fedavg_agg.py::fedavg_agg (Pallas, TPU), the
// 2-D (param block x mediator block) grid with an fp32 VMEM accumulator.
//
// Bound on the H100: memory.  Each delta element is read once and used for
// one multiply-add, so the kernel moves M*N*sizeof(T) bytes for 2*M*N flops
// (0.5 flop/byte in fp32, far below the card's ridge point).
//
// Design: a 1-D grid over N.  Each thread owns its own columns and walks
// m = 0..M-1 in fixed order into fp32 registers, then writes once in the
// input dtype.  There is no split over M and no atomics, so the result does
// not depend on the launch shape: a fused (M, total) launch over a whole
// parameter tree is bitwise equal to one launch per leaf.  When every row
// start is 16-byte aligned, a thread owns 16 bytes of columns (4 fp32 or
// 8 bf16) and loads them with one vector load per row; otherwise it owns
// one column.  Both paths do the same arithmetic per column.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

struct F32 {
  using T = float;
  static constexpr int kVec = 4;
  __device__ static float load1(const T* p) { return __ldg(p); }
  __device__ static void store1(T* p, float v) { *p = v; }
  __device__ static void load(const T* p, float (&v)[kVec]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ static void store(T* p, const float (&v)[kVec]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

struct BF16 {
  using T = uint16_t;
  static constexpr int kVec = 8;
  __device__ static float load1(const T* p) { return bf16_to_f32(__ldg(p)); }
  __device__ static void store1(T* p, float v) {
    *p = static_cast<uint16_t>(f32_to_bf16(v));
  }
  __device__ static void load(const T* p, float (&v)[kVec]) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = bf16_to_f32(words[i] & 0xffffu);
      v[2 * i + 1] = bf16_to_f32(words[i] >> 16);
    }
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

template <typename Tr>
__global__ void __launch_bounds__(kThreads)
agg_vec_kernel(const typename Tr::T* __restrict__ d, const float* __restrict__ w,
               typename Tr::T* __restrict__ out, int64_t m, int64_t n) {
  const int64_t col =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * Tr::kVec;
  if (col >= n) return;
  float acc[Tr::kVec];
#pragma unroll
  for (int v = 0; v < Tr::kVec; ++v) acc[v] = 0.f;
  for (int64_t r = 0; r < m; ++r) {
    const float wr = __ldg(w + r);
    float x[Tr::kVec];
    Tr::load(d + r * n + col, x);
#pragma unroll
    for (int v = 0; v < Tr::kVec; ++v) acc[v] = fmaf(wr, x[v], acc[v]);
  }
  Tr::store(out + col, acc);
}

template <typename Tr>
__global__ void __launch_bounds__(kThreads)
agg_scalar_kernel(const typename Tr::T* __restrict__ d,
                  const float* __restrict__ w, typename Tr::T* __restrict__ out,
                  int64_t m, int64_t n) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= n) return;
  float acc = 0.f;
  for (int64_t r = 0; r < m; ++r) acc = fmaf(__ldg(w + r), Tr::load1(d + r * n + col), acc);
  Tr::store1(out + col, acc);
}

template <typename Tr>
int launch(const void* d, const void* w, void* out, int64_t m, int64_t n,
           void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  using T = typename Tr::T;
  const T* dp = static_cast<const T*>(d);
  T* op = static_cast<T*>(out);
  const float* wp = static_cast<const float*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned =
      (reinterpret_cast<uintptr_t>(d) % 16 == 0) &&
      (reinterpret_cast<uintptr_t>(out) % 16 == 0) && (n % Tr::kVec == 0);
  if (aligned) {
    const int64_t threads = n / Tr::kVec;
    const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    agg_vec_kernel<Tr><<<blocks, kThreads, 0, s>>>(dp, wp, op, m, n);
  } else {
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    agg_scalar_kernel<Tr><<<blocks, kThreads, 0, s>>>(dp, wp, op, m, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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
