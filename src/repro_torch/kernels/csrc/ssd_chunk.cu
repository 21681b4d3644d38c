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
// ~2 L^2 (n + p) + 2 L n p flops on L p inputs and outputs, about 2 GFLOP
// on ~120 MB for a Hymba prefill layer (b=4, nc=32, L=64, h=25, p=64,
// n=16, fp32 in and out), under the card's ridge point.
//
// Design: one block of 256 threads per (head, chunk, batch), 3,200 blocks
// for a Hymba layer.  C B^T does not depend on the head; recomputing it per
// head costs 2 L^2 n flops, a fraction of the 2 L^2 p of y_diag, and keeps
// every block independent.  Shared memory holds B (transposed), C, x, dt,
// the cumulative sums, the (L, L) masked decay matrix M = (C B^T) o
// exp(cum_i - cum_j) and w = exp(cum_{L-1} - cum_l) dt_l B_l, all fp32;
// nothing of the (L, L) matrix reaches device memory.  The decay is only
// evaluated on and below the diagonal (j <= i), where the segment sum is
// <= 0, so exp stays finite whatever dt and A are; above it M is 0.  Thread
// 0 forms the cumulative sum in order.  Each output (y_diag, S) is one
// thread's sequential fp32 sum.  x, B, C are fp32 or bf16 (y_diag takes
// x's dtype); dt and A are fp32.  Limits: shared memory must fit 227 KB
// (the wrapper checks); L = 64, n = 16, p = 64 takes 45 KB.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
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
  __device__ static float load(const T* p) { return __ldg(p); }
  __device__ static void store(T* p, float v) { *p = v; }
};

struct BF16 {
  using T = uint16_t;
  __device__ static float load(const T* p) { return bf16_to_f32(__ldg(p)); }
  __device__ static void store(T* p, float v) { *p = f32_to_bf16(v); }
};

size_t smem_floats(int L, int p, int n) {
  const size_t l = static_cast<size_t>(L);
  return 3 * l * n + l * (l + 1) + l * p + 2 * l;
}

template <typename Tr>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const typename Tr::T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const typename Tr::T* __restrict__ B,
                 const typename Tr::T* __restrict__ C, typename Tr::T* __restrict__ y,
                 float* __restrict__ S, float* __restrict__ g, int nc, int L,
                 int nh, int p, int n) {
  extern __shared__ float smem[];
  float* Bt = smem;                    // [n][L]   B transposed
  float* Cs = Bt + n * L;              // [L][n]
  float* w = Cs + L * n;               // [L][n]   exp(cum_end - cum_l) dt_l B_l
  float* M = w + L * n;                // [L][L+1] masked (C B^T) o decay
  float* xs = M + L * (L + 1);         // [L][p]   x, then dt * x
  float* cum = xs + L * p;             // [L]
  float* dts = cum + L;                // [L]

  const int hi = blockIdx.x;
  const int chunk = blockIdx.z * nc + blockIdx.y;        // flat (batch, chunk)
  const int64_t row0 = static_cast<int64_t>(chunk) * L;  // first of L rows
  const int tid = threadIdx.x;

  for (int idx = tid; idx < L * n; idx += kThreads) {
    const int l = idx / n;
    const int nn = idx - l * n;
    Bt[nn * L + l] = Tr::load(B + row0 * n + idx);
    Cs[idx] = Tr::load(C + row0 * n + idx);
  }
  for (int idx = tid; idx < L * p; idx += kThreads) {
    const int l = idx / p;
    const int pp = idx - l * p;
    xs[idx] = Tr::load(x + ((row0 + l) * nh + hi) * p + pp);
  }
  for (int l = tid; l < L; l += kThreads) dts[l] = __ldg(dt + (row0 + l) * nh + hi);
  __syncthreads();

  if (tid == 0) {
    const float a = __ldg(A + hi);
    float run = 0.f;
    for (int l = 0; l < L; ++l) {
      run += dts[l] * a;
      cum[l] = run;
    }
  }
  __syncthreads();

  const float cum_end = cum[L - 1];
  for (int idx = tid; idx < L * L; idx += kThreads) {
    const int i = idx / L;
    const int j = idx - i * L;
    float val = 0.f;
    if (j <= i) {
      float dot = 0.f;
      for (int nn = 0; nn < n; ++nn) dot = fmaf(Cs[i * n + nn], Bt[nn * L + j], dot);
      val = dot * expf(cum[i] - cum[j]);
    }
    M[i * (L + 1) + j] = val;
  }
  for (int idx = tid; idx < L * n; idx += kThreads) {
    const int l = idx / n;
    const int nn = idx - l * n;
    w[idx] = (expf(cum_end - cum[l]) * dts[l]) * Bt[nn * L + l];
  }
  __syncthreads();

  // outgoing state from the raw x
  float* s_out = S + (static_cast<int64_t>(chunk) * nh + hi) * n * p;
  for (int idx = tid; idx < n * p; idx += kThreads) {
    const int nn = idx / p;
    const int pp = idx - nn * p;
    float acc = 0.f;
    for (int l = 0; l < L; ++l) acc = fmaf(w[l * n + nn], xs[l * p + pp], acc);
    s_out[idx] = acc;
  }
  __syncthreads();

  for (int idx = tid; idx < L * p; idx += kThreads) xs[idx] *= dts[idx / p];
  __syncthreads();

  for (int idx = tid; idx < L * p; idx += kThreads) {
    const int i = idx / p;
    const int pp = idx - i * p;
    float acc = 0.f;
    for (int j = 0; j <= i; ++j) acc = fmaf(M[i * (L + 1) + j], xs[j * p + pp], acc);
    Tr::store(y + ((row0 + i) * nh + hi) * p + pp, acc);
  }
  if (tid == 0) g[static_cast<int64_t>(chunk) * nh + hi] = expf(cum_end);
}

template <typename Tr>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, void* S, void* g, int b, int nc, int L,
           int nh, int p, int n, void* stream) {
  if (b <= 0 || nc <= 0 || nh <= 0) return static_cast<int>(cudaGetLastError());
  if (L <= 0 || p <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_floats(L, p, n) * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  using T = typename Tr::T;
  auto kern = ssd_chunk_kernel<Tr>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nh, nc, b);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y), static_cast<float*>(S),
      static_cast<float*>(g), nc, L, nh, p, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssd_chunk_f32(const void* x, const void* dt, const void* A,
                             const void* B, const void* C, void* y, void* S,
                             void* g, int b, int nc, int L, int nh, int p, int n,
                             void* stream) {
  return launch<F32>(x, dt, A, B, C, y, S, g, b, nc, L, nh, p, n, stream);
}

extern "C" int ssd_chunk_bf16(const void* x, const void* dt, const void* A,
                              const void* B, const void* C, void* y, void* S,
                              void* g, int b, int nc, int L, int nh, int p, int n,
                              void* stream) {
  return launch<BF16>(x, dt, A, B, C, y, S, g, b, nc, L, nh, p, n, stream);
}
