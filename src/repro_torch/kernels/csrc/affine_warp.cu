// Batched bilinear inverse-affine warp about the image centre (Alg. 2).
//
// Replaces: src/repro/kernels/affine_warp.py::affine_warp (Pallas, TPU),
// which builds an (HW x HW) one-hot gather matrix per image and contracts
// it on the MXU because Mosaic has no dynamic gather.
//
// Bound on the H100: memory.  Each image is read once and written once:
// 2*B*H*W*C*4 bytes, against ~20 coordinate operations per pixel and 8 per
// channel.  At the main paths' shapes (B = 7,360 at 28x28x1, B = 4,096 at
// 32x32x3) an image is 3-12 KB, so the card needs many images in flight
// on every SM to reach its memory rate, and the per-pixel integer work
// must stay small enough not to become the limit instead.
//
// Design, staged path (an image of at most kMaxStagedBytes, 16-byte
// aligned): a persistent grid of CTAs, several per SM, each walking the
// images i = blockIdx.x, blockIdx.x + gridDim.x, ...  Thread 0 keeps the
// next whole image in flight into shared memory with bulk asynchronous
// copies (cp.async.bulk, completion on one mbarrier per stage of a
// two-stage ring), so its load overlaps this image's gathers.  Every
// thread computes its pixels' source coordinates, reads the four taps from
// shared memory and writes the result into one of two output images in
// shared memory; thread 0 then stores that image with one bulk copy
// (contiguous and coalesced whatever C is) and refills the freed input
// stage.  All in-image arithmetic is int32; a thread's (row, column) walk
// over the image steps by a constant computed once, so no pixel costs a
// division.  Larger or unaligned images take the direct path: a 2-D grid
// of (pixel tile, image) CTAs gathering the taps from global memory.
//
// Both paths compute every pixel with the same separately rounded f32 ops
// in the order of the plain PyTorch version (ref.affine_warp,
// ref.warp_coords), no fused multiply-add, so they agree with it to the
// last bits.  A tap outside [0, H-1] x [0, W-1] has weight 0 (zero fill).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mbarrier.cuh"

namespace {

using namespace repro_ptx;

// 128 threads per staged CTA, so that many small CTAs (up to 16 per SM)
// keep many images in flight, each CTA with two input and two output
// images: at the main paths' image sizes this beat fewer, larger CTAs with
// deeper rings.
constexpr int kThreads = 128;
constexpr int kDirectThreads = 256;
constexpr int kStages = 2;
// the largest image the staged path takes: 2 + 2 copies of it in one CTA's
// shared memory
constexpr int kMaxStagedBytes = 48 * 1024;

struct Affine {
  float m0, m1, m2, m3, t0, t1;
};

__device__ __forceinline__ Affine load_affine(const float* __restrict__ mats,
                                              const float* __restrict__ trans,
                                              int64_t bi) {
  const float* m = mats + bi * 4;
  const float* t = trans + bi * 2;
  return {__ldg(m + 0), __ldg(m + 1), __ldg(m + 2), __ldg(m + 3), __ldg(t + 0),
          __ldg(t + 1)};
}

// One whole image into shared memory, completing `bytes` on `bar`.
__device__ __forceinline__ void load_image(float* dst, const float* src,
                                           uint32_t bytes, uint64_t* bar) {
  mbar_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void store_image(float* dst, const float* src,
                                            uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// One output pixel (iy, ix): its C channels from the image at `src` (shared
// or global memory) into `dst`, with the f32 ops of ref.affine_warp and
// ref.warp_coords in their order.  The integer work is cut down: floor and
// conversion in one instruction, unsigned range checks, and a tap outside
// [0, H-1] x [0, W-1] read as 0 (its weight times 0 adds +-0, which leaves
// the sum's value unchanged) instead of a branch.  A source coordinate of
// 2^31 or more in magnitude, or NaN, lies outside any image the kernel
// takes (H*W*C < 2^31), so the pixel is 0, as in the plain version.
template <int CT>
__device__ __forceinline__ void warp_pixel(const Affine& a, int iy, int ix, int h, int w,
                                           int c, float cy, float cx,
                                           const float* __restrict__ src,
                                           float* __restrict__ dst) {
  const float dy = __fsub_rn(static_cast<float>(iy), cy);
  const float dx = __fsub_rn(static_cast<float>(ix), cx);
  const float sy = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a.m0, dy),
                                                 __fmul_rn(a.m1, dx)), cy), a.t0);
  const float sx = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a.m2, dy),
                                                 __fmul_rn(a.m3, dx)), cx), a.t1);
  const bool near = fabsf(sy) < 2147483648.f && fabsf(sx) < 2147483648.f;
  const int y0 = __float2int_rd(sy), x0 = __float2int_rd(sx);   // floor, exact here
  // far or NaN: finite weights, so that 0 times a weight stays 0
  const float fy = near ? __fsub_rn(sy, static_cast<float>(y0)) : 0.f;
  const float fx = near ? __fsub_rn(sx, static_cast<float>(x0)) : 0.f;
  const float gy0 = __fsub_rn(1.f, fy), gx0 = __fsub_rn(1.f, fx);
  const unsigned uy = static_cast<unsigned>(y0), ux = static_cast<unsigned>(x0);
  const bool vy0 = near && uy < static_cast<unsigned>(h);
  const bool vy1 = near && uy + 1u < static_cast<unsigned>(h);
  const bool vx0 = ux < static_cast<unsigned>(w), vx1 = ux + 1u < static_cast<unsigned>(w);
  const float w00 = __fmul_rn(gy0, gx0), w01 = __fmul_rn(gy0, fx);
  const float w10 = __fmul_rn(fy, gx0), w11 = __fmul_rn(fy, fx);
  // wraps harmlessly where a tap is outside: it is then never read
  const unsigned i00 = (uy * static_cast<unsigned>(w) + ux) * static_cast<unsigned>(c);
  const unsigned row = static_cast<unsigned>(w) * static_cast<unsigned>(c);
#pragma unroll
  for (int ch = 0; ch < (CT ? CT : c); ++ch) {
    const float v00 = vy0 && vx0 ? src[i00 + ch] : 0.f;
    const float v01 = vy0 && vx1 ? src[i00 + c + ch] : 0.f;
    const float v10 = vy1 && vx0 ? src[i00 + row + ch] : 0.f;
    const float v11 = vy1 && vx1 ? src[i00 + row + c + ch] : 0.f;
    float acc = __fmul_rn(w00, v00);
    acc = __fadd_rn(acc, __fmul_rn(w01, v01));
    acc = __fadd_rn(acc, __fmul_rn(w10, v10));
    dst[ch] = __fadd_rn(acc, __fmul_rn(w11, v11));
  }
}

template <int CT>
__global__ void __launch_bounds__(kThreads)
affine_warp_staged(const float* __restrict__ img, const float* __restrict__ mats,
                   const float* __restrict__ trans, float* __restrict__ out,
                   int64_t b, int h, int w, int c_any) {
  constexpr int stages = kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  const int c = CT ? CT : c_any;
  const int hw = h * w, n = hw * c;
  const uint32_t bytes = static_cast<uint32_t>(n) * 4u;       // a multiple of 16
  float* in_buf = reinterpret_cast<float*>(smem);              // (stages, n)
  float* out_buf = in_buf + stages * n;                        // (2, n)
  uint64_t* full = reinterpret_cast<uint64_t*>(out_buf + 2 * n);  // (stages,)
  const int tid = threadIdx.x;
  const int64_t first = blockIdx.x, step = gridDim.x;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(full + s, 1);
    mbar_init_fence();
    for (int s = 0; s < stages; ++s) {
      const int64_t bi = first + s * step;
      if (bi < b) load_image(in_buf + s * n, img + bi * n, bytes, full + s);
    }
  }
  __syncthreads();

  // this thread's first pixel and the walk's constant step (kThreads
  // pixels = step_y rows + step_x columns)
  const int y_start = tid / w, x_start = tid - (tid / w) * w;
  const int step_y = kThreads / w, step_x = kThreads - step_y * w;
  const float cy = (h - 1) * 0.5f, cx = (w - 1) * 0.5f;

  int j = 0;
  for (int64_t bi = first; bi < b; bi += step, ++j) {
    const int s = j % stages;
    const float* src = in_buf + s * n;
    float* dst = out_buf + (j & 1) * n;
    const Affine a = load_affine(mats, trans, bi);
    mbar_wait(full + s, static_cast<uint32_t>((j / stages) & 1));
    int iy = y_start, ix = x_start;
    for (int p = tid; p < hw; p += kThreads) {
      warp_pixel<CT>(a, iy, ix, h, w, c, cy, cx, src, dst + p * c);
      iy += step_y;
      ix += step_x;
      if (ix >= w) { ix -= w; ++iy; }
    }
    // the output image's writes become visible to the bulk store
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // the store issued one image ago has read its buffer, which the next
    // image overwrites
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      store_image(out + bi * n, dst, bytes);
      const int64_t next = bi + stages * step;
      if (next < b) load_image(in_buf + s * n, img + next * n, bytes, full + s);
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(kDirectThreads)
affine_warp_direct(const float* __restrict__ img, const float* __restrict__ mats,
                   const float* __restrict__ trans, float* __restrict__ out,
                   int64_t b, int h, int w, int c) {
  const int hw = h * w;
  const int p = blockIdx.x * kDirectThreads + threadIdx.x;
  if (p >= hw) return;
  const int iy = p / w, ix = p - (p / w) * w;
  const float cy = (h - 1) * 0.5f, cx = (w - 1) * 0.5f;
  const int64_t n = static_cast<int64_t>(hw) * c;
  for (int64_t bi = blockIdx.y; bi < b; bi += gridDim.y)
    warp_pixel<0>(load_affine(mats, trans, bi), iy, ix, h, w, c, cy, cx, img + bi * n,
                  out + bi * n + static_cast<int64_t>(p) * c);
}

// Input stages of the staged path for an image of `bytes`, or 0 where the
// image takes the direct path.
int staged_stages(const void* img, const void* out, int64_t bytes) {
  const bool aligned = bytes % 16 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return aligned && bytes <= kMaxStagedBytes ? kStages : 0;
}

}  // namespace

extern "C" int affine_warp_f32(const void* img, const void* mats,
                               const void* trans, void* out, int64_t b, int h,
                               int w, int c, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* in_f = static_cast<const float*>(img);
  const auto* m_f = static_cast<const float*>(mats);
  const auto* t_f = static_cast<const float*>(trans);
  auto* out_f = static_cast<float*>(out);
  const int64_t bytes = static_cast<int64_t>(h) * w * c * 4;
  if (staged_stages(img, out, bytes)) {
    // the main paths' channel counts get their own unrolled channel loop
    const auto kernel = c == 1 ? affine_warp_staged<1>
                               : c == 3 ? affine_warp_staged<3> : affine_warp_staged<0>;
    const int smem = static_cast<int>(bytes * (kStages + 2) + 8 * kStages);
    // CTAs resident on the card at this shared-memory size (the last
    // answer is kept: the main paths call with one or two sizes)
    static int last_dev = -1, last_smem = -1, last_resident = 0;
    static const void* last_kernel = nullptr;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev != last_dev || smem != last_smem ||
        last_kernel != reinterpret_cast<const void*>(kernel)) {
      int sms = 0, per_sm = 0;
      if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      smem)) != cudaSuccess ||
          (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
              cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                               smem)) != cudaSuccess)
        return static_cast<int>(err);
      if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
      last_dev = dev;
      last_smem = smem;
      last_kernel = reinterpret_cast<const void*>(kernel);
      last_resident = sms * per_sm;
    }
    const unsigned grid = static_cast<unsigned>(b < last_resident ? b : last_resident);
    kernel<<<grid, kThreads, smem, st>>>(in_f, m_f, t_f, out_f, b, h, w, c);
  } else {
    const int64_t hw = static_cast<int64_t>(h) * w;
    const dim3 grid(static_cast<unsigned>((hw + kDirectThreads - 1) / kDirectThreads),
                    static_cast<unsigned>(b < 65535 ? b : 65535));
    affine_warp_direct<<<grid, kDirectThreads, 0, st>>>(in_f, m_f, t_f, out_f, b, h, w, c);
  }
  return static_cast<int>(cudaGetLastError());
}

// The path a call of this shape and alignment takes: the staged path's
// input stages (2), or 0 for the direct path.
extern "C" int affine_warp_stages(const void* img, const void* out, int h, int w,
                                  int c) {
  return staged_stages(img, out, static_cast<int64_t>(h) * w * c * 4);
}
