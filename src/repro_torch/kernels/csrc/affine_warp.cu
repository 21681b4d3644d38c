// Batched bilinear inverse-affine warp about the image centre (Alg. 2).
//
// Replaces: src/repro/kernels/affine_warp.py::affine_warp (Pallas, TPU),
// which builds an (HW x HW) one-hot gather matrix per image and contracts
// it on the MXU because Mosaic has no dynamic gather.
//
// Bound on the H100: memory.  An output pixel costs ~20 coordinate flops
// plus 8 per channel against 4 tap reads and one write; the taps of
// neighbouring pixels overlap, so device memory sees each image about once
// in and once out: 2*B*H*W*C*4 bytes.
//
// Design: Hopper has a real gather, so there is no matrix: one thread per
// output pixel computes its source coordinate
//   (sy, sx) = mat . (iy - cy, ix - cx) + (cy, cx) + t
// then loops over the channels, reading the four taps directly.  A tap
// outside [0, H-1] x [0, W-1] has weight 0 (zero fill).  Every operation is
// a separately rounded f32 op in the order of the plain PyTorch version
// (no fused multiply-add), so the two agree to the last bits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
affine_warp_kernel(const float* __restrict__ img, const float* __restrict__ mats,
                   const float* __restrict__ trans, float* __restrict__ out,
                   int64_t b, int h, int w, int c) {
  const int64_t pix = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t hw = static_cast<int64_t>(h) * w;
  if (pix >= b * hw) return;
  const int64_t bi = pix / hw;
  const int iy = static_cast<int>((pix - bi * hw) / w);
  const int ix = static_cast<int>(pix - bi * hw - static_cast<int64_t>(iy) * w);
  const float* m = mats + bi * 4;
  const float* t = trans + bi * 2;
  const float cy = (h - 1) * 0.5f, cx = (w - 1) * 0.5f;
  const float dy = __fsub_rn(static_cast<float>(iy), cy);
  const float dx = __fsub_rn(static_cast<float>(ix), cx);
  const float sy = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(__ldg(m + 0), dy),
                                                 __fmul_rn(__ldg(m + 1), dx)),
                                       cy), __ldg(t + 0));
  const float sx = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(__ldg(m + 2), dy),
                                                 __fmul_rn(__ldg(m + 3), dx)),
                                       cx), __ldg(t + 1));
  const float y0 = floorf(sy), x0 = floorf(sx);
  const float fy = __fsub_rn(sy, y0), fx = __fsub_rn(sx, x0);
  const float gy[2] = {__fsub_rn(1.f, fy), fy};
  const float gx[2] = {__fsub_rn(1.f, fx), fx};

  float wgt[4];
  int64_t src[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int oy = k >> 1, ox = k & 1;
    const float yy = y0 + oy, xx = x0 + ox;   // exact: small integers
    const bool valid = yy >= 0.f && yy <= h - 1 && xx >= 0.f && xx <= w - 1;
    wgt[k] = valid ? __fmul_rn(gy[oy], gx[ox]) : 0.f;
    src[k] = valid ? (bi * hw + static_cast<int64_t>(yy) * w + static_cast<int64_t>(xx)) * c
                   : -1;
  }
  float* o = out + pix * c;
  for (int ch = 0; ch < c; ++ch) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (src[k] >= 0) acc = __fadd_rn(acc, __fmul_rn(wgt[k], __ldg(img + src[k] + ch)));
    o[ch] = acc;
  }
}

}  // namespace

extern "C" int affine_warp_f32(const void* img, const void* mats,
                               const void* trans, void* out, int64_t b, int h,
                               int w, int c, void* stream) {
  const int64_t pixels = b * h * w;
  if (pixels <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = static_cast<unsigned>((pixels + kThreads - 1) / kThreads);
  affine_warp_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(mats),
      static_cast<const float*>(trans), static_cast<float*>(out), b, h, w, c);
  return static_cast<int>(cudaGetLastError());
}
