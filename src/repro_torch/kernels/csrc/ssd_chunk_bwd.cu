// The gradient of the Mamba-2 SSD intra-chunk block (ssd_chunk.cu), fp32.
// Per (batch, chunk, head), with cum = cumsum(dt A[h]),
//
//   P_ij = (C_i . B_j) exp(cum_i - cum_j)  (j <= i, else 0),   M'_ij = P_ij dt_j
//   e_l  = exp(cum_end - cum_l),                               W_ls  = e_l dt_l B_ls
//
// the forward is [M'; W^T] x (y_diag, S) and g = exp(cum_end).  Given dy,
// dS and dg:
//
//   dx_l   = dt_l (sum_i P_il dy_i + e_l (B dS)_l)            (M'^T dy + W dS)
//   dM'    = dy x^T (lower triangle),   dW = x dS^T
//   dCB_ij = sum_h dM'_ij exp(cum_i - cum_j) dt_j,  dC = dCB B,
//   dB     = dCB^T C + sum_h e dt dW
//   dcum_l = sum_{j<l} G_lj - sum_{i>l} G_il - H_l,  G_ij = dM'_ij P_ij dt_j,
//            H_l = e_l dt_l q_l (l < L - 1),  q_l = sum_s dW_ls B_ls;
//            cum_end also gets sum_l H_l + dg g
//            (G's diagonal and H_{L-1}, each in two terms that cancel, are
//            left out: where dt is steep their rounding would swamp dA)
//   ddt_l  = A d(dA)_l + sum_i dM'_il P_il + e_l q_l,  d(dA) = reverse-cumsum(dcum)
//   dA[h]  = sum over (batch, chunk, l) of dt_l d(dA)_l
//
// cum is summed in fp64: every exponent is a difference of two running
// sums that grow to a few hundred over a chunk, where one fp32 ulp is
// ~3e-5 of absolute error in the exp, which the dt gradient carries.
//
// Replaces: no pallas_call.  The reference differentiates its jnp oracle
// (src/repro/kernels/ref.py::ssd_chunk, and models/ssm.py::ssd_chunked in
// the model) in XLA; the Pallas ssd_chunk (src/repro/kernels/ssd_chunk.py)
// has no backward of its own.  The port's forward is a kernel, so its
// gradient is one too.
//
// Bound on the H100: per (batch, chunk, head) ~2 L^2 p + 4 L n p operations
// (dx and dM' over the triangle, B dS and x dS^T), per (batch, chunk) 3 L^2 n
// (C B^T, dC, dB), against x, dt, B, C, dy and dS read and dx, ddt, dB and
// dC written once: bytes at Hymba's training layer (n = 16), operations at
// mamba2-370m's (n = 128) at the CUDA cores' 67 TFLOP/s (TF32 stays off).
//
// Design: the forward's persistent grid, each CTA walking a contiguous range
// of the flat (batch, chunk, head) items, heads innermost; 256 threads.
//   * B and C of a (batch, chunk) are loaded transposed once per (batch,
//     chunk) a CTA meets, and C B^T is cached beside them where it fits.
//   * Per head: x, dy and dS are loaded transposed (rows of p), warp 0 scans
//     cum, P is formed on the lower triangle (the exp only where j <= i,
//     where the segment sum is <= 0, so it stays finite for any dt and A),
//     then one loop over three kinds of register-tiled 8 x 4 units, each
//     step two 16-byte shared reads of the 8-row operand and one 16-byte (or
//     four 4-byte) read of the 4-column one for 32 FMAs:
//       - dx: (B dS), scaled by e, plus P^T dy, scaled by dt;
//       - dM' = dy x^T on the lower triangle: each element adds its share to
//         dCB (shared memory, one owner per element) and its G and P terms
//         to per-unit row and column partials off the diagonal (its
//         element's P term kept apart);
//       - dW = x dS^T: each element adds e dt dW to the dB term (shared
//         memory, one owner per element) and dW B to per-unit partials of q.
//     The partials are summed per l in a fixed order, and warp 0 runs the
//     reverse scan of dcum and writes ddt and the head's dt d(dA) sum.
//   * dCB and the dB term are summed over the heads a CTA walks.  When the
//     CTA leaves a (batch, chunk) it multiplies them out (dC = dCB B, dB =
//     dCB^T C + term, register-tiled) into its segment's slice of a
//     partials buffer: CTA c's segment of (batch, chunk) bc is c + bc, so
//     the segments never overlap.  A second kernel of the same entry sums
//     each (batch, chunk)'s segments in CTA order, and each head's dA over
//     (batch, chunk) in order: no float atomics, two runs agree bit for bit.
// Any L, p, n: shared memory holds L and n rounded up to 8 and p to 4, the
// transposed rows padded by 4 floats; C B^T is recomputed per element of P
// where caching it does not fit.  ops.ssd_chunk_bwd_smem_bytes counts the
// least layout, the wrapper's admission check.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr size_t kMaxSmem = 232448;
constexpr int kThreads = 256;

int round8(int v) { return (v + 7) & ~7; }
int round4(int v) { return (v + 3) & ~3; }

// One CTA's shared memory, in floats (every region a multiple of 8):
//   bt, ct [np8][Lp]   B and C transposed, of the (batch, chunk)
//   cb     [Lp][Lp]    cb[i][j] = C_i . B_j (cached mode only)
//   dcb    [Lp][Lp]    dCB summed over the CTA's heads of the (batch, chunk)
//   wtb    [np8][Lp]   the dB term sum_h e dt dW, transposed
//   work   per head:   p_ [Lp][Lp], xt, dyt [pp][ldl], dst [pp][lds]
//          at a segment's end: dcbt [Lp][Lp], brow, crow [Lp][np8]
//   rowp [Lp/4][Lp], colp [Lp/8][Lp], qp [np8/8][Lp]   per-unit partials
//   cum [Lp] doubles; dts, ev, dcum, ddt0, hv, dk [Lp]
struct Layout {
  int Lp, np8, pp, ldl, lds, cache_cb;
  int o_bt, o_ct, o_cb, o_dcb, o_wtb, o_work, o_xt, o_dyt, o_dst, o_brow, o_crow;
  int o_rowp, o_colp, o_qp, o_vec, floats;
};

Layout make_layout(int L, int p, int n, int cache_cb) {
  Layout y{};
  y.Lp = round8(L);
  y.np8 = round8(n);
  y.pp = round4(p);
  y.ldl = y.Lp + 4;
  y.lds = y.np8 + 4;
  y.cache_cb = cache_cb;
  const int Lp = y.Lp, np8 = y.np8, pp = y.pp;
  int off = 0;
  y.o_bt = off;
  off += np8 * Lp;
  y.o_ct = off;
  off += np8 * Lp;
  y.o_cb = off;
  if (cache_cb) off += Lp * Lp;
  y.o_dcb = off;
  off += Lp * Lp;
  y.o_wtb = off;
  off += np8 * Lp;
  y.o_work = off;
  y.o_xt = off + Lp * Lp;
  y.o_dyt = y.o_xt + pp * y.ldl;
  y.o_dst = y.o_dyt + pp * y.ldl;
  y.o_brow = off + Lp * Lp;
  y.o_crow = y.o_brow + Lp * np8;
  const int head = Lp * Lp + 2 * pp * y.ldl + pp * y.lds;
  const int seg = Lp * Lp + 2 * Lp * np8;
  off += head > seg ? head : seg;
  y.o_rowp = off;
  off += (Lp / 4) * Lp;
  y.o_colp = off;
  off += (Lp / 8) * Lp;
  y.o_qp = off;
  off += (np8 / 8) * Lp;
  y.o_vec = off;
  off += 8 * Lp;
  y.floats = off;
  return y;
}

// C B^T cached where it fits, else recomputed; false if neither fits.
bool choose_layout(int L, int p, int n, Layout* out) {
  for (int cache = 1; cache >= 0; --cache) {
    const Layout y = make_layout(L, p, n, cache);
    if (static_cast<size_t>(y.floats) * 4 <= kMaxSmem) {
      *out = y;
      return true;
    }
  }
  return false;
}

__device__ __forceinline__ void load8(const float* p, float a[8]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  const float4 v = *reinterpret_cast<const float4*>(p + 4);
  a[0] = u.x; a[1] = u.y; a[2] = u.z; a[3] = u.w;
  a[4] = v.x; a[5] = v.y; a[6] = v.z; a[7] = v.w;
}

__device__ __forceinline__ void load4(const float* p, float b[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  b[0] = u.x; b[1] = u.y; b[2] = u.z; b[3] = u.w;
}

// acc[r][c] += sum_{k0 <= k < k1} a[k][r] b[k][c] over 8 contiguous a values
// (row k at a + k lda) and 4 b values: contiguous (bs == 0, row k at b + k
// ldb) or one per row of a transposed array (b[k][c] at b + c bs + k); the
// next step's operands are read before this step's FMAs.
__device__ __forceinline__ void tile8x4(const float* a, int lda, const float* b, int ldb,
                                        int bs, int k0, int k1, float acc[8][4]) {
  if (k0 >= k1) return;
  float av[8], bv[4];
  auto fetch = [&](int k, float x[8], float y[4]) {
    load8(a + k * lda, x);
    if (bs == 0) {
      load4(b + k * ldb, y);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) y[c] = b[c * bs + k];
    }
  };
  fetch(k0, av, bv);
  for (int k = k0; k < k1; ++k) {
    float an[8], bn[4];
    fetch(k + 1 < k1 ? k + 1 : k, an, bn);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
#pragma unroll
    for (int r = 0; r < 8; ++r) av[r] = an[r];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = bn[c];
  }
}

__device__ __forceinline__ void zero(float acc[8][4]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
}

// The sum over the warp, the same value in every lane (lane 0's).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return __shfl_sync(0xffffffffu, v, 0);
}

__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ B,
               const float* __restrict__ C, const float* __restrict__ dy,
               const float* __restrict__ dS, const float* __restrict__ dg,
               float* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ part,
               float* __restrict__ dapart, int64_t items, int L, int nh, int p, int n,
               int xvec, Layout lay) {
  extern __shared__ __align__(16) float smem[];
  const int Lp = lay.Lp, np8 = lay.np8, pp = lay.pp, ldl = lay.ldl, lds = lay.lds;
  float* bt = smem + lay.o_bt;
  float* ct = smem + lay.o_ct;
  float* cb = smem + lay.o_cb;
  float* dcb = smem + lay.o_dcb;
  float* wtb = smem + lay.o_wtb;
  float* pm = smem + lay.o_work;            // P, per head
  float* xt = smem + lay.o_xt;
  float* dyt = smem + lay.o_dyt;
  float* dst = smem + lay.o_dst;
  float* dcbt = smem + lay.o_work;          // at a segment's end
  float* brow = smem + lay.o_brow;
  float* crow = smem + lay.o_crow;
  float* rowp = smem + lay.o_rowp;
  float* colp = smem + lay.o_colp;
  float* qp = smem + lay.o_qp;
  double* cum = reinterpret_cast<double*>(smem + lay.o_vec);
  float* dts = smem + lay.o_vec + 2 * Lp;
  float* ev = dts + Lp;
  float* dcum = ev + Lp;
  float* ddt0 = dcum + Lp;
  float* hv = ddt0 + Lp;
  float* dk = hv + Lp;                      // dM'_ll P_ll

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int64_t first = items * blockIdx.x / gridDim.x;
  const int64_t last = items * (blockIdx.x + 1) / gridDim.x;
  if (first >= last) return;
  const int nLb = Lp / 8, nLq = Lp / 4, nSb = np8 / 8, nJ = pp / 4;
  const int64_t Ln = static_cast<int64_t>(L) * n;

  // dC and dB of the (batch, chunk) from the CTA's dCB and dB term, into
  // its segment (CTA c, (batch, chunk) bc: segment c + bc)
  auto segment_end = [&](int64_t bc) {
    __syncthreads();
    for (int e = tid; e < Lp * Lp; e += nthreads) {
      const int i = e / Lp, j = e - i * Lp;
      dcbt[j * Lp + i] = dcb[e];
    }
    for (int e = tid; e < np8 * Lp; e += nthreads) {
      const int s = e / Lp, l = e - s * Lp;
      brow[l * np8 + s] = bt[e];
      crow[l * np8 + s] = ct[e];
    }
    __syncthreads();
    float* seg = part + (static_cast<int64_t>(blockIdx.x) + bc) * 2 * Ln;
    const int nS = np8 / 4, units = 2 * nLb * nS;
    for (int u = tid; u < units; u += nthreads) {
      const bool is_db = u >= nLb * nS;
      const int v = is_db ? u - nLb * nS : u;
      const int rb = v / nS, s0 = 4 * (v - rb * nS), r0 = 8 * rb;
      float acc[8][4];
      zero(acc);
      if (is_db) {           // dB[j][s] = sum_{i >= j} dCB[i][j] C[i][s] + term
        tile8x4(dcb + r0, Lp, crow + s0, np8, 0, r0, L, acc);
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] += wtb[(s0 + c) * Lp + r0 + r];
      } else {               // dC[i][s] = sum_{j <= i} dCB[i][j] B[j][s]
        tile8x4(dcbt + r0, Lp, brow + s0, np8, 0, 0, min(r0 + 8, L), acc);
      }
      float* out = seg + (is_db ? Ln : 0);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (r0 + r >= L) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (s0 + c < n) out[static_cast<int64_t>(r0 + r) * n + s0 + c] = acc[r][c];
      }
    }
  };

  int64_t cur_bc = -1;
  for (int64_t t = first; t < last; ++t) {
    const int64_t bc = t / nh;
    const int h = static_cast<int>(t - bc * nh);
    if (bc != cur_bc) {
      if (cur_bc >= 0) segment_end(cur_bc);
      cur_bc = bc;
      __syncthreads();
      const float* Bg = B + bc * Ln;
      const float* Cg = C + bc * Ln;
      for (int e = tid; e < Lp * np8; e += nthreads) {     // coalesced along s
        const int l = e / np8, s = e - l * np8;
        const bool in = l < L && s < n;
        bt[s * Lp + l] = in ? __ldg(Bg + static_cast<int64_t>(l) * n + s) : 0.f;
        ct[s * Lp + l] = in ? __ldg(Cg + static_cast<int64_t>(l) * n + s) : 0.f;
      }
      for (int e = tid; e < Lp * Lp; e += nthreads) dcb[e] = 0.f;
      for (int e = tid; e < np8 * Lp; e += nthreads) wtb[e] = 0.f;
      if (lay.cache_cb) {     // cb[i][j] = C_i . B_j in 4x4 register tiles
        __syncthreads();
        for (int u = tid; u < nLq * nLq; u += nthreads) {
          const int ib = u / nLq, jb = u - ib * nLq;
          float acc[4][4] = {};
          for (int s = 0; s < n; ++s) {
            float cv[4], bv[4];
            load4(ct + s * Lp + 4 * ib, cv);
            load4(bt + s * Lp + 4 * jb, bv);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
            *reinterpret_cast<float4*>(cb + (4 * ib + r) * Lp + 4 * jb) =
                make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        }
      }
    }

    // the head's x, dy (rows l at stride h p) and dS (rows s) transposed,
    // zero-padded; dt
    __syncthreads();
    {
      const int64_t row0 = bc * L;
      for (int e = tid; e < Lp * pp; e += nthreads) {
        const int l = e / pp, k = e - l * pp;
        const bool in = l < L && k < p;
        const int64_t g = ((row0 + l) * nh + h) * p + k;
        xt[k * ldl + l] = in ? __ldg(x + g) : 0.f;
        dyt[k * ldl + l] = in ? __ldg(dy + g) : 0.f;
      }
      const float* dSg = dS + (bc * nh + h) * static_cast<int64_t>(n) * p;
      for (int e = tid; e < np8 * pp; e += nthreads) {
        const int s = e / pp, k = e - s * pp;
        dst[k * lds + s] = s < n && k < p ? __ldg(dSg + static_cast<int64_t>(s) * p + k) : 0.f;
      }
      for (int l = tid; l < Lp; l += nthreads)
        dts[l] = l < L ? __ldg(dt + (row0 + l) * nh + h) : 0.f;
    }
    __syncthreads();

    // cum in fp64 by a shuffle scan (warp 0: each lane sums a run of
    // ceil(L/32) steps, the lanes' totals are scanned, each run is offset),
    // then e
    const float a = __ldg(A + h);
    if (warp == 0) {
      const int per = (L + 31) / 32;
      const int l0 = min(lane * per, L), l1 = min(l0 + per, L);
      double run = 0.0;
      for (int l = l0; l < l1; ++l) {
        run += static_cast<double>(dts[l]) * a;
        cum[l] = run;
      }
      double incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      const double excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane > 0)
        for (int l = l0; l < l1; ++l) cum[l] += excl;
      __syncwarp();
      const double cend = cum[L - 1];
      for (int l = lane; l < Lp; l += 32) {
        if (l >= L) cum[l] = 0.0;
        ev[l] = l < L ? expf(static_cast<float>(cend - cum[l])) : 0.f;
      }
    }
    __syncthreads();

    // P on the lower triangle, 0 above it and in the padding
    for (int e = tid; e < Lp * Lp; e += nthreads) {
      const int i = e / Lp, j = e - i * Lp;
      float v = 0.f;
      if (j <= i && i < L) {
        float cbij;
        if (lay.cache_cb) {
          cbij = cb[e];
        } else {
          cbij = 0.f;
          for (int s = 0; s < n; ++s) cbij = fmaf(ct[s * Lp + i], bt[s * Lp + j], cbij);
        }
        v = cbij * expf(static_cast<float>(cum[i] - cum[j]));
      }
      pm[e] = v;
    }
    __syncthreads();

    // the products: dx units (8 rows l by 4 columns of p), dW units (8 rows
    // s by 4 l), dM' units (8 rows i by 4 j, those that reach the lower
    // triangle)
    {
      const int nDx = nLb * nJ, nW = nSb * nLq, nK = nLb * nLq;
      const int64_t row0 = bc * L;
      for (int u = tid; u < nDx + nW + nK; u += nthreads) {
        float acc[8][4];
        zero(acc);
        if (u < nDx) {
          const int lb = u % nLb, J = u / nLb, l0 = 8 * lb, k0 = 4 * J;
          tile8x4(bt + l0, Lp, dst + k0 * lds, 0, lds, 0, n, acc);          // B dS
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] *= ev[l0 + r];
          tile8x4(pm + l0, Lp, dyt + k0 * ldl, 0, ldl, l0, L, acc);         // P^T dy
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const int l = l0 + r;
            if (l >= L) continue;
            const float d = dts[l];
            float* out = dx + ((row0 + l) * nh + h) * p + k0;
            if (xvec) {
              *reinterpret_cast<float4*>(out) = make_float4(acc[r][0] * d, acc[r][1] * d,
                                                            acc[r][2] * d, acc[r][3] * d);
            } else {
#pragma unroll
              for (int c = 0; c < 4; ++c)
                if (k0 + c < p) out[c] = acc[r][c] * d;
            }
          }
        } else if (u < nDx + nW) {
          const int v = u - nDx, sb = v / nLq, s0 = 8 * sb, l0 = 4 * (v - sb * nLq);
          tile8x4(dst + s0, lds, xt + l0, ldl, 0, 0, p, acc);               // dW^T
          float qs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int s = s0 + r, l = l0 + c;
              wtb[s * Lp + l] += acc[r][c] * (ev[l] * dts[l]);
              qs[c] = fmaf(acc[r][c], bt[s * Lp + l], qs[c]);
            }
#pragma unroll
          for (int c = 0; c < 4; ++c) qp[sb * Lp + l0 + c] = qs[c];
        } else {
          const int v = u - nDx - nW, ib = v / nLq, jb = v - ib * nLq;
          if (jb / 2 > ib) continue;                     // above the diagonal
          const int i0 = 8 * ib, j0 = 4 * jb;
          tile8x4(dyt + i0, ldl, xt + j0, ldl, 0, 0, p, acc);               // dM'
          float rows[8], cols[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            rows[r] = 0.f;
            const int i = i0 + r;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int j = j0 + c;
              if (j <= i && i < L) {
                const float dm = acc[r][c], dtj = dts[j];
                dcb[i * Lp + j] += dm * expf(static_cast<float>(cum[i] - cum[j])) * dtj;
                const float kp = dm * pm[i * Lp + j];
                if (j < i) {
                  rows[r] = fmaf(kp, dtj, rows[r]);
                  cols[c] += kp;
                } else {
                  dk[i] = kp;
                }
              }
            }
          }
#pragma unroll
          for (int r = 0; r < 8; ++r) rowp[jb * Lp + i0 + r] = rows[r];
#pragma unroll
          for (int c = 0; c < 4; ++c) colp[ib * Lp + j0 + c] = cols[c];
        }
      }
    }
    __syncthreads();

    // per l: the partials summed in a fixed order
    for (int l = tid; l < L; l += nthreads) {
      const int ib = l / 8, jb = l / 4;
      float rowg = 0.f, colk = 0.f, q = 0.f;
      for (int b2 = 0; b2 <= min(2 * ib + 1, nLq - 1); ++b2) rowg += rowp[b2 * Lp + l];
      for (int b2 = jb / 2; b2 < nLb; ++b2) colk += colp[b2 * Lp + l];
      for (int b2 = 0; b2 < nSb; ++b2) q += qp[b2 * Lp + l];
      const float d = dts[l], e = ev[l];
      const float hl = l < L - 1 ? e * d * q : 0.f;        // e_{L-1} = 1 cancels
      dcum[l] = rowg - d * colk - hl;
      ddt0[l] = colk + dk[l] + e * q;
      hv[l] = hl;
    }
    __syncthreads();

    // warp 0: cum_end's terms, the reverse scan, ddt and the head's share of dA
    if (warp == 0) {
      float hs = 0.f;
      for (int l = lane; l < L; l += 32) hs += hv[l];
      hs = warp_sum(hs);
      if (lane == 0) {
        const int64_t gi = bc * nh + h;
        dcum[L - 1] += hs + __ldg(dg + gi) * expf(static_cast<float>(cum[L - 1]));
      }
      __syncwarp();
      const int per = (L + 31) / 32;
      const int l0 = min(lane * per, L), l1 = min(l0 + per, L);
      float run = 0.f;
      for (int l = l1 - 1; l >= l0; --l) {
        run += dcum[l];
        dcum[l] = run;
      }
      float incl = run;                     // the suffix sum over lanes >= lane
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += v;
      }
      float excl = __shfl_down_sync(0xffffffffu, incl, 1);
      if (lane == 31) excl = 0.f;
      float da = 0.f;
      for (int l = l0; l < l1; ++l) {
        const float dda = dcum[l] + excl;
        ddt[(bc * L + l) * nh + h] = fmaf(a, dda, ddt0[l]);
        da = fmaf(dts[l], dda, da);
      }
      da = warp_sum(da);
      if (lane == 0) dapart[bc * nh + h] = da;
    }
  }
  segment_end(cur_bc);
}

// The CTA containing flat item t (CTA c holds [items c / ctas, items (c+1)
// / ctas), none empty as ctas <= items)
__device__ __forceinline__ int64_t cta_of(int64_t t, int64_t items, int ctas) {
  return ((t + 1) * ctas - 1) / items;
}

// dC, dB of each (batch, chunk): its segments summed in CTA order, a block
// per 256 of its 2 L n values; the last block sums each head's dA over the
// (batch, chunk) pairs in order
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_kernel(const float* __restrict__ part, const float* __restrict__ dapart,
                      float* __restrict__ dB, float* __restrict__ dC, float* __restrict__ dA,
                      int64_t items, int ctas, int64_t nbc, int nh, int64_t Ln, int pieces) {
  const int64_t blk = blockIdx.x;
  if (blk == nbc * pieces) {
    for (int h = threadIdx.x; h < nh; h += blockDim.x) {
      float s = 0.f;
      for (int64_t bc = 0; bc < nbc; ++bc) s += dapart[bc * nh + h];
      dA[h] = s;
    }
    return;
  }
  const int64_t bc = blk / pieces;
  const int64_t e = (blk - bc * pieces) * blockDim.x + threadIdx.x;
  if (e >= 2 * Ln) return;
  const int64_t c_lo = cta_of(bc * nh, items, ctas), c_hi = cta_of(bc * nh + nh - 1, items, ctas);
  float s = 0.f;
  for (int64_t c = c_lo; c <= c_hi; ++c) s += part[(c + bc) * 2 * Ln + e];
  if (e < Ln) {
    dC[bc * Ln + e] = s;
  } else {
    dB[bc * Ln + e - Ln] = s;
  }
}

struct Occupancy {
  int device = -1, ctas_per_sm = 0, sms = 0;
  size_t smem = 0;
};

// The CTAs a call of this layout gets on the current device (SMs times the
// CTAs per SM its shared memory and threads allow), at most `items`.
cudaError_t grid_of(const Layout& lay, int64_t items, int* ctas) {
  static Occupancy occ;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(lay.floats) * 4;
  if (occ.device != dev) {
    err = cudaFuncSetAttribute(ssd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxSmem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_bwd_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&occ.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    occ.device = dev;
    occ.smem = 0;
  }
  if (occ.smem != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ.ctas_per_sm, ssd_bwd_kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    if (occ.ctas_per_sm < 1) return cudaErrorInvalidConfiguration;
    occ.smem = smem;
  }
  const int64_t slots = static_cast<int64_t>(occ.sms) * occ.ctas_per_sm;
  *ctas = static_cast<int>(items < slots ? items : slots);
  return cudaSuccess;
}

}  // namespace

// The launch an SSD backward call of this shape takes on the current device:
// C B^T cached (1) or recomputed per element (0), threads per CTA, CTAs,
// dynamic shared memory in bytes, and the floats of the partials buffer the
// caller allocates ((CTAs + batch x chunks) segments of 2 L n).  No launch;
// an error where no layout fits.
extern "C" int ssd_chunk_bwd_plan(int b, int nc, int L, int nh, int p, int n, int* cache_cb,
                                  int* threads, int* ctas, int64_t* smem_bytes,
                                  int64_t* part_floats) {
  Layout lay;
  if (b <= 0 || nc <= 0 || nh <= 0 || L <= 0 || p <= 0 || n <= 0 ||
      !choose_layout(L, p, n, &lay))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t items = static_cast<int64_t>(b) * nc * nh;
  const cudaError_t err = grid_of(lay, items, ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  *cache_cb = lay.cache_cb;
  *threads = kThreads;
  *smem_bytes = static_cast<int64_t>(lay.floats) * 4;
  *part_floats = (*ctas + static_cast<int64_t>(b) * nc) * 2 * L * n;
  return 0;
}

// dx, ddt, dA, dB, dC of the SSD block (all fp32, the inputs' shapes) from
// x, dt, A, B, C and the output gradients dy, dS (b, nc, h, n, p), dg (b, nc,
// h); `part` (part_floats, at least what ssd_chunk_bwd_plan gives) and
// `dapart` (b nc h floats) are scratch.  Two launches on `stream`.
extern "C" int ssd_chunk_bwd_f32(const void* x, const void* dt, const void* A, const void* B,
                                 const void* C, const void* dy, const void* dS, const void* dg,
                                 void* dx, void* ddt, void* dA, void* dB, void* dC, void* part,
                                 void* dapart, int64_t part_floats, int b, int nc, int L, int nh,
                                 int p, int n, void* stream) {
  Layout lay;
  if (b <= 0 || nc <= 0 || nh <= 0 || L <= 0 || p <= 0 || n <= 0 ||
      !choose_layout(L, p, n, &lay))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t items = static_cast<int64_t>(b) * nc * nh;
  const int64_t nbc = static_cast<int64_t>(b) * nc;
  int ctas = 0;
  cudaError_t err = grid_of(lay, items, &ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t Ln = static_cast<int64_t>(L) * n;
  if (part_floats < (ctas + nbc) * 2 * Ln) return static_cast<int>(cudaErrorInvalidValue);
  const int xvec = p % 4 == 0 && reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ssd_bwd_kernel<<<ctas, kThreads, static_cast<size_t>(lay.floats) * 4, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(dy),
      static_cast<const float*>(dS), static_cast<const float*>(dg), static_cast<float*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(part), static_cast<float*>(dapart), items,
      L, nh, p, n, xvec, lay);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pieces = static_cast<int>((2 * Ln + kThreads - 1) / kThreads);
  ssd_bwd_reduce_kernel<<<static_cast<unsigned>(nbc * pieces + 1), kThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<const float*>(dapart),
      static_cast<float*>(dB), static_cast<float*>(dC), static_cast<float*>(dA), items, ctas,
      nbc, nh, Ln, pieces);
  return static_cast<int>(cudaGetLastError());
}
