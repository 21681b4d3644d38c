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
// mamba2-370m's (n = 128).  TF32 stays off, so the products run on the
// tensor cores in split fp32: each operand is a TF32 big part and the TF32
// rounding of its remainder, and a product is big.big + big.small +
// small.big (mma.sync m16n8k8, fp32 accumulators), fp32's accuracy at
// three TF32 products for each fp32 one (495 / 3 = 165 TFLOP/s of fp32
// work against the CUDA cores' 67).
//
// Design: a persistent grid (as many CTAs as fit, each walking a
// contiguous range of the flat (batch, chunk, head) items, heads
// innermost), 256 threads, 8 warps:
//   * Loads: the tiles land in shared memory as they lie in memory, with no
//     transposing stores.  x, dy ([L][p] at row stride h p) and dS ([n][p])
//     come by TMA, one box of 8, 16 or 32 columns at a time (thread 0
//     issues six boxes a head at p = 64), in TMA's 32-, 64- or 128-byte
//     swizzle; completion on the stage's mbarrier, which every thread
//     waits on (dt, L floats at stride h, by cp.async arriving on the same
//     mbarrier).  Where TMA cannot take the tensors (p not a multiple of 4,
//     a pointer not 16-byte aligned) every thread copies its elements into
//     the same places by cp.async.  Two stages where they fit: the next
//     head's inputs are in flight while this head computes (they may
//     belong to the next (batch, chunk)); one stage, loaded after the
//     head before it, where they do not.  B and C ([L][n], once per (batch,
//     chunk)) come by cp.async with an XOR swizzle of each row's 16-byte
//     chunks.  The swizzles make the mma fragment reads conflict-free as
//     row-major operands; as transposed ones (dy and dS in dx) they are
//     two-way at boxes of 16 and 32 columns.
//   * Fixed tile ownership: each warp owns whole m16n8 tiles.  The lower
//     triangle's tiles of dM' are dealt round-robin and the warp keeps, in
//     registers across the heads of a (batch, chunk), their C B^T (computed
//     once per (batch, chunk) it meets) and their dCB sums; the dW^T (n x
//     L) tiles continue the deal, in super-tiles of 2 x 4 that share their
//     fragments where a warp keeps 8, and their sums e dt dW (the dB term)
//     stay in registers too (in shared memory for shapes past the register
//     variants).  The dx jobs (16 rows by 4 tiles of 8 columns, whose
//     triangle depth varies) are dealt on the host, longest first to the
//     least loaded warp, so the warps' mma steps a head differ by at most
//     one job.  Each step splits a fragment once for every tile that reads
//     it and issues the three products of all its tiles in turn, so the
//     independent accumulators' mma chains overlap.
//   * Per head: every warp scans cum (fp64) itself into its own copy (no
//     idle warps, no barrier; e is read from it where needed); each warp
//     forms P on its own dM' tiles, keeps the decay exp(cum_i - cum_j) in
//     registers (computed once per element) and stores P for the dx
//     product; barrier; the products and their epilogues, each
//     accumulator consumed in registers:
//       - dx = e (B dS) + P^T dy, scaled by dt, stored;
//       - dM' adds dM' decay dt into its dCB registers, its G and P terms
//         into the warp's row and column partials (the diagonal apart);
//       - dW^T adds e dt dW^T into the dB-term registers and dW B into the
//         warp's q partials;
//     barrier; the per-l sums over the warps' partials (4 lanes an l at L =
//     64, all 256 threads), each warp's suffix sum of dcum and its share of
//     sum H; barrier; ddt and each warp's dt d(dA) share.  Three block-wide
//     barriers a head with two stages.
//   * When the CTA leaves a (batch, chunk): its dCB and dB-term registers go
//     to shared memory (the finished head's stage), and dC = dCB B and dB =
//     dCB^T C + term (split-fp32 mma) go to its segment of a partials buffer
//     (CTA c's segment of (batch, chunk) bc is c + bc, so segments never
//     overlap).  A second kernel of the same entry sums each (batch,
//     chunk)'s segments in CTA order, and each head's dA over the (batch,
//     chunk, warp) shares in a fixed tree: no float atomics, two runs agree
//     bit for bit.
// Any L up to 144, p, n: L, p and n rounded up to 8 (n to 16 for dS's
// rows; a 16-row block of the triangle may hang 8 rows past L's rounding,
// its extra rows read and dropped); ops.ssd_chunk_bwd_smem_bytes counts the
// least layout (one stage), the wrapper's admission check.  The phase
// markers (`// phase:`) are where examples/ssd_bwd_phases.py puts its
// clock stamps.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "mbarrier.cuh"

namespace {

constexpr size_t kMaxSmem = 232448;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNT = 4;                    // column tiles a dx or dC/dB job holds beside each other
constexpr int kMaxDx = 640;               // dx jobs the host's deal holds

int round8(int v) { return (v + 7) & ~7; }
int round16(int v) { return (v + 15) & ~15; }

// One CTA's shared memory, in floats (every offset a multiple of 8):
//   stage [stages]    per head, 1 KB aligned (256 floats of slack first): x, dy
//                     [Lp][p8] and dS [n16][p8] as TMA lands them (boxes of BW =
//                     8, 16 or 32 columns, 16-byte chunks XOR-swizzled by row),
//                     dt [Lp]; at a segment's end: dCB [Lp][Lp] (swizzled), the
//                     dB term [n16][Lp] (register variants)
//   b, c  [Lp][n8]    B and C of the (batch, chunk), swizzled
//   p     [Lp][Lp]    P of the head, swizzled (the dM' tiles' region)
//   cw    [8][Lp]     doubles: each warp's cum
//   rowp, colp, qp [8][Lp]  each warp's partials;  dk [Lp];  tot [16]
//   bar   [2]         the stages' mbarriers (8 bytes each)
//   wtb   [n16][Lp]   the dB term (shared-memory variants only)
struct Layout {
  int Lp, p8, n8, n16, lbw, stages, wtb_smem, lpl;
  int o_b, o_c, o_p, o_stage, stage_floats, s_dy, s_ds, s_dt;
  int o_cw, o_rowp, o_colp, o_qp, o_dk, o_tot, o_bar, o_wtb, floats;
};

Layout make_layout(int L, int p, int n, int stages, int wtb_smem) {
  Layout y{};
  y.Lp = round8(L);
  y.p8 = round8(p);
  y.n8 = round8(n);
  y.n16 = round16(n);
  y.stages = stages;
  y.wtb_smem = wtb_smem;
  y.lpl = 1;
  while (y.lpl < 32 && 2 * y.lpl * y.Lp <= kThreads) y.lpl *= 2;
  y.lbw = y.p8 % 32 == 0 ? 5 : (y.p8 % 16 == 0 ? 4 : 3);
  const int Lp = y.Lp;
  y.s_dy = Lp * y.p8;
  y.s_ds = 2 * Lp * y.p8;
  y.s_dt = y.s_ds + y.n16 * y.p8;
  const int head = y.s_dt + Lp;
  const int seg = Lp * Lp + (wtb_smem ? 0 : y.n16 * Lp);
  y.stage_floats = ((head > seg ? head : seg) + 255) & ~255;
  int off = 0;
  y.o_stage = off;
  off += 256 + stages * y.stage_floats;
  y.o_b = off;
  off += Lp * y.n8;
  y.o_c = off;
  off += Lp * y.n8;
  y.o_p = off;
  off += Lp * Lp;
  y.o_cw = off;
  off += kWarps * 2 * Lp;
  y.o_rowp = off;
  off += kWarps * Lp;
  y.o_colp = off;
  off += kWarps * Lp;
  y.o_qp = off;
  off += kWarps * Lp;
  y.o_dk = off;
  off += Lp;
  y.o_tot = off;
  off += 2 * kWarps;
  y.o_bar = off;
  off += 8;
  y.o_wtb = off;
  if (wtb_smem) off += y.n16 * Lp;
  y.floats = off;
  return y;
}

// The dx jobs each warp computes a head: 16 rows l by up to kNT tiles of
// 8 columns of p, as (row block << 10) | column group, warp w's at
// [start[w], start[w+1]).
struct Deal {
  uint16_t dx[kMaxDx];
  uint16_t start[kWarps + 1];
};

// Kernel variants by the tiles a warp keeps in registers: MT dM' tiles
// (C B^T, dCB, decay), MW dW^T tiles (the dB term; 0: in shared memory).
enum Variant { kV3x1 = 0, kV3x8, kV3x16, kV12x0, kVariants };
constexpr int kVariantMT[kVariants] = {3, 3, 3, 12};
constexpr int kVariantMW[kVariants] = {1, 8, 16, 0};

// The dM' tiles of the lower triangle over Lp rows (a multiple of 8): row
// blocks of 16 (the last may hang 8 rows past Lp), 2 ib + 2 column blocks
// of 8 in block ib, the last one dropped where it would start at Lp.
__host__ __device__ inline int tri_tiles(int Lp) {
  const int nb = (Lp + 15) / 16;
  return nb * (nb + 1) - (Lp % 16 ? 1 : 0);
}
// The dW^T tiles (16 rows s by 8 columns l) grouped as a warp of variant
// MW keeps them: super-tiles of 2 x 4 tiles where MW == 8, else single
// tiles; the super-tiles of the grid, and the tiles of warp w's (dealt
// round-robin after the T dM' tiles).
struct WtGrid {
  int sr, sc, nRb, nWl, nSC, nST;
  WtGrid(int Lp, int n16, int mw)
      : sr(mw == 8 ? 2 : 1), sc(mw == 8 ? 4 : 1), nRb(n16 / 16), nWl(Lp / 8),
        nSC((nWl + sc - 1) / sc), nST((nRb + sr - 1) / sr * nSC) {}
  int tiles_of(int w, int T) const {
    int count = 0;
    for (int zeta = (w - T % kWarps + kWarps) % kWarps; zeta < nST; zeta += kWarps) {
      const int r = zeta / nSC, c = zeta - r * nSC;
      count += (nRb - sr * r < sr ? nRb - sr * r : sr) * (nWl - sc * c < sc ? nWl - sc * c : sc);
    }
    return count;
  }
};

// The variant a shape takes (the first whose registers hold a warp's
// share of the tiles), -1 if none holds its triangle.
int variant_of(int L, int n) {
  const int Lp = round8(L);
  const int mt = (tri_tiles(Lp) + kWarps - 1) / kWarps;
  for (int v = 0; v < kVariants; ++v) {
    const int mw = kVariantMW[v];
    const WtGrid grid(Lp, round16(n), mw);
    const int per = mw == 8 ? 8 : 1;            // tiles a super-tile holds
    if (mt <= kVariantMT[v] && (mw == 0 || grid.nST <= kWarps * (mw / per))) return v;
  }
  return -1;
}

// Two stages where they fit, else one; false if neither fits.
bool choose_layout(int L, int p, int n, Layout* out, int* variant) {
  const int v = variant_of(L, n);
  if (v < 0) return false;
  for (int stages = 2; stages >= 1; --stages) {
    const Layout y = make_layout(L, p, n, stages, kVariantMW[v] == 0);
    if (static_cast<size_t>(y.floats) * 4 <= kMaxSmem) {
      *out = y;
      *variant = v;
      return true;
    }
  }
  return false;
}

// The dx jobs dealt longest first (B dS over n, then P^T dy from the
// job's rows down, for each of its column tiles) to the warp with the
// fewest mma steps, after the dM' and dW^T tiles each warp owns (p / 8
// steps each).  False past kMaxDx.
bool make_deal(const Layout& y, int mw, Deal* d) {
  const int nLb = (y.Lp + 15) / 16, nKb = y.p8 / 8, nG = (nKb + kNT - 1) / kNT;
  const int jobs = nLb * nG;
  if (jobs > kMaxDx) return false;
  const int T = tri_tiles(y.Lp);
  const WtGrid grid(y.Lp, y.n16, mw);
  int load[kWarps], count[kWarps] = {};
  for (int w = 0; w < kWarps; ++w)
    load[w] = ((T + kWarps - 1 - w) / kWarps + grid.tiles_of(w, T)) * nKb;
  int owner[kMaxDx];
  int order[kMaxDx], cost[kMaxDx];
  for (int j = 0; j < jobs; ++j) {
    const int lb = j / nG, gr = j - lb * nG;
    const int tiles = nKb - kNT * gr < kNT ? nKb - kNT * gr : kNT;
    cost[j] = tiles * (y.n8 / 8 + (y.Lp - 16 * lb) / 8);
    order[j] = j;
  }
  for (int i = 1; i < jobs; ++i)               // longest first, ties in job order
    for (int k = i; k > 0 && cost[order[k]] > cost[order[k - 1]]; --k) {
      const int tmp = order[k];
      order[k] = order[k - 1];
      order[k - 1] = tmp;
    }
  for (int i = 0; i < jobs; ++i) {
    int best = 0;
    for (int w = 1; w < kWarps; ++w)
      if (load[w] < load[best]) best = w;
    load[best] += cost[order[i]];
    owner[order[i]] = best;
    ++count[best];
  }
  d->start[0] = 0;
  for (int w = 0; w < kWarps; ++w) d->start[w + 1] = static_cast<uint16_t>(d->start[w] + count[w]);
  int fill[kWarps];
  for (int w = 0; w < kWarps; ++w) fill[w] = d->start[w];
  for (int j = 0; j < jobs; ++j) {
    const int lb = j / nG, gr = j - lb * nG;
    d->dx[fill[owner[j]]++] = static_cast<uint16_t>((lb << 10) | gr);
  }
  return true;
}

// ---------------------------------------------------------------- device

// The XOR swizzle of a row's 4-float groups by the row's low three bits,
// chosen by the row width W (a multiple of 8) mod 32, so that the mma
// fragment reads (8 rows by 4 columns, and 4 rows by 8 columns) hit 32
// distinct banks (B, C, P and dCB).
__device__ __forceinline__ int swz_h(int r, int W) {
  const int m = W & 31;
  return (r & 4) | (m == 0 ? (r & 3) << 3 : (m == 16 ? (r & 2) << 2 : 0));
}

__device__ __forceinline__ int swz(int r, int c, int W) { return r * W + (c ^ swz_h(r, W)); }

__device__ __forceinline__ void cp16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(repro_ptx::smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(repro_ptx::smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// `bytes` more of asynchronous completion in `bar`'s current phase (no
// arrival)
__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               :: "r"(repro_ptx::smem_u32(bar)), "r"(bytes) : "memory");
}

// One 3-D TMA box into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(repro_ptx::smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(repro_ptx::smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// An arrival on `bar` once this thread's earlier cp.async copies have landed
// (counted in the barrier's expected arrivals)
__device__ __forceinline__ void cp_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(repro_ptx::smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows x cols floats (row r at src + r * stride) into a swizzled tile of
// width W, zero-filled past `rows_in` rows and `cols_in` columns; 16-byte
// pieces where `vec` (cols_in and stride multiples of 4, src aligned).  A
// thread's column is fixed where the threads cover whole rows.
__device__ __forceinline__ void load_tile(float* dst, int W, const float* src, int64_t stride,
                                          int rows, int rows_in, int cols, int cols_in,
                                          bool vec, int tid) {
  const int pieces = vec ? cols / 4 : cols;
  if (kThreads % pieces == 0) {
    const int c = (vec ? 4 : 1) * (tid % pieces);
    for (int r = tid / pieces; r < rows; r += kThreads / pieces) {
      const bool in = r < rows_in && c < cols_in;
      const float* from = in ? src + r * stride + c : src;
      if (vec) {
        cp16(dst + swz(r, c, W), from, in);
      } else {
        cp4(dst + swz(r, c, W), from, in);
      }
    }
  } else if (vec) {
    const int pieces = cols / 4;
    for (int e = tid; e < rows * pieces; e += kThreads) {
      const int r = e / pieces, c = 4 * (e - r * pieces);
      const bool in = r < rows_in && c < cols_in;
      cp16(dst + swz(r, c, W), in ? src + r * stride + c : src, in);
    }
  } else {
    for (int e = tid; e < rows * cols; e += kThreads) {
      const int r = e / cols, c = e - r * cols;
      const bool in = r < rows_in && c < cols_in;
      cp4(dst + swz(r, c, W), in ? src + r * stride + c : src, in);
    }
  }
}

// v as TF32 big + small parts: big is v rounded to TF32 to nearest, ties
// away from zero (cvt.rna.tf32.f32's rounding of a finite v, as an integer
// add and mask: two instructions where cvt's NaN handling takes four);
// small is the exact remainder rounded the same way (its low 13 bits, which
// the tensor core does not read, left in place)
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big)) + 0x1000u;
}

// volatile: the products keep their source order, which interleaves the
// independent accumulators (an mma waits ~24 cycles for the one before it
// on the same accumulator, and a warp issues in order)
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in split fp32: small.big, big.small, then big.big
__device__ __forceinline__ void mma3(float d[4], const float a[4], const float b[2]) {
  uint32_t ab[4], as[4], bb[2], bs[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ab[i], as[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) split_tf32(b[i], bb[i], bs[i]);
  mma_tf32(d, as, bb);
  mma_tf32(d, ab, bs);
  mma_tf32(d, ab, bb);
}

// Fragments of m16n8k8 (g = lane / 4, t = lane % 4): A's (g, t), (g + 8,
// t), (g, t + 4), (g + 8, t + 4); B's (k t, n g), (t + 4, g); the
// accumulator's (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).  Row
// offsets are multiples of 8, so a row's swizzle is that of its low bits.

// A (rows m0.., columns k0..) of a row-major tile
__device__ __forceinline__ void frag_a(const float* T, int W, int m0, int k0, int g, int t,
                                      float a[4]) {
  const int r0 = (m0 + g) * W, r1 = r0 + 8 * W, c0 = k0 ^ (t ^ swz_h(g, W)), c1 = c0 ^ 4;
  a[0] = T[r0 + c0];
  a[1] = T[r1 + c0];
  a[2] = T[r0 + c1];
  a[3] = T[r1 + c1];
}

// A (rows m0.., columns k0..) of the transpose of a tile: A(m, k) = T(k, m)
__device__ __forceinline__ void frag_at(const float* T, int W, int m0, int k0, int g, int t,
                                       float a[4]) {
  const int h0 = swz_h(t, W), h1 = swz_h(t + 4, W);
  const int r0 = (k0 + t) * W, r1 = r0 + 4 * W;
  a[0] = T[r0 + ((m0 + g) ^ h0)];
  a[1] = T[r0 + ((m0 + g + 8) ^ h0)];
  a[2] = T[r1 + ((m0 + g) ^ h1)];
  a[3] = T[r1 + ((m0 + g + 8) ^ h1)];
}

// B (k0.., n0..) of a tile stored [k][n]
__device__ __forceinline__ void frag_b_kn(const float* T, int W, int k0, int n0, int g, int t,
                                          float b[2]) {
  const int r0 = (k0 + t) * W;
  b[0] = T[r0 + ((n0 + g) ^ swz_h(t, W))];
  b[1] = T[r0 + 4 * W + ((n0 + g) ^ swz_h(t + 4, W))];
}

// B (k0.., n0..) of a tile stored [n][k]
__device__ __forceinline__ void frag_b_nk(const float* T, int W, int k0, int n0, int g, int t,
                                          float b[2]) {
  const int r = (n0 + g) * W, c = k0 ^ (t ^ swz_h(g, W));
  b[0] = T[r + c];
  b[1] = T[r + (c ^ 4)];
}

// The head tiles as TMA lands them: boxes of BW = 2^lbw columns (8, 16 or
// 32), each R rows of BW floats, with the 16-byte chunks of a row XORed by
// the row (TMA's 32-, 64- or 128-byte swizzle: row bits 2, 1-2 or 0-2).  A
// fragment's 8 rows start at a multiple of 8, so their swizzle is that of
// the lane's g (or t); 8 rows by 4 columns are conflict-free, 4 rows by 8
// columns conflict-free at BW = 8 and two-way at 16 and 32.
__device__ __forceinline__ int box_swz(int r, int lbw) {
  return lbw == 5 ? (r & 7) : (lbw == 4 ? (r >> 1) & 3 : (r >> 2) & 1);
}

// element (r, c) of a box tile of R rows
__device__ __forceinline__ int box_off(int r, int c, int R, int lbw) {
  const int cc = c & ((1 << lbw) - 1);
  return (((c >> lbw) * R + r) << lbw) + ((((cc >> 2) ^ box_swz(r, lbw)) << 2) | (cc & 3));
}

// A (rows m0.., columns k0..) of a box tile
__device__ __forceinline__ void bfrag_a(const float* T, int R, int lbw, int m0, int k0, int g,
                                       int t, float a[4]) {
  const int sw = box_swz(g, lbw), ch = (k0 >> 2) & ((1 << (lbw - 2)) - 1);
  const float* r0 = T + ((((k0 >> lbw) * R) + m0 + g) << lbw) + t;
  const int c0 = (ch ^ sw) << 2, c1 = ((ch + 1) ^ sw) << 2, down = 8 << lbw;
  a[0] = r0[c0];
  a[1] = r0[down + c0];
  a[2] = r0[c1];
  a[3] = r0[down + c1];
}

// B (k0.., n0..) of a box tile stored [k][n]
__device__ __forceinline__ void bfrag_b_kn(const float* T, int R, int lbw, int k0, int n0, int g,
                                          int t, float b[2]) {
  const int ch = ((n0 >> 2) & ((1 << (lbw - 2)) - 1)) + (g >> 2);
  const float* base = T + (((n0 >> lbw) * R + k0 + t) << lbw) + (g & 3);
  b[0] = base[(ch ^ box_swz(t, lbw)) << 2];
  b[1] = base[(4 << lbw) + ((ch ^ box_swz(t + 4, lbw)) << 2)];
}

// B (k0.., n0..) of a box tile stored [n][k]
__device__ __forceinline__ void bfrag_b_nk(const float* T, int R, int lbw, int k0, int n0, int g,
                                          int t, float b[2]) {
  const int sw = box_swz(g, lbw), ch = (k0 >> 2) & ((1 << (lbw - 2)) - 1);
  const float* r0 = T + ((((k0 >> lbw) * R) + n0 + g) << lbw) + t;
  b[0] = r0[(ch ^ sw) << 2];
  b[1] = r0[((ch + 1) ^ sw) << 2];
}

__device__ __forceinline__ void zero4(float a[4]) { a[0] = a[1] = a[2] = a[3] = 0.f; }

// d[u] += A_u B_u in split fp32 for N independent tiles, the three
// products of all tiles in turn
template <int N>
__device__ __forceinline__ void mma3_n(float d[N][4], const float a[N][4], const float b[N][2]) {
  uint32_t ab[N][4], as[N][4], bb[N][2], bs[N][2];
#pragma unroll
  for (int u = 0; u < N; ++u) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[u][i], ab[u][i], as[u][i]);
#pragma unroll
    for (int i = 0; i < 2; ++i) split_tf32(b[u][i], bb[u][i], bs[u][i]);
  }
#pragma unroll
  for (int u = 0; u < N; ++u) mma_tf32(d[u], as[u], bb[u]);
#pragma unroll
  for (int u = 0; u < N; ++u) mma_tf32(d[u], ab[u], bs[u]);
#pragma unroll
  for (int u = 0; u < N; ++u) mma_tf32(d[u], ab[u], bb[u]);
}

// acc[c] += A B_c in split fp32 over k0 in [k_lo, k_hi) for the NT
// column tiles c of one 16-row block: A's fragments (fa(k0, a)) are read
// and split once a step for all of them, B_c's by fb(k0, c, b).  No branch
// between the tiles, so their independent chains of mma overlap (a job
// with fewer tiles points fb at a real one and drops the extra results).
template <int NT, class FA, class FB>
__device__ __forceinline__ void mma_row(float acc[NT][4], int k_lo, int k_hi, FA fa, FB fb) {
  if (k_lo >= k_hi) return;
  float a[4], b[NT][2];                    // this step's fragments, the next step's read ahead
  fa(k_lo, a);
#pragma unroll
  for (int c = 0; c < NT; ++c) fb(k_lo, c, b[c]);
  for (int k0 = k_lo; k0 < k_hi; k0 += 8) {
    const int kn = k0 + 8 < k_hi ? k0 + 8 : k0;
    float an[4], bn[NT][2];
    fa(kn, an);
#pragma unroll
    for (int c = 0; c < NT; ++c) fb(kn, c, bn[c]);
    uint32_t ab[4], as[4], bb[NT][2], bs[NT][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], ab[i], as[i]);
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      split_tf32(b[c][0], bb[c][0], bs[c][0]);
      split_tf32(b[c][1], bb[c][1], bs[c][1]);
    }
#pragma unroll
    for (int c = 0; c < NT; ++c) mma_tf32(acc[c], as, bb[c]);
#pragma unroll
    for (int c = 0; c < NT; ++c) mma_tf32(acc[c], ab, bs[c]);
#pragma unroll
    for (int c = 0; c < NT; ++c) mma_tf32(acc[c], ab, bb[c]);
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = an[i];
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      b[c][0] = bn[c][0];
      b[c][1] = bn[c][1];
    }
  }
}

// The dM' tile tau of the lower triangle: row block ib (16 rows), column
// block jb (8 columns), jb <= 2 ib + 1
__device__ __forceinline__ void tri_tile(int tau, int& ib, int& jb) {
  ib = 0;
  while ((ib + 1) * (ib + 2) <= tau) ++ib;
  jb = tau - ib * (ib + 1);
}

template <int MT, int MW>
__global__ void __launch_bounds__(kThreads, MW == 1 ? 2 : 1)
ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ B,
               const float* __restrict__ C, const float* __restrict__ dy,
               const float* __restrict__ dS, const float* __restrict__ dg,
               float* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ part,
               float* __restrict__ dapart, int64_t items, int nc, int L, int nh, int p, int n,
               int tma, int bvec, int dxvec, Layout lay, Deal deal,
               const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap dymap,
               const __grid_constant__ CUtensorMap dsmap) {
  constexpr int NW = MW > 0 ? MW : 1;
  // dW^T super-tiles (2 x 4 tiles where a warp keeps 8)
  constexpr int SR = MW == 8 ? 2 : 1, SC = MW == 8 ? 4 : 1, NZ = NW / (SR * SC);
  extern __shared__ __align__(16) float smem[];
  const int Lp = lay.Lp, p8 = lay.p8, n8 = lay.n8, n16 = lay.n16, lbw = lay.lbw;
  float* Bs = smem + lay.o_b;
  float* Cs = smem + lay.o_c;
  float* Ps = smem + lay.o_p;
  float* dk = smem + lay.o_dk;
  float* tot = smem + lay.o_tot;           // [0, 8) warp suffix totals, [8, 16) warp H sums
  float* wtbs = smem + lay.o_wtb;
  uint64_t* sbar = reinterpret_cast<uint64_t*>(smem + lay.o_bar);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t first = items * blockIdx.x / gridDim.x;
  const int64_t last = items * (blockIdx.x + 1) / gridDim.x;
  if (first >= last) return;
  const int64_t Ln = static_cast<int64_t>(L) * n;
  const bool two = lay.stages == 2;

  double* cw = reinterpret_cast<double*>(smem + lay.o_cw) + warp * Lp;   // this warp's cum
  // e_l = exp(cum_end - cum_l) from this warp's cum (0 past L)
  auto ev = [&](int l) { return l < L ? expf(static_cast<float>(cw[L - 1] - cw[l])) : 0.f; };
  float* rowp = smem + lay.o_rowp + warp * Lp;
  float* colp = smem + lay.o_colp + warp * Lp;
  float* qp = smem + lay.o_qp + warp * Lp;

  // the tiles this warp owns: dM' tiles warp + 8 u (row block ib, column
  // block jb); dW^T super-tiles w_first + 8 z (the deal continues dM''s),
  // each SR row blocks (16 rows s) by SC column blocks (8 columns l), whose
  // tiles share their fragments (tile v = (z SR + a) SC + b at rows wr[z][a],
  // columns wc[z][b]).  A slot past the last tile points at a real one, so
  // the products run without branches; its results are dropped.
  const int T = tri_tiles(Lp);
  const int nWl = Lp / 8, nRb = n16 / 16, Wt = nRb * nWl;
  const int nSC = (nWl + SC - 1) / SC, nST = (nRb + SR - 1) / SR * nSC;
  const int w_first = (warp - T % kWarps + kWarps) % kWarps;
  int kib[MT], kjb[MT], wr[NZ][SR], wc[NZ][SC];
#pragma unroll
  for (int u = 0; u < MT; ++u) tri_tile(min(warp + kWarps * u, T - 1), kib[u], kjb[u]);
#pragma unroll
  for (int z = 0; z < NZ; ++z) {
    const int zeta = min(w_first + kWarps * z, nST - 1), sr = zeta / nSC, sc = zeta - sr * nSC;
#pragma unroll
    for (int a = 0; a < SR; ++a) wr[z][a] = 16 * min(SR * sr + a, nRb - 1);
#pragma unroll
    for (int b = 0; b < SC; ++b) wc[z][b] = 8 * min(SC * sc + b, nWl - 1);
  }
  // whether tile v of this warp is a real one, and its rows and columns
  auto wt_tile = [&](int v, int& m0, int& n0) {
    const int z = v / (SR * SC), a = v / SC % SR, b = v % SC;
    const int zeta = w_first + kWarps * z, sr = zeta / nSC, sc = zeta - sr * nSC;
    m0 = 16 * (SR * sr + a);
    n0 = 8 * (SC * sc + b);
    return zeta < nST && SR * sr + a < nRb && SC * sc + b < nWl;
  };

  float cbr[MT][4], dcb[MT][4], dec[MT][4], wtb[NW][4];

  // the stage of `item`, its mbarrier and the parity of its load there
  auto stage_idx = [&](int64_t item) { return two ? static_cast<int>((item - first) & 1) : 0; };
  const uint32_t raw = repro_ptx::smem_u32(smem + lay.o_stage);
  float* const stages = smem + lay.o_stage + ((1024u - (raw & 1023u)) & 1023u) / 4;   // 1 KB aligned
  auto stage_of = [&](int64_t item) { return stages + stage_idx(item) * lay.stage_floats; };
  auto parity_of = [&](int64_t item) {
    return static_cast<uint32_t>(((item - first) >> (two ? 1 : 0)) & 1);
  };

  // x, dy, dS and dt of `item` into its stage, completing on its mbarrier
  // (an arrival from every thread once its copies have landed): thread 0
  // puts the tiles' boxes on TMA (`tma`: rows of 16-byte pieces; it
  // declares their bytes), else every thread copies its elements into the
  // boxes' places by cp.async; dt by cp.async.  The stage's padding (rows
  // past L and n) stays zero from the start.
  auto load_head = [&](int64_t item) {
    const int64_t bc = item / nh;
    const int h = static_cast<int>(item - bc * nh);
    float* st = stage_of(item);
    uint64_t* bar = sbar + stage_idx(item);
    if (tma) {
      if (tid == 0) {
        expect_bytes(bar, static_cast<uint32_t>(4 * p8 * (2 * L + n)));
        const int row = static_cast<int>(bc % nc) * L, bat = static_cast<int>(bc / nc);
        for (int b = 0; b < (p8 >> lbw); ++b) {
          repro_flash::tma_load_4d(st + b * (Lp << lbw), &xmap, bar, b << lbw, h, row, bat);
          repro_flash::tma_load_4d(st + lay.s_dy + b * (Lp << lbw), &dymap, bar, b << lbw, h,
                                   row, bat);
          tma_load_3d(st + lay.s_ds + b * (n16 << lbw), &dsmap, bar, b << lbw, 0,
                      static_cast<int>(item));
        }
      }
    } else {
      const int64_t off = (bc * L * nh + h) * static_cast<int64_t>(p);
      const int64_t stride = static_cast<int64_t>(nh) * p;
      const float* dSg = dS + item * static_cast<int64_t>(n) * p;
      for (int e = tid; e < (2 * L + n) * p; e += kThreads) {
        const int r = e / p, c = e - r * p;
        if (r < L) {
          cp4(st + box_off(r, c, Lp, lbw), x + off + r * stride + c, true);
        } else if (r < 2 * L) {
          cp4(st + lay.s_dy + box_off(r - L, c, Lp, lbw), dy + off + (r - L) * stride + c, true);
        } else {
          cp4(st + lay.s_ds + box_off(r - 2 * L, c, n16, lbw), dSg + (r - 2 * L) * p + c, true);
        }
      }
    }
    for (int l = tid; l < L; l += kThreads) cp4(st + lay.s_dt + l, dt + (bc * L + l) * nh + h, true);
    cp_arrive(bar);
  };

  // every stage zeroed (its padding stays so), in order before the copies
  // that will land there
  auto zero_stages = [&](float* from, int floats) {
    for (int e = tid; e < floats; e += kThreads) from[e] = 0.f;
    fence_proxy_async();
  };

  auto load_bc = [&](int64_t bc) {
    load_tile(Bs, n8, B + bc * Ln, n, Lp, L, n8, n, bvec, tid);
    load_tile(Cs, n8, C + bc * Ln, n, Lp, L, n8, n, bvec, tid);
    cp_commit();
  };

  // C B^T of this warp's dM' tiles (their chains side by side), the dCB
  // and dB-term sums zeroed
  auto start_bc = [&]() {
#pragma unroll
    for (int u = 0; u < MT; ++u) {
      zero4(cbr[u]);
      zero4(dcb[u]);
    }
    for (int k0 = 0; k0 < n8; k0 += 8) {
      float a[MT][4], b[MT][2];
#pragma unroll
      for (int u = 0; u < MT; ++u) {
        frag_a(Cs, n8, 16 * kib[u], k0, g, t, a[u]);
        frag_b_nk(Bs, n8, k0, 8 * kjb[u], g, t, b[u]);
      }
      mma3_n<MT>(cbr, a, b);
    }
    if (MW > 0) {
#pragma unroll
      for (int v = 0; v < NW; ++v) zero4(wtb[v]);
    } else {
      for (int e = tid; e < n16 * Lp; e += kThreads) wtbs[e] = 0.f;
    }
  };

  // dC and dB of the (batch, chunk) from the CTA's sums, into its segment;
  // `scr` is a stage no copy is landing in
  auto segment_end = [&](int64_t bc, float* scr) {
    float* dcbs = scr;
    float* wts = MW > 0 ? scr + Lp * Lp : wtbs;
#pragma unroll
    for (int u = 0; u < MT; ++u) {
      if (warp + kWarps * u < T) {
        const int i = 16 * kib[u] + g, j = 8 * kjb[u] + 2 * t;
        *reinterpret_cast<float2*>(dcbs + swz(i, j, Lp)) = make_float2(dcb[u][0], dcb[u][1]);
        if (i + 8 < Lp)
          *reinterpret_cast<float2*>(dcbs + swz(i + 8, j, Lp)) = make_float2(dcb[u][2], dcb[u][3]);
      }
    }
    if (MW > 0) {
#pragma unroll
      for (int v = 0; v < NW; ++v) {
        int m0, n0;
        if (wt_tile(v, m0, n0)) {
          const int s = m0 + g, l = n0 + 2 * t;
          wts[s * Lp + l] = wtb[v][0];
          wts[s * Lp + l + 1] = wtb[v][1];
          wts[(s + 8) * Lp + l] = wtb[v][2];
          wts[(s + 8) * Lp + l + 1] = wtb[v][3];
        }
      }
    }
    __syncthreads();
    float* seg = part + (static_cast<int64_t>(blockIdx.x) + bc) * 2 * Ln;
    const int nS = n8 / 8, nG = (nS + kNT - 1) / kNT, nI = (Lp + 15) / 16;
    const int jobs = 2 * nI * nG;
    for (int job = warp; job < jobs; job += kWarps) {   // 16 rows by up to kNT tiles of s
      const bool is_db = job >= nI * nG;
      const int v = is_db ? job - nI * nG : job;
      const int m0 = 16 * (v / nG), n0 = 8 * kNT * (v % nG);
      const int nt = min(kNT, nS - kNT * (v % nG));
      float acc[kNT][4];
      if (is_db) {        // dB[j][s] = term[s][j] + sum_{i >= j} dCB[i][j] C[i][s]
#pragma unroll
        for (int c = 0; c < kNT; ++c)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = m0 + g + 8 * (q >> 1), s = n0 + 8 * c + 2 * t + (q & 1);
            acc[c][q] = c < nt && j < Lp ? wts[s * Lp + j] : 0.f;
          }
        mma_row<kNT>(acc, m0, Lp, [&](int k0, float a[4]) { frag_at(dcbs, Lp, m0, k0, g, t, a); },
                [&](int k0, int c, float b[2]) {
                  frag_b_kn(Cs, n8, k0, n0 + 8 * (c < nt ? c : 0), g, t, b);
                });
      } else {            // dC[i][s] = sum_{j <= i} dCB[i][j] B[j][s]
#pragma unroll
        for (int c = 0; c < kNT; ++c) zero4(acc[c]);
        mma_row<kNT>(acc, 0, min(m0 + 16, Lp),
                [&](int k0, float a[4]) { frag_a(dcbs, Lp, m0, k0, g, t, a); },
                [&](int k0, int c, float b[2]) {
                  frag_b_kn(Bs, n8, k0, n0 + 8 * (c < nt ? c : 0), g, t, b);
                });
      }
      float* out = seg + (is_db ? Ln : 0);
#pragma unroll
      for (int c = 0; c < kNT; ++c)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = m0 + g + 8 * (q >> 1), col = n0 + 8 * c + 2 * t + (q & 1);
          if (c < nt && r < L && col < n) out[static_cast<int64_t>(r) * n + col] = acc[c][q];
        }
    }
    __syncthreads();
  };

  // prologue: the stages zeroed and their mbarriers set up; B and C (a
  // cp.async group), the first head and the second
  zero_stages(stages, lay.stages * lay.stage_floats);
  if (tid == 0) {
    for (int s2 = 0; s2 < lay.stages; ++s2) repro_ptx::mbar_init(sbar + s2, kThreads);
    repro_ptx::mbar_init_fence();
  }
  __syncthreads();
  int64_t bc = first / nh;
  load_bc(bc);
  load_head(first);
  if (two && first + 1 < last) load_head(first + 1);
  // phase: load issue
  bool new_bc = true;

  for (int64_t item = first; item < last; ++item) {
    // B and C of a (batch, chunk) the CTA enters (one call site: the
    // register arrays it fills stay registers)
    if (new_bc) {
      cp_wait<0>();
      __syncthreads();
      // phase: load wait
      start_bc();
      // phase: C.B^T
      new_bc = false;
    }
    const int h = static_cast<int>(item - bc * nh);
    float* st = stage_of(item);
    const float* xs = st;
    const float* dys = st + lay.s_dy;
    const float* dss = st + lay.s_ds;
    const float* dts = st + lay.s_dt;
    const float a = __ldg(A + h);
    repro_ptx::mbar_wait(sbar + stage_idx(item), parity_of(item));
    // phase: head wait

    // cum in fp64 by a shuffle scan (each lane sums a run of ceil(L/32)
    // steps, the lanes' totals are scanned, each run is offset), then e:
    // every warp into its own copy
    {
      const int per = (L + 31) / 32;
      const int l0 = min(lane * per, L), l1 = min(l0 + per, L);
      double run = 0.0;
      for (int l = l0; l < l1; ++l) {
        run += static_cast<double>(dts[l]) * a;
        cw[l] = run;
      }
      double incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      const double excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane > 0)
        for (int l = l0; l < l1; ++l) cw[l] += excl;
      __syncwarp();
      for (int l = lane; l < Lp; l += 32) {
        if (l >= L) cw[l] = 0.0;
        rowp[l] = colp[l] = qp[l] = 0.f;
      }
      __syncwarp();
    }
    // phase: cum, e

    // P on this warp's dM' tiles (0 above the diagonal and in the padding),
    // the decay kept
#pragma unroll
    for (int u = 0; u < MT; ++u) {
      if (warp + kWarps * u < T) {
        const int i0 = 16 * kib[u] + g, j0 = 8 * kjb[u] + 2 * t;
        float pv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + 8 * (q >> 1), j = j0 + (q & 1);
          const bool in = j <= i && i < L;
          dec[u][q] = in ? expf(static_cast<float>(cw[i] - cw[j])) : 0.f;
          pv[q] = in ? cbr[u][q] * dec[u][q] : 0.f;
        }
        *reinterpret_cast<float2*>(Ps + swz(i0, j0, Lp)) = make_float2(pv[0], pv[1]);
        if (i0 + 8 < Lp)
          *reinterpret_cast<float2*>(Ps + swz(i0 + 8, j0, Lp)) = make_float2(pv[2], pv[3]);
      }
    }
    __syncthreads();
    // phase: form P


    // dx jobs: e (B dS) + P^T dy over up to kNT column tiles, scaled by dt
    for (int jx = deal.start[warp]; jx < deal.start[warp + 1]; ++jx) {
      const int code = deal.dx[jx];
      const int m0 = 16 * (code >> 10), gr = code & 1023, n0 = 8 * kNT * gr;
      const int nt = min(kNT, p8 / 8 - kNT * gr);
      float acc[kNT][4];
#pragma unroll
      for (int c = 0; c < kNT; ++c) zero4(acc[c]);
      mma_row<kNT>(acc, 0, n8, [&](int k0, float af[4]) { frag_a(Bs, n8, m0, k0, g, t, af); },
              [&](int k0, int c, float bf[2]) {
                bfrag_b_kn(dss, n16, lbw, k0, n0 + 8 * (c < nt ? c : 0), g, t, bf);
              });
      const float e0 = ev(m0 + g), e1 = ev(m0 + g + 8);
#pragma unroll
      for (int c = 0; c < kNT; ++c) {
        acc[c][0] *= e0;
        acc[c][1] *= e0;
        acc[c][2] *= e1;
        acc[c][3] *= e1;
      }
      mma_row<kNT>(acc, m0, Lp, [&](int k0, float af[4]) { frag_at(Ps, Lp, m0, k0, g, t, af); },
              [&](int k0, int c, float bf[2]) {
                bfrag_b_kn(dys, Lp, lbw, k0, n0 + 8 * (c < nt ? c : 0), g, t, bf);
              });
      const int64_t row0 = (item / nh) * L;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int l = m0 + g + 8 * hr;
        if (l >= L) continue;
        const float d = dts[l];
        float* out = dx + ((row0 + l) * nh + h) * static_cast<int64_t>(p) + n0 + 2 * t;
#pragma unroll
        for (int c = 0; c < kNT; ++c) {
          const int k = n0 + 8 * c + 2 * t;
          if (c >= nt || k >= p) continue;
          if (dxvec) {
            *reinterpret_cast<float2*>(out + 8 * c) =
                make_float2(acc[c][2 * hr] * d, acc[c][2 * hr + 1] * d);
          } else {
            out[8 * c] = acc[c][2 * hr] * d;
            if (k + 1 < p) out[8 * c + 1] = acc[c][2 * hr + 1] * d;
          }
        }
      }
    }

    // phase: dx (warp 0)

    // dM' = dy x^T on this warp's triangle tiles, their chains side by side
    // over p, then their epilogues; then dW^T = dS x^T on its dW^T tiles
    // (rows s, columns l) and theirs
    {
      // the k loops walk p box by box: a lane's rows are fixed in a box,
      // and a step moves between the row's swizzled chunks (bfrag_a's and
      // bfrag_b_nk's addresses, without their per-step arithmetic)
      const int sw_g = box_swz(g, lbw), down = 8 << lbw, nbox = p8 >> lbw, steps = 1 << (lbw - 2);
      float ak[MT][4];
#pragma unroll
      for (int u = 0; u < MT; ++u) zero4(ak[u]);
      for (int box = 0; box < nbox; ++box) {
        const float* pa[MT];
        const float* pb[MT];
#pragma unroll
        for (int u = 0; u < MT; ++u) {
          pa[u] = dys + ((box * Lp + 16 * kib[u] + g) << lbw) + t;
          pb[u] = xs + ((box * Lp + 8 * kjb[u] + g) << lbw) + t;
        }
        for (int ch = 0; ch < steps; ch += 2) {
          const int c0 = (ch ^ sw_g) << 2, c1 = ((ch + 1) ^ sw_g) << 2;
          float af[MT][4], bf[MT][2];
#pragma unroll
          for (int u = 0; u < MT; ++u) {
            af[u][0] = pa[u][c0];
            af[u][1] = pa[u][down + c0];
            af[u][2] = pa[u][c1];
            af[u][3] = pa[u][down + c1];
            bf[u][0] = pb[u][c0];
            bf[u][1] = pb[u][c1];
          }
          mma3_n<MT>(ak, af, bf);
        }
      }

      // phase: dM' loop (warp 0)

      // dM' epilogues: dCB, the G and P terms
#pragma unroll
      for (int u = 0; u < MT; ++u) {
        if (warp + kWarps * u < T) {
          const int m0 = 16 * kib[u], n0 = 8 * kjb[u];
          float rows[2] = {0.f, 0.f}, cols[2] = {0.f, 0.f};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = m0 + g + 8 * (q >> 1), j = n0 + 2 * t + (q & 1);
            if (j <= i && i < L) {
              const float dm = ak[u][q], dtj = dts[j];
              dcb[u][q] += dm * dec[u][q] * dtj;
              const float kp = dm * (cbr[u][q] * dec[u][q]);
              if (j < i) {
                rows[q >> 1] = fmaf(kp, dtj, rows[q >> 1]);
                cols[q & 1] += kp;
              } else {
                dk[i] = kp;
              }
            }
          }
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            rows[hr] += __shfl_xor_sync(0xffffffffu, rows[hr], 1);
            rows[hr] += __shfl_xor_sync(0xffffffffu, rows[hr], 2);
            cols[hr] += __shfl_xor_sync(0xffffffffu, cols[hr], 4);
            cols[hr] += __shfl_xor_sync(0xffffffffu, cols[hr], 8);
            cols[hr] += __shfl_xor_sync(0xffffffffu, cols[hr], 16);
          }
          if (t == 0) {
            rowp[m0 + g] += rows[0];
            if (m0 + g + 8 < Lp) rowp[m0 + g + 8] += rows[1];
          }
          if (g == 0) {
            colp[n0 + 2 * t] += cols[0];
            colp[n0 + 2 * t + 1] += cols[1];
          }
        }
      }

      float aw[NW][4];
#pragma unroll
      for (int v = 0; v < NW; ++v) zero4(aw[v]);
      for (int box = 0; MW > 0 && box < nbox; ++box) {
        for (int ch = 0; ch < steps; ch += 2) {
          const int c0 = (ch ^ sw_g) << 2, c1 = ((ch + 1) ^ sw_g) << 2;
#pragma unroll
          for (int z = 0; z < NZ; ++z) {         // a super-tile's fragments split once a step
            uint32_t ab[SR][4], as[SR][4], bb[SC][2], bs[SC][2];
#pragma unroll
            for (int a = 0; a < SR; ++a) {
              const float* pa = dss + ((box * n16 + wr[z][a] + g) << lbw) + t;
              const float af[4] = {pa[c0], pa[down + c0], pa[c1], pa[down + c1]};
#pragma unroll
              for (int i = 0; i < 4; ++i) split_tf32(af[i], ab[a][i], as[a][i]);
            }
#pragma unroll
            for (int b = 0; b < SC; ++b) {
              const float* pb = xs + ((box * Lp + wc[z][b] + g) << lbw) + t;
              const float bf[2] = {pb[c0], pb[c1]};
#pragma unroll
              for (int i = 0; i < 2; ++i) split_tf32(bf[i], bb[b][i], bs[b][i]);
            }
#pragma unroll
            for (int a = 0; a < SR; ++a)
#pragma unroll
              for (int b = 0; b < SC; ++b) mma_tf32(aw[(z * SR + a) * SC + b], as[a], bb[b]);
#pragma unroll
            for (int a = 0; a < SR; ++a)
#pragma unroll
              for (int b = 0; b < SC; ++b) mma_tf32(aw[(z * SR + a) * SC + b], ab[a], bs[b]);
#pragma unroll
            for (int a = 0; a < SR; ++a)
#pragma unroll
              for (int b = 0; b < SC; ++b) mma_tf32(aw[(z * SR + a) * SC + b], ab[a], bb[b]);
          }
        }
      }
      // phase: dW^T loop (warp 0)

      // dW^T epilogues: the dB term and q (the shared-memory variants
      // compute their tiles here, one at a time)
#pragma unroll
      for (int v = 0; v < NW; ++v) {
        int m0 = 0, n0 = 0;
        const bool real = MW > 0 && wt_tile(v, m0, n0);
        for (int om = MW > 0 ? (real ? 0 : Wt) : w_first; om < Wt;
             om += (MW > 0 ? Wt : kWarps)) {
          if (MW == 0) {
            m0 = 16 * (om / nWl);
            n0 = 8 * (om % nWl);
          }
          float acc[4];
          if (MW > 0) {
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[q] = aw[v][q];
          } else {
            zero4(acc);
            for (int k0 = 0; k0 < p8; k0 += 8) {
              float af[4], bf[2];
              bfrag_a(dss, n16, lbw, m0, k0, g, t, af);
              bfrag_b_nk(xs, Lp, lbw, k0, n0, g, t, bf);
              mma3(acc, af, bf);
            }
          }
          float qs[2] = {0.f, 0.f};
          const float edt[2] = {ev(n0 + 2 * t) * dts[n0 + 2 * t],
                                ev(n0 + 2 * t + 1) * dts[n0 + 2 * t + 1]};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int s = m0 + g + 8 * (q >> 1), l = n0 + 2 * t + (q & 1);
            const float term = acc[q] * edt[q & 1];
            if (MW > 0) {
              wtb[v][q] += term;
            } else {
              wtbs[s * Lp + l] += term;
            }
            if (s < n) qs[q & 1] = fmaf(acc[q], Bs[swz(l, s, n8)], qs[q & 1]);
          }
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            qs[c] += __shfl_xor_sync(0xffffffffu, qs[c], 4);
            qs[c] += __shfl_xor_sync(0xffffffffu, qs[c], 8);
            qs[c] += __shfl_xor_sync(0xffffffffu, qs[c], 16);
          }
          if (g == 0) {
            qp[n0 + 2 * t] += qs[0];
            qp[n0 + 2 * t + 1] += qs[1];
          }
        }
      }
    }
    __syncthreads();
    // phase: products

    // per l (lpl lanes an l, all threads): the warps' partials summed in a
    // fixed order, dcum, ddt's own terms; each warp's suffix sums of dcum
    // over its l, its total and its share of sum H
    const int lpl = lay.lpl;
    const int l = tid / lpl, part_i = tid % lpl;
    float rowg = 0.f, colk = 0.f, q = 0.f;
    if (l < Lp)
      for (int w = part_i; w < kWarps; w += lpl) {
        rowg += smem[lay.o_rowp + w * Lp + l];
        colk += smem[lay.o_colp + w * Lp + l];
        q += smem[lay.o_qp + w * Lp + l];
      }
    for (int off = 1; off < lpl; off <<= 1) {
      rowg += __shfl_xor_sync(0xffffffffu, rowg, off);
      colk += __shfl_xor_sync(0xffffffffu, colk, off);
      q += __shfl_xor_sync(0xffffffffu, q, off);
    }
    float d = 0.f, dcum = 0.f, ddt0 = 0.f, hl = 0.f;
    if (l < L) {
      d = dts[l];
      const float e = ev(l);
      hl = l < L - 1 ? e * d * q : 0.f;          // e_{L-1} = 1 cancels
      dcum = rowg - d * colk - hl;
      ddt0 = colk + dk[l] + e * q;
    }
    float suf = dcum, hs = hl;
    for (int off = lpl; off < 32; off <<= 1) {
      const float v = __shfl_down_sync(0xffffffffu, suf, off);
      if (lane + off < 32) suf += v;
      hs += __shfl_xor_sync(0xffffffffu, hs, off);
    }
    if (lane == 0) {
      tot[warp] = suf;
      tot[kWarps + warp] = hs;
    }
    const double cend = cw[L - 1];
    // phase: per-l sums

    const int64_t next = item + 1;
    const bool more = next < last;
    const int64_t nbc = more ? next / nh : -1;
    const bool seg_end = !more || nbc != bc;
    __syncthreads();
    // phase: barrier

    // d(dA) = the suffix sum over l, the later warps' totals and cum_end's
    // terms (sum H + dg g); ddt, and each warp's share of dA
    {
      float later = 0.f;
      for (int w = kWarps - 1; w > warp; --w) later += tot[w];
      float hsum = 0.f;
      for (int w = 0; w < kWarps; ++w) hsum += tot[kWarps + w];
      const float extra = hsum + __ldg(dg + item) * expf(static_cast<float>(cend));
      const float dda = suf + (later + extra);
      float da = 0.f;
      if (l < L && part_i == 0) {
        ddt[(item / nh * L + l) * nh + h] = fmaf(a, dda, ddt0);
        da = d * dda;
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) da += __shfl_xor_sync(0xffffffffu, da, off);
      if (lane == 0) dapart[item * kWarps + warp] = da;
    }
    // phase: ddt, dA

    if (seg_end) {
      segment_end(bc, st);
      // phase: segment end
      if (more) {
        zero_stages(st, lay.stage_floats);       // the scratch left its padding dirty
        __syncthreads();
        bc = nbc;
        load_bc(bc);
        new_bc = true;
      }
    }
    if (more) {
      if (!two) load_head(next);                 // into this head's stage, now read
      if (two && next + 1 < last) load_head(next + 1);
      // phase: load issue
    }
  }
}

// The CTA containing flat item t (CTA c holds [items c / ctas, items (c+1)
// / ctas), none empty as ctas <= items)
__device__ __forceinline__ int64_t cta_of(int64_t t, int64_t items, int ctas) {
  return ((t + 1) * ctas - 1) / items;
}

// dC, dB of each (batch, chunk): its segments summed in CTA order, a block
// per 256 of its 2 L n values; then a block per head sums its dA over the
// (batch, chunk, warp) shares in a fixed tree
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_kernel(const float* __restrict__ part, const float* __restrict__ dapart,
                      float* __restrict__ dB, float* __restrict__ dC, float* __restrict__ dA,
                      int64_t items, int ctas, int64_t nbc, int nh, int64_t Ln, int pieces) {
  const int64_t blk = blockIdx.x;
  if (blk >= nbc * pieces) {
    __shared__ float red[kThreads];
    const int h = static_cast<int>(blk - nbc * pieces);
    float s = 0.f;
    for (int64_t k = threadIdx.x; k < nbc * kWarps; k += kThreads)
      s += dapart[((k / kWarps) * nh + h) * kWarps + k % kWarps];
    red[threadIdx.x] = s;
    __syncthreads();
    for (int half = kThreads / 2; half > 0; half >>= 1) {
      if (static_cast<int>(threadIdx.x) < half) red[threadIdx.x] += red[threadIdx.x + half];
      __syncthreads();
    }
    if (threadIdx.x == 0) dA[h] = red[0];
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

using KernelFn = void (*)(const float*, const float*, const float*, const float*, const float*,
                          const float*, const float*, const float*, float*, float*, float*,
                          float*, int64_t, int, int, int, int, int, int, int, int, Layout, Deal,
                          CUtensorMap, CUtensorMap, CUtensorMap);

// TMA maps of x and dy (b, nc, L, h, p) as the 4-D (p, h, nc L, b) view in
// boxes of BW x 1 x L x 1, and of dS (b, nc, h, n, p) as the 3-D (p, n, b nc
// h) view in boxes of BW x n x 1, with the swizzle of the box width; zero
// fill past p.  False where TMA cannot take the tensors.
bool make_maps(const void* x, const void* dy, const void* dS, int b, int nc, int L, int nh,
               int p, int n, int lbw, CUtensorMap maps[3]) {
  const repro_flash::EncodeTiled fn = repro_flash::encode_tiled();
  if (fn == nullptr || L > 256 || n > 256) return false;
  const CUtensorMapSwizzle swz = lbw == 5 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : lbw == 4 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint64_t row = static_cast<cuuint64_t>(p) * 4;
  const cuuint64_t dims4[4] = {static_cast<cuuint64_t>(p), static_cast<cuuint64_t>(nh),
                               static_cast<cuuint64_t>(nc) * L, static_cast<cuuint64_t>(b)};
  const cuuint64_t strides4[3] = {row, row * nh, row * nh * nc * L};
  const cuuint32_t box4[4] = {1u << lbw, 1, static_cast<cuuint32_t>(L), 1};
  const cuuint64_t dims3[3] = {static_cast<cuuint64_t>(p), static_cast<cuuint64_t>(n),
                               static_cast<cuuint64_t>(b) * nc * nh};
  const cuuint64_t strides3[2] = {row, row * n};
  const cuuint32_t box3[3] = {1u << lbw, static_cast<cuuint32_t>(n), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const void* ptrs[2] = {x, dy};
  for (int i = 0; i < 2; ++i)
    if (fn(&maps[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptrs[i]), dims4,
           strides4, box4, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return false;
  return fn(&maps[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(dS), dims3,
            strides3, box3, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

KernelFn kernel_of(int variant) {
  switch (variant) {
    case kV3x1: return ssd_bwd_kernel<3, 1>;
    case kV3x8: return ssd_bwd_kernel<3, 8>;
    case kV3x16: return ssd_bwd_kernel<3, 16>;
    default: return ssd_bwd_kernel<12, 0>;
  }
}

struct Occupancy {
  int device = -1, sms = 0;
  int ctas_per_sm[kVariants] = {};
  size_t smem[kVariants] = {};
};

// The CTAs a call of this layout gets on the current device (SMs times the
// CTAs per SM its shared memory, registers and threads allow), at most
// `items`.
cudaError_t grid_of(const Layout& lay, int variant, int64_t items, int* ctas) {
  static Occupancy occ;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(lay.floats) * 4;
  if (occ.device != dev) {
    for (int v = 0; v < kVariants && err == cudaSuccess; ++v) {
      err = cudaFuncSetAttribute(kernel_of(v), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kMaxSmem));
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel_of(v), cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
      occ.smem[v] = 0;
    }
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&occ.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    occ.device = dev;
  }
  if (occ.smem[variant] != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ.ctas_per_sm[variant],
                                                        kernel_of(variant), kThreads, smem);
    if (err != cudaSuccess) return err;
    if (occ.ctas_per_sm[variant] < 1) return cudaErrorInvalidConfiguration;
    occ.smem[variant] = smem;
  }
  const int64_t slots = static_cast<int64_t>(occ.sms) * occ.ctas_per_sm[variant];
  *ctas = static_cast<int>(items < slots ? items : slots);
  return cudaSuccess;
}

bool plan_of(int b, int nc, int L, int nh, int p, int n, Layout* lay, int* variant) {
  return b > 0 && nc > 0 && nh > 0 && L > 0 && p > 0 && n > 0 &&
         choose_layout(L, p, n, lay, variant);
}

}  // namespace

// The launch an SSD backward call of this shape takes on the current device:
// head stages (2: the next head's inputs in flight; 1), threads per CTA,
// CTAs, dynamic shared memory in bytes, the floats of the partials buffer
// the caller allocates ((CTAs + batch x chunks) segments of 2 L n), the
// variant's dM' and dW^T tiles a warp keeps, and the bytes of its least
// (one-stage) layout, which ops.ssd_chunk_bwd_smem_bytes counts.  No
// launch; an error where no layout fits.
extern "C" int ssd_chunk_bwd_plan(int b, int nc, int L, int nh, int p, int n, int* stages,
                                  int* threads, int* ctas, int64_t* smem_bytes,
                                  int64_t* part_floats, int* dm_tiles, int* dw_tiles,
                                  int64_t* least_smem_bytes) {
  Layout lay;
  int variant = 0;
  if (!plan_of(b, nc, L, nh, p, n, &lay, &variant)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t items = static_cast<int64_t>(b) * nc * nh;
  const cudaError_t err = grid_of(lay, variant, items, ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  *stages = lay.stages;
  *threads = kThreads;
  *smem_bytes = static_cast<int64_t>(lay.floats) * 4;
  *part_floats = (*ctas + static_cast<int64_t>(b) * nc) * 2 * L * n;
  *dm_tiles = kVariantMT[variant];
  *dw_tiles = kVariantMW[variant];
  const Layout least = make_layout(L, p, n, 1, kVariantMW[variant] == 0);
  *least_smem_bytes = static_cast<int64_t>(least.floats) * 4;
  return 0;
}

// dx, ddt, dA, dB, dC of the SSD block (all fp32, the inputs' shapes) from
// x, dt, A, B, C and the output gradients dy, dS (b, nc, h, n, p), dg (b, nc,
// h); `part` (part_floats, at least what ssd_chunk_bwd_plan gives) and
// `dapart` (8 b nc h floats: a share per warp) are scratch.  Two launches
// on `stream`.
extern "C" int ssd_chunk_bwd_f32(const void* x, const void* dt, const void* A, const void* B,
                                 const void* C, const void* dy, const void* dS, const void* dg,
                                 void* dx, void* ddt, void* dA, void* dB, void* dC, void* part,
                                 void* dapart, int64_t part_floats, int b, int nc, int L, int nh,
                                 int p, int n, void* stream) {
  Layout lay;
  int variant = 0;
  if (!plan_of(b, nc, L, nh, p, n, &lay, &variant)) return static_cast<int>(cudaErrorInvalidValue);
  Deal deal;
  if (!make_deal(lay, kVariantMW[variant], &deal)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t items = static_cast<int64_t>(b) * nc * nh;
  const int64_t nbc = static_cast<int64_t>(b) * nc;
  int ctas = 0;
  cudaError_t err = grid_of(lay, variant, items, &ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t Ln = static_cast<int64_t>(L) * n;
  if (part_floats < (ctas + nbc) * 2 * Ln) return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* ptr, int bytes) {
    return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
  };
  CUtensorMap maps[3] = {};
  const int tma = p % 4 == 0 && aligned(x, 16) && aligned(dy, 16) && aligned(dS, 16) &&
                  make_maps(x, dy, dS, b, nc, L, nh, p, n, lay.lbw, maps);
  const int bvec = n % 4 == 0 && aligned(B, 16) && aligned(C, 16);
  const int dxvec = p % 2 == 0 && aligned(dx, 8);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel_of(variant)<<<ctas, kThreads, static_cast<size_t>(lay.floats) * 4, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(dy),
      static_cast<const float*>(dS), static_cast<const float*>(dg), static_cast<float*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(part), static_cast<float*>(dapart), items,
      nc, L, nh, p, n, tma, bvec, dxvec, lay, deal, maps[0], maps[1], maps[2]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pieces = static_cast<int>((2 * Ln + kThreads - 1) / kThreads);
  ssd_bwd_reduce_kernel<<<static_cast<unsigned>(nbc * pieces + nh), kThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<const float*>(dapart),
      static_cast<float*>(dB), static_cast<float*>(dC), static_cast<float*>(dA), items, ctas,
      nbc, nh, Ln, pieces);
  return static_cast<int>(cudaGetLastError());
}
