// The whole Alg. 3 greedy pass in one launch: (K, C) histograms -> (K,) picks.
//
// Replaces: src/repro/kernels/kld_score.py::kld_greedy_picks (Pallas, TPU),
// a (K steps x K/BLOCK_K blocks) sequential grid carrying the pick mask and
// the open mediator in VMEM scratch.
//
// Bound on the H100: latency.  Step s scores the K - s unpicked clients
// over C classes (a division and a logf per class), so the pass does ~K^2
// C / 2 scorings on K*C*4 bytes (~4e8 logf on 770 KB at K = 4,096, C =
// 47); but the K steps are dependent, so each costs at least one row's
// scoring (2C dependent adds) plus one exchange of the step's argmin
// between every SM the step runs on.
//
// Design: one thread-block cluster of up to 16 CTAs on neighbouring SMs
// (cudaLaunchKernelEx; the cluster size is a launch parameter chosen from
// K, ~64 candidates per CTA, capped by what the card can co-schedule).
// CTA r owns the candidates [r*kc, (r+1)*kc) and keeps their rows in its
// shared memory; rows that do not fit are read from global memory (L2), so
// K and C have no fixed limit.  Each CTA also keeps its own copy of the
// open mediator, its candidates' static scores (their scores against an
// empty mediator) and a compact list of its unpicked candidates.
//
// A step: each group of L lanes (L = 1..8, as many lanes per candidate as
// 1,024 threads allow) scores one listed candidate at a time with
// kld_common.cuh::score_lanes, the scorer kld_score.cu shares: the lanes
// split the per-class divisions and logarithms, and each of the two sums
// runs in one accumulator over ascending classes, so the scores are those
// of one thread per candidate bit for bit.  At a step that opens a
// mediator the static score is the score, so those steps (1 in gamma) do
// no scoring.  Each (score, index) becomes one 64-bit key whose unsigned
// order is "lower score, then lower index", a total order: a warp-shuffle
// then shared-memory minimum gives the CTA's best key, and the pick is the
// first minimum over all clients, as in the numpy loop, whatever the shape
// of the reduction.  Warp 0 pushes the CTA's key into every CTA's inbox
// through distributed shared memory with asynchronous stores (st.async),
// each completing its 8 bytes on that CTA's mbarrier, waits for its own n
// keys and takes their minimum: every CTA gets the same pick.  Warp 0 then
// drops the pick from the list if this CTA owns it (swap with the last
// entry: a total order does not care for the list's order) and folds the
// pick's row, read from the owner's shared memory, into the mediator,
// which resets after every gamma picks; one barrier releases the other
// warps into the next step.  Inboxes and mbarriers alternate by step
// parity; a CTA can be at most one step ahead of another, so the two
// never mix.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kld_common.cuh"
#include "mbarrier.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace repro_ptx;

constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 16;
constexpr int kMaxLanes = 8;          // lanes per candidate
constexpr int kLaneThreads = 1024;    // threads the lanes per candidate may fill
constexpr int kPerCta = 64;           // candidates per CTA the cluster size aims at
constexpr int kSmemBudget = 220 * 1024;

// A (score, index) pair as one 64-bit key whose unsigned order is "lower
// score, then lower index" (the score's bits mapped to an order-preserving
// unsigned, -0 first made +0 so that it ties with +0 as in a float compare).
using Key = unsigned long long;
constexpr Key kNoKey = ~0ull;

__device__ __forceinline__ Key key_of(float s, int i) {
  const unsigned u = __float_as_uint(__fadd_rn(s, 0.f));
  const unsigned o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<Key>(o) << 32) | static_cast<unsigned>(i);
}

// The least key of the warp's 32, in every lane.
__device__ __forceinline__ Key warp_min(Key k) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Key o = __shfl_xor_sync(0xffffffffu, k, off);
    k = o < k ? o : k;
  }
  return k;
}

// Where a CTA's per-candidate state and copies live: shared memory where
// it fits, else its slice of the global scratch (generic addresses either
// way; the scratch is null when everything fits).
struct Layout {
  int kc, n_fit, state_in_smem, med_in_smem;
};

template <int L>
__global__ void __launch_bounds__(kMaxThreads)
kld_greedy_kernel(const float* __restrict__ counts, int32_t* __restrict__ picks,
                  float* __restrict__ scratch, int k, int c, int gamma, Layout lay) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_cta = static_cast<int>(cluster.num_blocks());
  extern __shared__ __align__(16) float smem[];
  __shared__ Key warp_best[kMaxThreads / 32];
  __shared__ Key inbox[2][kMaxCluster];        // every CTA's best, by step parity
  __shared__ __align__(8) uint64_t arrived[2];
  __shared__ int s_pick;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int groups = nthreads / L, group = tid / L, q = tid % L;
  const int kc = lay.kc, n_fit = lay.n_fit;
  const int lo = rank * kc;
  const int nl = max(0, min(k, lo + kc) - lo);              // candidates owned

  // shared memory: [state (3 kc)] [med (c)] [rows (n_fit, c)]
  float* next = smem;
  float* gscratch = scratch != nullptr
      ? scratch + static_cast<size_t>(rank) * (3 * static_cast<size_t>(kc) + c)
      : nullptr;
  float* stat = lay.state_in_smem ? next : gscratch;         // (kc,) static scores
  int* list = reinterpret_cast<int*>(stat + kc);             // (kc,) unpicked, compact
  int* pos = list + kc;                                      // (kc,) index in list
  if (lay.state_in_smem) next += 3 * kc;
  float* med = lay.med_in_smem ? next : gscratch + 3 * kc;   // (c,) open mediator
  if (lay.med_in_smem) next += c;
  float* rows = next;                                        // (n_fit, c) row-major

  if (tid == 0) {
    for (int p = 0; p < 2; ++p) mbar_init(arrived + p, 1);
    mbar_init_fence();
  }
  const float* mine = counts + static_cast<int64_t>(lo) * c;
  for (int f = tid; f < min(n_fit, nl) * c; f += nthreads) rows[f] = mine[f];
  for (int j = tid; j < c; j += nthreads) med[j] = 0.f;
  for (int e = tid; e < nl; e += nthreads) {
    list[e] = e;
    pos[e] = e;
  }
  __syncthreads();
  const float log_q = repro_kld::uniform_log_q(c);
  // one code path for rows in shared and in global memory (a generic
  // address), so the lanes of a warp never split around the shuffles
  auto score = [&](int l) {
    const float* row = l < n_fit ? rows + l * c : mine + static_cast<int64_t>(l) * c;
    return repro_kld::score_lanes<L>(row, med, c, log_q, q);
  };
  // Each warp walks the list in rounds of `groups` entries, its groups
  // taking entries r0 + 0 .. r0 + 32/L - 1; the round loop is the same for
  // every lane of a warp, as the shuffles of score_lanes require.
  const int first = warp * (32 / L);
  for (int r0 = first; r0 < nl; r0 += groups) {
    const int e = r0 + group - first;
    const float s = score(e < nl ? e : r0);
    if (e < nl && q == 0) stat[e] = s;
  }
  int n_active = nl;
  // every CTA runs, with its mbarriers set up, before any pushes
  cluster.sync();

  int fill = 0;
  for (int step = 0; step < k; ++step) {
    const int p = step & 1;
    Key b = kNoKey;
    for (int r0 = first; r0 < n_active; r0 += groups) {
      const int e = r0 + group - first;
      const bool valid = e < n_active;
      const int l = list[valid ? e : r0];
      const float sc = fill == 0 ? stat[l] : score(l);
      const Key kk = key_of(sc, lo + l);
      if (valid && kk < b) b = kk;
    }
    b = warp_min(b);
    if (lane == 0) warp_best[warp] = b;
    __syncthreads();
    // warp 0 alone finds the pick, updates this CTA's list and folds the
    // pick into the mediator; the other warps wait at the barrier below
    if (warp == 0) {
      b = warp_min(lane < nwarps ? warp_best[lane] : kNoKey);
      if (n_cta > 1) {
        // this CTA's inbox expects one key from every CTA
        if (lane == 0) mbar_expect_tx(arrived + p, 8 * n_cta);
        if (lane < n_cta) {
          uint32_t slot, bar;
          asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                       : "=r"(slot) : "r"(smem_u32(&inbox[p][rank])), "r"(lane));
          asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                       : "=r"(bar) : "r"(smem_u32(arrived + p)), "r"(lane));
          asm volatile(
              "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32"
              " [%0], {%1, %2}, [%3];\n"
              :: "r"(slot), "r"(static_cast<unsigned>(b)),
                 "r"(static_cast<unsigned>(b >> 32)), "r"(bar)
              : "memory");
        }
        mbar_wait(arrived + p, static_cast<uint32_t>((step >> 1) & 1));
        b = warp_min(lane < n_cta ? inbox[p][lane] : kNoKey);
      }
      const int pick = static_cast<int>(static_cast<unsigned>(b));
      const int owner = pick / kc, l_pick = pick - owner * kc;
      if (lane == 0) {
        s_pick = pick;
        if (rank == 0) picks[step] = pick;
        if (owner == rank) {
          const int e = pos[l_pick], last = list[n_active - 1];
          list[e] = last;
          pos[last] = e;
        }
      }
      if (fill + 1 == gamma) {
        for (int j = lane; j < c; j += 32) med[j] = 0.f;
      } else {
        const float* row = l_pick < n_fit
                               ? cluster.map_shared_rank(rows, owner) + l_pick * c
                               : counts + static_cast<int64_t>(pick) * c;
        for (int j = lane; j < c; j += 32) med[j] = __fadd_rn(med[j], row[j]);
      }
    }
    __syncthreads();
    if (s_pick / kc == rank) --n_active;
    if (++fill == gamma) fill = 0;
  }
  // no CTA leaves while another may still read its shared memory
  cluster.sync();
}

using KernelFn = void (*)(const float*, int32_t*, float*, int, int, int, Layout);

struct Plan {
  int ctas, threads, lanes;
  Layout lay;
  size_t smem;
  int64_t scratch_floats;   // per CTA 3 kc + C where state or mediator spill
  KernelFn fn;
};

KernelFn kernel_for(int lanes) {
  switch (lanes) {
    case 8: return kld_greedy_kernel<8>;
    case 4: return kld_greedy_kernel<4>;
    case 2: return kld_greedy_kernel<2>;
    default: return kld_greedy_kernel<1>;
  }
}

Plan make_plan(int k, int c, int ctas) {
  Plan p{};
  p.ctas = ctas;
  const int kc = (k + ctas - 1) / ctas;
  int lanes = 1;
  while (lanes < kMaxLanes && static_cast<int64_t>(kc) * lanes * 2 <= kLaneThreads) lanes *= 2;
  const int64_t want = (static_cast<int64_t>(kc) * lanes + 31) / 32 * 32;
  p.threads = static_cast<int>(want < kMaxThreads ? want : kMaxThreads);
  p.lanes = lanes;
  p.fn = kernel_for(lanes);
  // shared memory, in order: the per-candidate state, the mediator, rows
  int64_t room = kSmemBudget;
  const int64_t state = 12LL * kc, med = 4LL * c;
  p.lay.kc = kc;
  p.lay.state_in_smem = state <= room;
  if (p.lay.state_in_smem) room -= state;
  p.lay.med_in_smem = med <= room;
  if (p.lay.med_in_smem) room -= med;
  const int64_t fit = room / med;
  p.lay.n_fit = static_cast<int>(fit < kc ? fit : kc);
  p.smem = static_cast<size_t>(kSmemBudget - room + 4LL * p.lay.n_fit * c);
  p.scratch_floats = p.lay.state_in_smem && p.lay.med_in_smem
                         ? 0
                         : static_cast<int64_t>(ctas) * (3LL * kc + c);
  return p;
}

cudaLaunchConfig_t launch_config(const Plan& p, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.ctas);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.ctas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t set_attributes(const Plan& p) {
  cudaError_t err = cudaFuncSetAttribute(p.fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(p.smem));
}

// The launch plan for (k, c): ~kPerCta candidates per CTA, at most 16 CTAs
// and at most the cluster the card can co-schedule at that plan's shared
// memory.  The last answer is kept (a run calls with one or two shapes).
cudaError_t plan_for(int k, int c, Plan* out) {
  static int last_dev = -1, last_k = -1, last_c = -1;
  static Plan last{};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev == last_dev && k == last_k && c == last_c) {
    *out = last;
    return cudaSuccess;
  }
  int want = (k + kPerCta - 1) / kPerCta;
  want = want < kMaxCluster ? want : kMaxCluster;
  Plan p = make_plan(k, c, want);
  if ((err = set_attributes(p)) != cudaSuccess) return err;
  if (want > 1) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = launch_config(p, nullptr, &attr);
    cfg.numAttrs = 0;                 // the query finds the cluster size
    int most = 0;
    if ((err = cudaOccupancyMaxPotentialClusterSize(&most, p.fn, &cfg)) != cudaSuccess)
      return err;
    if (most < 1) return cudaErrorLaunchOutOfResources;
    if (most < want) {
      p = make_plan(k, c, most);
      if ((err = set_attributes(p)) != cudaSuccess) return err;
    }
  }
  last_dev = dev;
  last_k = k;
  last_c = c;
  last = p;
  *out = p;
  return cudaSuccess;
}

}  // namespace

// The launch plan of a (k, c) call: CTAs in the cluster, threads per CTA,
// lanes per candidate, candidate rows each CTA keeps in shared memory, its
// dynamic shared memory in bytes, whether the per-candidate state and the
// mediator live in shared memory, and the floats of global scratch the
// call needs for what does not (0 when everything fits).
extern "C" int kld_greedy_plan(int k, int c, int* ctas, int* threads, int* lanes,
                               int* n_fit, int* smem, int* state_in_smem,
                               int* med_in_smem, int64_t* scratch_floats) {
  if (k <= 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan p{};
  const cudaError_t err = plan_for(k, c, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  *ctas = p.ctas;
  *threads = p.threads;
  *lanes = p.lanes;
  *n_fit = p.lay.n_fit;
  *smem = static_cast<int>(p.smem);
  *state_in_smem = p.lay.state_in_smem;
  *med_in_smem = p.lay.med_in_smem;
  *scratch_floats = p.scratch_floats;
  return 0;
}

extern "C" int kld_greedy_picks(const void* counts, void* picks, void* scratch, int k,
                                int c, int gamma, void* stream) {
  if (k <= 0) return static_cast<int>(cudaGetLastError());
  if (c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan p{};
  cudaError_t err = plan_for(k, c, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the plan's scratch, of kld_greedy_plan's scratch_floats, is the caller's
  if (p.scratch_floats > 0 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(p, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, p.fn, static_cast<const float*>(counts),
                           static_cast<int32_t*>(picks), static_cast<float*>(scratch), k,
                           c, gamma, p.lay);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
