// Shared-memory mbarrier helpers (PTX, sm_90) of the kernels that wait on
// asynchronous copies or stores: flash_attention.cu and
// flash_attention_bwd.cu (TMA tiles),
// affine_warp.cu (bulk image copies), kld_score.cu (bulk tile copies) and
// kld_greedy.cu (st.async keys between the CTAs of a cluster), and the
// dynamic shared memory limit their large tiles need.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace repro_ptx {

// Raises a kernel's dynamic shared memory limit on the current device,
// once a device and instantiation: cudaFuncSetAttribute holds for the
// device current when it is called, so a process that launches on several
// cards sets it on each.  Each device's answer is kept (0 unset, else the
// error + 1); two threads racing on one device set the same value.
template <auto kKernel>
cudaError_t smem_limit_once(size_t bytes) {
  constexpr int kDevices = 64;
  static std::atomic<int> state[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kDevices)
    return cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
  int s = state[dev].load(std::memory_order_acquire);
  if (s == 0) {
    err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    s = static_cast<int>(err) + 1;
    state[dev].store(s, std::memory_order_release);
  }
  return static_cast<cudaError_t>(s - 1);
}

// The 32-bit shared-state-space address of a shared-memory pointer.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the initialized mbarriers visible to the async proxy and to the
// other CTAs of the cluster.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrives on `bar` and expects `bytes` more of asynchronous completion in
// its current phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Spins until the barrier's phase with parity `parity` has completed: then
// the bytes its asynchronous operations delivered are visible.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

}  // namespace repro_ptx
