// Bulk-copy helpers shared by the port's Hopper byte movers (a2a_lock.cu's
// cluster kernel, a2a_fence.cu's bulk gather).
//
// The 1-D TMA bulk copy moves a contiguous run of bytes between device
// memory and shared memory without spending registers or instructions of the
// threads on it: one thread issues it, the copy engine does the work.
//
//   - loads, global -> shared, complete on an mbarrier: the issuing thread
//     announces the bytes with `mbarrier.arrive.expect_tx`, each copy counts
//     its bytes off as it lands, and the phase completes when the count is
//     back at zero and every expected arrival came (at most 2^20 - 1 bytes
//     per phase);
//   - stores, shared -> global, are tracked by bulk groups of the issuing
//     thread: `wait_read<N>` returns once all but the N most recent groups
//     have read their shared-memory source (the stage may be refilled), and
//     `wait_all` once every group's writes are complete.
//
// Addresses and sizes must be multiples of 16 bytes.  Shared memory that
// threads wrote with ordinary stores is handed to the copy engine only after
// `fence_proxy_async` (generic proxy -> async proxy).
//
// Every mbarrier wait gives up with a trap after about 10 s (2^34 cycles)
// instead of hanging the card: a trap ends the whole grid with an error the
// next synchronising call reports.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bulk {

constexpr long long kSpinCycles = 1LL << 34;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the copy engine (and to the
// other CTAs of a cluster).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of bulk loads on this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of parity `parity` has completed; traps after ~10 s.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long t0 = 0;
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (i == 0)
      t0 = clock64();
    else if (clock64() - t0 > kSpinCycles)
      __trap();
  }
}

// Orders this thread's ordinary shared-memory stores before later bulk
// copies that read the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` from global `src` into this CTA's shared `dst`, counted off `bar`.
__device__ __forceinline__ void load(void* dst, const void* src, uint32_t bytes,
                                     uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// `bytes` from this CTA's shared `src` to global `dst`, in the open group.
__device__ __forceinline__ void store(void* dst, const void* src,
                                      uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// All but the N most recent store groups have read their source.
template <int N>
__device__ __forceinline__ void wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Every store group's writes are complete.
__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The cluster barrier: release this thread's prior writes (and, after
// wait_all, its completed bulk stores) to the cluster, then acquire the
// other CTAs'.  Every thread of every CTA of the cluster takes part.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

// The CTA's share [lo, hi) of `units` items split evenly over `n` parts.
__host__ __device__ __forceinline__ void split(long long units, long long n,
                                               long long part, long long* lo,
                                               long long* hi) {
  *lo = units * part / n;
  *hi = units * (part + 1) / n;
}

}  // namespace bulk
