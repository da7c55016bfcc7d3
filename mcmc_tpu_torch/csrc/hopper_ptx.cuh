// The PTX wrappers the fused kernels share, for Hopper (sm_90a): cp.async,
// mbarriers (local and across a cluster), the proxy fences, the cluster's
// rank, barrier and address map, and bulk copies (block to block, and from
// global memory into a block or multicast to the blocks of a cluster).
//
// Included by fused_glm_common.cuh (so by both GLM bodies) and by
// fused_gaussian_trajectory_wide.cu. Everything is in an anonymous
// namespace: each source has its own copy.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// An mbarrier in shared memory: `count` arrivals complete a phase.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes this thread's mbarrier inits visible to the cluster and to bulk
// copies (before the barrier that lets other threads or blocks use them).
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One arrival on `bar` once all cp.async of this thread so far have landed:
// the copies report their own completion, and no thread waits for them
// before it needs the tile.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// Waits until the phase of `bar` with this parity has completed. A wait of
// more than a few seconds is a fault of the ring: it traps, so that a
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    if (clock64() - t0 > (1ll << 33)) __trap();
  }
}

// Makes this thread's shared-memory writes visible to the async proxy: to
// wgmma's reads and to bulk copies out of shared memory.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Makes this thread's global-memory writes visible to the async proxy: to
// bulk copies that another block starts after a barrier that orders them.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of the cluster: this thread's writes, to its own block's
// shared memory or another's, are seen by every thread after the barrier.
// Only at the start and at the end.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The address in block `rank`'s shared memory of this block's `addr`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// This thread's arrival on `bar`, expecting `bytes` more of transactions
// in the phase.
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// mbar_wait with acquire at cluster scope: the bytes or arrivals that
// completed the phase came from other blocks. Traps after a few seconds, as
// mbar_wait.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    if (clock64() - t0 > (1ll << 33)) __trap();
  }
}

// One arrival on the mbarrier at cluster address `bar` (this block's or
// another's, from map_rank), with mbarrier.arrive's default semantics
// (release at CTA scope: on an H100 a release at cluster scope cost the
// two-pass GLM body about 7,800 clocks an item in clock counters).
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// A bulk copy of `bytes` from this block's shared memory at `src` to the
// cluster address `dst`, completing the transactions of the mbarrier at
// cluster address `bar` (in dst's block).
__device__ __forceinline__ void bulk_to_block(uint32_t dst, uint32_t src,
                                              int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
      "bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from global memory at `src` to this block's shared memory at `dst`,
// completing the transactions of this block's mbarrier `bar`.
__device__ __forceinline__ void bulk_from_global(uint32_t dst, const void* src,
                                                 int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// bulk_from_global's copy multicast to the blocks of the cluster in `mask`
// (bit b: rank b): the bytes land at `dst` in each of their shared
// memories and complete the transactions of each one's mbarrier at `bar`.
__device__ __forceinline__ void bulk_multicast(uint32_t dst, const void* src,
                                               int bytes, uint32_t bar,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes."
      "multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

}  // namespace
