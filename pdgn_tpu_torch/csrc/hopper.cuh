// Hopper (sm_90a) building blocks: mbarriers and the producer/consumer
// ring built on them, thread block clusters (the other block's shared
// memory: its address, bulk copies into it, arrivals on its barriers), TMA
// tile loads (cp.async.bulk.tensor, 2-D and 3-D) and the tensor maps that
// describe their tiles, the generic-to-async proxy fence, warpgroup
// products (wgmma m64nNk16, N = 8, 64, 80, 128 or 256, bf16 operands, fp32
// accumulation) on swizzled shared tiles, a slab at a time (wgmma_slab),
// and one product kernel on them (product_bf16_kernel: A^T B over a long
// depth with both operands MN-major, or A B^T K-major). Used by the bf16
// edge head (edge_head.cu: the ring, wgmma_slab), bf16 slot stats
// (slot_stats.cu), the bf16 gated tail (bilateral_tail.cu: the ring's
// indexing for its wi stages, clusters, wgmma_slab), the bf16 head
// backward (edge_head_bwd.cu: the ring, wgmma_bf16, product_bf16_kernel)
// and the bf16 gated tail backward (bilateral_tail_bwd.cu: the ring,
// wgmma_bf16 at N = 8, wgmma_slab at N = 80 and 128, product_bf16_kernel).
//
// Two shared-memory layouts here, rows of bf16 whose 16-byte granules are
// permuted by the row (the XOR of address bits 4-6, or 4-5, with bits 7-9,
// or 7-8, as TMA writes a CU_TENSOR_MAP_SWIZZLE_128B, or _64B, box into a
// tile aligned to 1024 bytes): rows of 64 bf16 (128 bytes), granule q of
// row r at granule q ^ (r % 8) (swizzle_row; the 128-byte swizzle: 8-row
// groups 1024 bytes apart), and rows of 32 bf16 (64 bytes), granule q of
// row r at granule q ^ ((r / 2) % 4) (swizzle64_row; the 64-byte swizzle,
// sw64_desc: 8-row groups 512 bytes apart). wgmma reads a tile K-major
// (a row holds depth: sw128_desc, sw64_desc; its k16 steps 32 bytes apart
// along the row, 2 added to the descriptor a step) or, for 16-bit
// operands, MN-major (a row holds 64 rows or columns of the product at one
// depth: sw128_mn_desc; a k16 step is 16 rows, 2048 bytes, 128 added).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// arrive and expect `bytes` more of asynchronous copies in this phase
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// a wait this long is a fault of the kernel (a phase that never completes):
// trap, so that the launch fails instead of hanging the card
constexpr uint64_t kMbarTimeoutNs = 10000000000ull;

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try(a, parity)) return;
  const uint64_t t0 = globaltimer_ns();
  while (!mbar_try(a, parity))
    if (globaltimer_ns() - t0 > kMbarTimeoutNs) __trap();
}

// --------------------------------------------------------------- the ring
// A ring of stages in shared memory between producers and consumers, a
// full and an empty mbarrier a stage. Positions count from 0 over the
// launch: position it sits in stage it % stages, in round it / stages, and
// a barrier's phase of round j has parity j & 1. A producer takes position
// it once the consumers have released the stage's previous round (the
// first `stages` positions are free at once) and fills it; the consumers
// take it once it is full and release it once its products are done.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  int stages;

  __device__ __forceinline__ int stage(int it) const { return it % stages; }
  __device__ __forceinline__ uint32_t parity(int it) const {
    return (uint32_t)(it / stages) & 1;
  }
  // one thread, before the barrier that publishes the initialisation
  __device__ __forceinline__ void init(int full_count,
                                       int empty_count) const {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], full_count);
      mbar_init(&empty[s], empty_count);
    }
  }
  __device__ __forceinline__ uint64_t* full_bar(int it) const {
    return &full[stage(it)];
  }
  // producer: wait until position it's stage is free
  __device__ __forceinline__ void wait_empty(int it) const {
    if (it >= stages) mbar_wait(&empty[stage(it)], parity(it) ^ 1);
  }
  // consumer: wait until position it is full
  __device__ __forceinline__ void wait_full(int it) const {
    mbar_wait(&full[stage(it)], parity(it));
  }
  // consumer: one of the empty barrier's arrivals for position it
  __device__ __forceinline__ void release(int it) const {
    mbar_arrive(&empty[stage(it)]);
  }
};

// ----------------------------------------------------- thread block clusters
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster: arrive (releasing this
// thread's prior writes) and wait for all of them (acquiring theirs)
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the shared::cluster address of the same location as the shared::cta
// address a in the block of cluster rank `rank`
__device__ __forceinline__ uint32_t map_shared(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}

// arrive on the barrier at shared::cluster address a, releasing at CTA
// scope only: a consumer freeing a stage it has only read
__device__ __forceinline__ void mbar_arrive_remote(uint32_t a) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(a)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_cluster(uint32_t bar,
                                                 uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
      "%2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// mbar_wait, acquiring at cluster scope what the arrivals released (writes
// of another block of the cluster)
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_cluster(a, parity)) return;
  const uint64_t t0 = globaltimer_ns();
  while (!mbar_try_cluster(a, parity))
    if (globaltimer_ns() - t0 > kMbarTimeoutNs) __trap();
}

// copy `bytes` (a multiple of 16) from this block's shared memory to the
// shared::cluster address dst (another block's), completing them on the
// barrier at shared::cluster address bar
__device__ __forceinline__ void bulk_copy_to_peer(uint32_t dst,
                                                  const void* src,
                                                  uint32_t bytes,
                                                  uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(smem_u32(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// ------------------------------------------------------------------ TMA
// the box at element coordinates (c0 along the inner dimension, c1) of a
// 2-D tensor map into dst; completion counts on bar's transaction bytes
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// the box at element coordinates (c0, c1, c2) of a 3-D tensor map into
// dst; completion counts on bar's transaction bytes
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// arrive on bar once this thread's cp.async copies issued so far have
// landed (the barrier's count includes this arrival)
__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// order this thread's generic-proxy shared-memory writes (st.shared,
// completed cp.async) before later async-proxy reads (wgmma, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier `id` (1..15) over `threads` threads
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------- wgmma
// granule q of row r of a swizzled tile sits at granule q ^ swizzle_row(r):
// the XOR of address bits 4-6 with bits 7-9, as TMA writes a
// CU_TENSOR_MAP_SWIZZLE_128B box into a tile aligned to 1024 bytes
__device__ __forceinline__ int swizzle_row(int r) { return r & 7; }
// the 64-byte swizzle of rows of 64 bytes: address bits 4-5 XOR bits 7-8
__device__ __forceinline__ int swizzle64_row(int r) { return (r >> 1) & 3; }

// descriptor of a K-major swizzled bf16 tile (see above): start address,
// leading offset 16 bytes (unused by this layout), sbo bytes between the
// 8-row groups it reads (1024: every group; 2048: every other one), layout
// 1 (128-byte swizzle). A k16 step further along the rows adds 32 bytes: 2
// to the descriptor.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile,
                                              uint32_t sbo = 1024) {
  const uint64_t a = smem_u32(tile);
  return ((a & 0x3FFFFull) >> 4) | (1ull << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// the same for a K-major tile of 64-byte rows in the 64-byte swizzle: 512
// bytes between 8-row groups, layout 2
__device__ __forceinline__ uint64_t sw64_desc(const void* tile) {
  const uint64_t a = smem_u32(tile);
  return ((a & 0x3FFFFull) >> 4) | (1ull << 16) | ((512ull >> 4) << 32) |
         (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most n committed wgmma groups of the warpgroup are pending
template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}

// the compiler may not move reads or writes of d across this point (the
// accumulators of an asynchronous product are defined only after its wait)
template <int n>
__device__ __forceinline__ void fence_regs(float (&d)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// descriptor of an MN-major swizzled bf16 tile: rows of 64 MN values (128
// bytes, the 128-byte swizzle, as TMA writes a box of 64 columns) along
// the depth, 8-row groups 1024 bytes apart (the stride offset) and atoms
// of 64 MN values `lbo` bytes apart (the leading offset: the next box of
// 64 columns), layout 1. A k16 step further along the depth is two 8-row
// groups, 2048 bytes: 128 added to the descriptor.
__device__ __forceinline__ uint64_t sw128_mn_desc(const void* tile,
                                                  uint32_t lbo) {
  const uint64_t a = smem_u32(tile);
  return ((a & 0x3FFFFull) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((1024ull >> 4) << 32) | (1ull << 62);
}

// a k16 step along the depth in descriptor units: 32 bytes of a K-major
// row, two 8-row groups of an MN-major tile
template <int kTrans>
constexpr int kDescStep = kTrans ? 128 : 2;

// d (64 x N, fp32) = A (64 x 16) B (16 x N) + (scale_d ? d : 0), bf16 A and
// B in shared memory (descriptors da, db), read K-major, or MN-major where
// TA (TB) is 1; N = 8, 64, 80, 128 or 256. The warpgroup's thread 32w + 4g + t
// holds rows 16w + g (d[4i], d[4i+1]) and 16w + g + 8 (d[4i+2], d[4i+3])
// of columns 8i + 2t, 8i + 2t + 1.
template <int N, int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  static_assert(N == 8 || N == 64 || N == 80 || N == 128 || N == 256,
                "wgmma_bf16: N");
  if constexpr (N == 8) {
    asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, %7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
  if constexpr (N == 64) {
    asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
  if constexpr (N == 80) {
    asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %42, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, %43, %44;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
  if constexpr (N == 128) {
    asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
  if constexpr (N == 256) {
    asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
}

// The products of one slab of KS k16 steps, d (64 x N) += A B, the
// descriptors advanced a k16 step at a time (kDescStep), issued after
// wgmma_fence and committed as one group; accumulate false starts d from
// zero. The issue and wait pattern of a ring's consumer: after slab it's
// group, wgmma_wait<1> means slab it - 1's products are done, so its stage
// can be released.
template <int KS, int N = 256, int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_slab(float (&d)[N / 2], uint64_t da,
                                           uint64_t db, bool accumulate) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_bf16<N, TA, TB>(d, da + kDescStep<TA> * kk,
                          db + kDescStep<TB> * kk, accumulate || kk > 0);
  wgmma_commit();
}

// ------------------------------------------------ bf16 products on wgmma
// product_bf16_kernel<kMN>: D = A^T B over a long depth (kMN: A (depth x
// M) and B (depth x N) both MN-major in shared memory, the weight
// gradients' reduction over rows) or D = A B^T (K-major: A (M x depth), B
// (N x depth)); bf16 operands by TMA into the 128-byte swizzle, fp32
// accumulation on wgmma m64n256k16. A block a 128 x 256 tile of D (two
// consumer warpgroups of 64 rows, one TMA warp), a ring of 4 stages of 64
// of depth. Both operands come through 3-D tensor maps (bf16_tile_map_3d):
//   kMN: the depth is (w, row) pairs, w outer: stage (w, r0) reads B's
//        rows r0 .. r0 + 63 of block w, and A's rows of block a_slot0 +
//        g * a_slot_g + w, where g is the tile's group of M rows of D (a
//        gathered operand laid out as a row's blocks: x[nbr[p, j]] for
//        every slot j of row p is block j of row p, so that one map serves
//        every tap of a window); boxes of 64 columns x 64 rows, two for A
//        and four for B a stage. The depth splits over gridDim.z in
//        contiguous ranges of stages; split z writes its partial of D to
//        out + z * groups * M * N, which the caller adds in split order
//        (column_reduce): no float atomics, the same bits every run.
//   K-major: one box of 64 columns x 128 rows of A and 64 x 256 of B a
//        stage; D (M, ldo) written directly.
// Rows and columns past an operand's end read as zeros (TMA's fill).
constexpr int kPM = 128;                     // rows of D a tile
constexpr int kPN = 256;                     // columns of D a tile
constexpr int kPK = 64;                      // depth a stage
constexpr int kPStages = 4;
constexpr int kPConsumers = 256;             // two warpgroups
constexpr int kPThreads = kPConsumers + 32;  // and the TMA warp
constexpr int kPABytes = kPM * kPK * 2;      // 16 KB a stage
constexpr int kPBBytes = kPN * kPK * 2;      // 32 KB a stage
constexpr int kPBox = 64 * 64 * 2;           // an MN-major box: 8 KB
constexpr int kPSmemBytes =
    1024 + kPStages * (kPABytes + kPBBytes) + 2 * kPStages * 8;

struct ProductArgs {
  int M;         // rows of D a group
  int groups;    // groups of M rows (kMN; K-major: 1)
  int mtiles;    // kPM tiles a group
  int N;         // columns of D
  int nw;        // kMN: blocks w of B's depth; K-major: 1
  int dblocks;   // stages of depth a w: rows (kMN) or columns over kPK
  int a_slot0;   // kMN: A's block at (g, w) is a_slot0 + g * a_slot_g + w
  int a_slot_g;
  float* out;    // kMN: (gridDim.z, groups * M, N); K-major: (M, ldo)
  int ldo;
  __nv_bfloat16* out_bf16;  // K-major: D rounded to bf16 here, not out
};

template <bool kMN>
__global__ void __launch_bounds__(kPThreads, 1)
product_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    const ProductArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* As = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Bs = As + kPStages * kPABytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + kPStages * kPBBytes);
  const Ring ring{full, full + kPStages, kPStages};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.y / a.mtiles;
  const int m0 = (blockIdx.y - g * a.mtiles) * kPM, n0 = blockIdx.x * kPN;
  const long long S = (long long)a.nw * a.dblocks;
  const int s0 = (int)(S * blockIdx.z / gridDim.z);
  const int s1 = (int)(S * (blockIdx.z + 1) / gridDim.z);
  if (threadIdx.x == 0) {
    ring.init(1, kPConsumers / 32);  // the TMA thread; the consumer warps
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kPConsumers / 32) {
    if (lane == 0)
      for (int s = s0, it = 0; s < s1; ++s, ++it) {
        ring.wait_empty(it);
        uint64_t* bar = ring.full_bar(it);
        uint8_t* as = As + ring.stage(it) * kPABytes;
        uint8_t* bs = Bs + ring.stage(it) * kPBBytes;
        mbar_arrive_tx(bar, kPABytes + kPBBytes);
        if constexpr (kMN) {
          const int w = s / a.dblocks, r0 = (s - w * a.dblocks) * kPK;
          const int slot = a.a_slot0 + g * a.a_slot_g + w;
#pragma unroll
          for (int h = 0; h < kPM / 64; ++h)
            tma_load_3d(as + h * kPBox, &map_a, bar, m0 + 64 * h, slot, r0);
#pragma unroll
          for (int h = 0; h < kPN / 64; ++h)
            tma_load_3d(bs + h * kPBox, &map_b, bar, n0 + 64 * h, w, r0);
        } else {
          tma_load_3d(as, &map_a, bar, s * kPK, 0, m0);
          tma_load_3d(bs, &map_b, bar, s * kPK, 0, n0);
        }
      }
    return;
  }

  // the consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63 of the tile
  const int wg = warp >> 2, gq = lane >> 2, t = lane & 3;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int it = 0;
  for (int s = s0; s < s1; ++s, ++it) {
    ring.wait_full(it);
    const uint8_t* as = As + ring.stage(it) * kPABytes + wg * kPBox;
    const uint8_t* bs = Bs + ring.stage(it) * kPBBytes;
    uint64_t da, db;
    if constexpr (kMN) {
      da = sw128_mn_desc(as, kPBox);
      db = sw128_mn_desc(bs, kPBox);
    } else {
      da = sw128_desc(as);
      db = sw128_desc(bs);
    }
    wgmma_slab<kPK / 16, kPN, kMN, kMN>(acc, da, db, true);
    wgmma_wait<1>();  // the previous stage's products are done: free it
    if (it > 0 && lane == 0) ring.release(it - 1);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // rows m0 + 64 wg + 16 (warp % 4) + gq (+ 8) of columns n0 + 8 i + 2 t
  // (+ 1); N even
  const int r0 = m0 + wg * 64 + (warp & 3) * 16 + gq;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= a.M) continue;
    if (!kMN && a.out_bf16 != nullptr) {
      __nv_bfloat16* o = a.out_bf16 + (size_t)r * a.ldo;
#pragma unroll
      for (int i = 0; i < kPN / 8; ++i) {
        const int c = n0 + 8 * i + 2 * t;
        if (c < a.N)
          *reinterpret_cast<__nv_bfloat162*>(o + c) = __floats2bfloat162_rn(
              acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]);
      }
      continue;
    }
    float* o = kMN ? a.out + ((size_t)blockIdx.z * a.groups * a.M +
                              (size_t)g * a.M + r) * a.N
                   : a.out + (size_t)r * a.ldo;
#pragma unroll
    for (int i = 0; i < kPN / 8; ++i) {
      const int c = n0 + 8 * i + 2 * t;
      if (c < a.N)
        *reinterpret_cast<float2*>(o + c) =
            make_float2(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]);
    }
  }
}

// launch product_bf16_kernel<kMN> over every tile of D, its depth in
// `splits` ranges (kMN only; K-major 1)
template <bool kMN>
inline cudaError_t launch_product_bf16(const CUtensorMap& map_a,
                                       const CUtensorMap& map_b,
                                       const ProductArgs& a, int splits,
                                       cudaStream_t stream) {
  const long long S = (long long)a.nw * a.dblocks;
  if (splits < 1 || splits > S || (!kMN && splits != 1) || a.N % 2)
    return cudaErrorInvalidValue;
  const long long ytiles = (long long)a.groups * a.mtiles;
  if (ytiles > 65535 || splits > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      product_bf16_kernel<kMN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kPSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + kPN - 1) / kPN, (unsigned)ytiles, splits);
  product_bf16_kernel<kMN><<<grid, kPThreads, kPSmemBytes, stream>>>(
      map_a, map_b, a);
  return cudaGetLastError();
}

// --------------------------------------------------- tensor maps (host)
// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against the driver
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A row-major (rows, cols) bf16 matrix, row stride ld elements (ld * 2 a
// multiple of 16, base 16-byte aligned), as boxes of box_rows rows of 64
// columns in the 128-byte swizzle (or of 32 in the 64-byte one: box_cols
// 32, CU_TENSOR_MAP_SWIZZLE_64B); elements outside the matrix read as
// zeros.
inline cudaError_t bf16_tile_map(
    CUtensorMap* map, const void* base, long long rows, long long cols,
    long long ld, int box_rows, int box_cols = 64,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
         dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}


// A 3-D bf16 tensor (d0 innermost, d1, d2) with strides s1, s2 elements
// (each times 2 a multiple of 16, base 16-byte aligned), as boxes of b0 x
// b1 x b2 in the 128-byte swizzle (b0 * 2 <= 128; or, swizzle NONE, dense
// boxes, b0 * 2 a multiple of 16); elements outside the tensor read as
// zeros. A view of rows of (d1, d0) blocks whose boxes are one block deep
// (b1 = 1) reads row r0..r0+b2-1 of block j at (c0, j, r0).
inline cudaError_t bf16_tile_map_3d(
    CUtensorMap* map, const void* base, long long d0, long long d1,
    long long d2, long long s1, long long s2, int b0, int b1, int b2,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1,
                              (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)s1 * 2, (cuuint64_t)s2 * 2};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, (cuuint32_t)b2};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
         dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}


}  // namespace
