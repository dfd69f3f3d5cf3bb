// Hopper (sm_90a) building blocks of kernels 14, 15, 16 (flash attention), 20
// (the weight-only int8 matmul) and the loss head's backward (18, 19 and the
// D recompute they share): warpgroup matrix products (wgmma), their
// shared-memory matrix descriptors, mbarriers, TMA tiled loads and stores and
// the host-side encoding of a tensor map. Each helper notes the PTX it emits.
//
// Layout conventions (the ones the TMA maps in this file produce):
// a "row tile" of R rows and D columns of a 2-byte type is stored as D / 64
// boxes, each [R][64] elements (128 bytes a row), with the 128-byte swizzle:
// the 16-byte chunk c of row r sits at chunk c ^ (r % 8). Every box starts on
// a 1024-byte boundary, so the swizzle atoms (8 rows x 128 bytes) line up
// with the address bits the hardware swizzles on.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda symbol is linked)
#include <type_traits>
#include <utility>

#include "common.cuh"

namespace ptt {
namespace hopper {

// a generic pointer into shared memory as a 32-bit shared address (cvta.to.shared)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarrier -----------------------------------------------------------------

// mbarrier.init.shared::cta.b64: `count` arrivals complete a phase
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// fence.mbarrier_init.release.cluster: initialised barriers visible to the async proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// mbarrier.arrive.shared::cta.b64 (release): one arrival
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// mbarrier.arrive.expect_tx.shared::cta.b64: one arrival, and `bytes` more
// to come from asynchronous copies before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// mbarrier.expect_tx.shared::cta.b64: `bytes` more to come from asynchronous
// copies before the phase completes (no arrival)
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// mbarrier.try_wait.parity.shared::cta.b64 (acquire) until the phase with
// parity `parity` has completed. A wait that lasts 20 s (%globaltimer, read
// every 2^16 polls) can only be a protocol fault: it traps, so the launch
// fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint64_t t0 = 0;
  for (uint32_t polls = 1;; ++polls) {
    uint32_t done = 0;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((polls & 0xFFFFu) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (t0 == 0) {
        t0 = now;
      } else if (now - t0 > 20000000000ull) {
        __trap();
      }
    }
  }
}

// mbar_wait as one asm loop (the same 20 s trap on %globaltimer): a
// consumer that waits for its next stage while its wgmmas are in flight
// must not branch at the C++ level there, or ptxas serialises the wgmmas
// (C7520: a compiler-inserted warpgroup.arrive in a divergent path)
__device__ __forceinline__ void mbar_wait_loop(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"
      "mov.u64 t0, %%globaltimer;\n"
      "WAIT_LOOP:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra WAIT_DONE;\n"
      "mov.u64 t1, %%globaltimer;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, 20000000000;\n"
      "@p trap;\n"
      "bra WAIT_LOOP;\n"
      "WAIT_DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one arrival on `bar` from the threads whose `pred` is non-zero, as a
// predicated instruction (no branch: see mbar_wait_loop)
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, int pred) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
                   smem_u32(bar)),
               "r"(pred)
               : "memory");
}

// setmaxnreg.inc.sync.aligned.u32 N: this warpgroup's registers a thread
// rise to N (taken from what another warpgroup released)
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// setmaxnreg.dec.sync.aligned.u32 N: this warpgroup's registers a thread fall to N
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// -- TMA ----------------------------------------------------------------------

// cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes:
// one box of a 4-d tensor map at coordinates (c0 innermost .. c3) into
// shared memory; its bytes complete on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes:
// one box of a 2-d tensor map at coordinates (c0 innermost, c1) into shared
// memory; its bytes complete on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes: `bytes`
// (a multiple of 16; both addresses 16-byte aligned) from global to shared
// memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// cp.async.cg.shared.global (16 bytes; p and dst 16-byte aligned) and
// cp.async.ca.shared.global (4 bytes): a copy in flight without a register
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

// the same with zero fill: `valid` false copies nothing and writes zeros
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// cp.async.commit_group: this thread's copies issued since the last commit form one group
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// cp.async.wait_group N: at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async.mbarrier.arrive.noinc.shared::cta.b64: one arrival on `bar` once
// every cp.async this thread issued before it has landed (the barrier's
// count includes it: .noinc adds no pending arrival of its own)
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// cp.async.commit_group + cp.async.wait_group 0: this thread's copies landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// cp.async.bulk.tensor.4d.global.shared::cta.bulk_group: one box of shared
// memory (laid out as tma_load_4d leaves it) to a 4-d tensor map at
// coordinates (c0 innermost .. c3); rows past the tensor's end are dropped
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0, int c1, int c2, int c3) {
  asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
               : "memory");
}

// cp.async.bulk.tensor.2d.global.shared::cta.bulk_group: one box of shared
// memory (laid out as tma_load_2d leaves it) to a 2-d tensor map at
// coordinates (c0 innermost, c1); elements past the tensor's edges are dropped
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}

// cp.async.bulk.commit_group: this thread's bulk stores issued so far form one group
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// cp.async.bulk.wait_group.read N: at most N of this thread's bulk store
// groups still read their shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// cp.async.bulk.commit_group + cp.async.bulk.wait_group.read 0: this
// thread's bulk stores have read their shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// cp.async.bulk.wait_group 0: this thread's bulk stores are complete
__device__ __forceinline__ void tma_store_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// fence.proxy.async.shared::cta: this thread's shared-memory writes are
// visible to the async proxy (a TMA store that reads them)
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// bar.sync id, n: a named barrier of n threads (whole warps)
__device__ __forceinline__ void named_barrier(int id, int n) { asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory"); }

// bar.arrive id, n: this warp's arrival at named barrier id of n threads,
// without waiting (its shared-memory writes before it are seen by the
// threads that wait there with bar.sync)
__device__ __forceinline__ void named_barrier_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16: four 8 x 8 matrices of
// 16-bit elements, transposed; lanes 8 i..8 i + 7 give the 16-byte rows of
// matrix i, and lane (gid = lane / 4, tig = lane % 4) gets r[i] = (row
// 2 tig, row 2 tig + 1) of column gid of matrix i, row 2 tig in the low half
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// prefetch.tensormap: bring a __grid_constant__ map's descriptor into the cache
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// -- wgmma ----------------------------------------------------------------------

// wgmma.fence.sync.aligned: register and shared-memory writes before it are
// seen by the warpgroup's next wgmma
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

// wgmma.commit_group.sync.aligned: the wgmmas issued so far form one group
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

// wgmma.wait_group.sync.aligned N: at most N groups still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// no PTX: keeps the compiler from moving reads or writes of accumulator (or
// A-fragment) registers across an asynchronous wgmma
template <typename R, int N>
__device__ __forceinline__ void fence_regs(R (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (std::is_same<R, float>::value) {
      asm volatile("" : "+f"(r[i])::"memory");
    } else {
      asm volatile("" : "+r"(r[i])::"memory");
    }
  }
}

// The shared-memory matrix descriptor of a 128-byte-swizzled operand (bits
// 0-13 start address >> 4, 16-29 leading byte offset >> 4, 32-45 stride
// byte offset >> 4, 62-63 layout 1 = 128-byte swizzle). For a K-major
// operand (the reduction dim contiguous: [rows][64] boxes) the leading
// offset is unused (16) and the stride offset is 1024, the next 8 rows; the
// k16 step j of a box starts 32 j bytes in. For an MN-major operand (the
// output dim contiguous: [k][64] boxes) the leading offset steps to the next
// 64 columns (the next box) and the stride offset, 1024, to the next 8 k.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  uint64_t d = static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

// desc_sw128 of a 32-bit shared address (smem_u32 of the operand)
__device__ __forceinline__ uint64_t desc_sw128_at(uint32_t addr, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

// The operand lists of the three product shapes, written out: d the fp32
// accumulator (m64nN: N / 2 registers a thread, the mma.sync C layout per
// warp: d[4 j + e] is row 16 w + gid + 8 (e >> 1), column 8 j + 2 tig + (e & 1)),
// scale_d 0 to overwrite d, 1 to add to it; TY the input type, bf16 or f16.
// SS: A and B from shared memory (both K-major, trans-a = trans-b = 0).
// RS: A from registers (a[4], the mma.sync m16n8k16 A layout of the warp's
// 16 rows), B from shared memory MN-major (trans-b = 1).

#define PTT_WGMMA_SS_N64(TY)                                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "          \
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "  \
               "%32, %33, p, 1, 1, 0, 0;\n}\n"                               \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])  \
               : "l"(da), "l"(db), "r"(scale_d))

#define PTT_WGMMA_SS_N128(TY)                                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "          \
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
               "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
               "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "  \
               "%64, %65, p, 1, 1, 0, 0;\n}\n"                               \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),  \
                 "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
                 "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
                 "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),  \
                 "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])  \
               : "l"(da), "l"(db), "r"(scale_d))

#define PTT_WGMMA_RS_N64(TY)                                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "          \
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "  \
               "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                 \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])  \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

// SS and RS with each descriptor's start address advanced inside the asm
// by an immediate (kAOff / kBOff bytes, multiples of 16, added to the low
// word: the address field cannot carry past bit 13 within shared memory): a
// chain of k-steps keeps one base descriptor per operand live instead of one
// per step. With warp-uniform bases, ptxas keeps them in uniform registers.
#define PTT_WGMMA_SS_N64_AT(TY)                                                     \
  asm volatile("{\n.reg .pred p;\n.reg .b64 ta, tb;\n.reg .b32 al, ah, bl, bh;\nsetp.ne.b32 p, %34, 0;\n"  \
               "mov.b64 {al, ah}, %32;\nadd.u32 al, al, %35;\nmov.b64 ta, {al, ah};\n"   \
               "mov.b64 {bl, bh}, %33;\nadd.u32 bl, bl, %36;\nmov.b64 tb, {bl, bh};\n"   \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "          \
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "  \
               "ta, tb, p, 1, 1, 0, 0;\n}\n"                                    \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])  \
               : "l"(da), "l"(db), "r"(scale_d), "n"(kAOff >> 4), "n"(kBOff >> 4))

#define PTT_WGMMA_RS_N64_AT(TY)                                                     \
  asm volatile("{\n.reg .pred p;\n.reg .b64 tb;\n.reg .b32 bl, bh;\nsetp.ne.b32 p, %37, 0;\n"      \
               "mov.b64 {bl, bh}, %36;\nadd.u32 bl, bl, %38;\nmov.b64 tb, {bl, bh};\n"   \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "          \
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "  \
               "{%32, %33, %34, %35}, tb, p, 1, 1, 1;\n}\n"                     \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])  \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kBOff >> 4))

// wgmma.mma_async.sync.aligned.m64n64k16.f32.{bf16,f16} (SS) on da + kAOff, db + kBOff: d (+)= A B
template <typename T, int kAOff, int kBOff>
__device__ __forceinline__ void wgmma_ss_n64_at(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  static_assert(kAOff % 16 == 0 && kBOff % 16 == 0, "descriptor addresses step in 16 bytes");
  if constexpr (std::is_same<T, f16>::value) {
    PTT_WGMMA_SS_N64_AT("f16");
  } else {
    PTT_WGMMA_SS_N64_AT("bf16");
  }
}

// wgmma.mma_async.sync.aligned.m64n64k16.f32.{bf16,f16} (RS) on db + kBOff: d (+)= a B
template <typename T, int kBOff>
__device__ __forceinline__ void wgmma_rs_n64_at(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  static_assert(kBOff % 16 == 0, "descriptor addresses step in 16 bytes");
  if constexpr (std::is_same<T, f16>::value) {
    PTT_WGMMA_RS_N64_AT("f16");
  } else {
    PTT_WGMMA_RS_N64_AT("bf16");
  }
}

// wgmma.mma_async.sync.aligned.m64n64k16.f32.{bf16,f16} (SS): d (+)= A B
template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, f16>::value) {
    PTT_WGMMA_SS_N64("f16");
  } else {
    PTT_WGMMA_SS_N64("bf16");
  }
}

// wgmma.mma_async.sync.aligned.m64n128k16.f32.{bf16,f16} (SS): d (+)= A B
template <typename T>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, f16>::value) {
    PTT_WGMMA_SS_N128("f16");
  } else {
    PTT_WGMMA_SS_N128("bf16");
  }
}

// wgmma.mma_async.sync.aligned.m64n64k16.f32.{bf16,f16} (RS): d (+)= a B
template <typename T>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, f16>::value) {
    PTT_WGMMA_RS_N64("f16");
  } else {
    PTT_WGMMA_RS_N64("bf16");
  }
}

// RS with a K-major B (trans-b = 0: B's reduction dim contiguous, [n][64]
// boxes, as a TMA row tile lies), for the N widths of kernel 20's x tile:
// A = a[4] from registers (the m16n8k16 A layout per warp), d m64nN.
#define PTT_WGMMA_RS_K_N8(TY)  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"  \
               "wgmma.mma_async.sync.aligned.m64n8k16.f32." TY "." TY " "  \
               "{%0, %1, %2, %3}, "  \
               "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"  \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])  \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define PTT_WGMMA_RS_K_N64(TY)  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"  \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "  \
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "  \
               "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"  \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])  \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define PTT_WGMMA_RS_K_N128(TY)  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"  \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "  \
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
               "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
               "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "  \
               "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"  \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),  \
                 "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
                 "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
                 "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),  \
                 "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])  \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define PTT_WGMMA_RS_K_N256(TY)  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"  \
               "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "  \
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
               "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
               "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "  \
               "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "  \
               "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "  \
               "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "  \
               "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "  \
               "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"  \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),  \
                 "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
                 "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
                 "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),  \
                 "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),  \
                 "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),  \
                 "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),  \
                 "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),  \
                 "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),  \
                 "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),  \
                 "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),  \
                 "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),  \
                 "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])  \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

// wgmma.mma_async.sync.aligned.m64nNk16.f32.{bf16,f16} (RS, B K-major), N 8, 64, 128 or 256: d (+)= a B
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs_k(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  static_assert(N == 8 || N == 64 || N == 128 || N == 256, "kernel 20's x tiles are 8, 64, 128 or 256 rows");
  if constexpr (std::is_same<T, f16>::value) {
    if constexpr (N == 8) {
      PTT_WGMMA_RS_K_N8("f16");
    } else if constexpr (N == 64) {
      PTT_WGMMA_RS_K_N64("f16");
    } else if constexpr (N == 128) {
      PTT_WGMMA_RS_K_N128("f16");
    } else {
      PTT_WGMMA_RS_K_N256("f16");
    }
  } else {
    if constexpr (N == 8) {
      PTT_WGMMA_RS_K_N8("bf16");
    } else if constexpr (N == 64) {
      PTT_WGMMA_RS_K_N64("bf16");
    } else if constexpr (N == 128) {
      PTT_WGMMA_RS_K_N128("bf16");
    } else {
      PTT_WGMMA_RS_K_N256("bf16");
    }
  }
}

// S (+)= A B for an m64 x N tile: one m64nNk16 for N 64 or 128
template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128, "the SS products of the flash kernels are n64 or n128");
  if constexpr (N == 128) {
    wgmma_ss_n128<T>(d, da, db, scale_d);
  } else {
    wgmma_ss_n64<T>(d, da, db, scale_d);
  }
}

// SS with either operand's layout, for the loss head's products (kernels
// 17-19), whose operands lie K-major or MN-major in device memory: TA / TB
// 0 for a K-major operand ([rows][64] boxes), 1 for an MN-major one ([k][64]
// boxes read with imm-trans-a / imm-trans-b, which bf16 and fp16 allow).
// An MN-major operand's descriptor takes the leading offset to the next 64
// columns (the next box) and the stride offset 1024 (the next 8 k); its k16
// step is 2048 bytes, a K-major operand's 32.
#define PTT_WGMMA_SS_T_N128(TY)  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"  \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "  \
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
               "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
               "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "  \
               "%64, %65, p, 1, 1, %67, %68;\n}\n"  \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),  \
                 "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
                 "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
                 "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),  \
                 "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])  \
               : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))

#define PTT_WGMMA_SS_T_N256(TY)  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"  \
               "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "  \
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
               "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
               "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "  \
               "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "  \
               "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "  \
               "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "  \
               "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "  \
               "%128, %129, p, 1, 1, %131, %132;\n}\n"  \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),  \
                 "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
                 "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
                 "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),  \
                 "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),  \
                 "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),  \
                 "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),  \
                 "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),  \
                 "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),  \
                 "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),  \
                 "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),  \
                 "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),  \
                 "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])  \
               : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))

// wgmma.mma_async.sync.aligned.m64nNk16.f32.{bf16,f16} (SS), N 128 or 256,
// A MN-major if TA, B MN-major if TB: d[0, N / 2) (+)= A B (an n128
// product takes the first half of an n256 tile's accumulators)
template <typename T, int N, int TA, int TB, int R>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[R], uint64_t da, uint64_t db, int scale_d) {
  static_assert((N == 128 || N == 256) && R >= N / 2, "the loss head's tiles are n128 or n256");
  if constexpr (std::is_same<T, f16>::value) {
    if constexpr (N == 256) {
      PTT_WGMMA_SS_T_N256("f16");
    } else {
      PTT_WGMMA_SS_T_N128("f16");
    }
  } else {
    if constexpr (N == 256) {
      PTT_WGMMA_SS_T_N256("bf16");
    } else {
      PTT_WGMMA_SS_T_N128("bf16");
    }
  }
}

// wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 (SS): d (+)= A B, the
// tensor core reading each fp32 operand as TF32 (its top 19 bits). TF32 takes
// no transpose: both operands lie K-major, [rows][32] fp32 boxes of 128
// bytes a row with the 128-byte swizzle (desc_sw128 with the K-major
// offsets), and a k8 step is 32 bytes into the row, as a k16 step of a
// 2-byte type is. The loss head's fp32 backward (flxent_tf32.cu) runs it.
#define PTT_WGMMA_TF32_N128  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"  \
               "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "  \
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
               "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
               "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "  \
               "%64, %65, p, 1, 1;\n}\n"  \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),  \
                 "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
                 "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
                 "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),  \
                 "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])  \
               : "l"(da), "l"(db), "r"(scale_d))

__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  PTT_WGMMA_TF32_N128;
}

// (lo, hi) rounded to T (bf16 or fp16) in one 32-bit register, lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, f16>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// ex2.approx.ftz.f32: 2^x (2^-inf = +0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -- host ---------------------------------------------------------------------

// A warp-specialised kernel's setmaxnreg split must fit in the registers its
// launch holds (numRegs for each of `threads`), or the consumers' increase
// waits for ever: refuse the launch instead. Returns a cudaError_t.
template <typename Kernel>
int check_reg_split(Kernel kernel, int threads, int split_regs) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  return fa.numRegs * threads >= split_regs ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

// A persistent grid's longest CTA: the cost of its items when items [0, big)
// cost c_big and the rest c_small, CTA b taking items b, b + grid, ... (the
// tile plans of kernel 20 and of the loss head's backward weigh splitting
// their last partial round by it).
inline long long plan_makespan(int big, int items, int grid, int c_big, int c_small) {
  long long worst = 0;
  for (int b = 0; b < grid && b < items; ++b) {
    const long long nb = b < big ? (big - 1 - b) / grid + 1 : 0;
    const long long all = (items - 1 - b) / grid + 1;
    const long long c = nb * c_big + (all - nb) * c_small;
    worst = c > worst ? c : worst;
  }
  return worst;
}

// The current device's SM count (a persistent grid's size), cached per
// device. Returns a cudaError_t.
inline int sm_count(int* sms) {
  static int cache[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && cache[dev]) return *sms = cache[dev], 0;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) cache[dev] = *sms;
  return static_cast<int>(err);
}

// -- host: tensor maps ----------------------------------------------------------

// cuTensorMapEncodeTiled's signature (libcuda, CUDA 12)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled through the runtime's entry-point query,
// so that the library needs no -lcuda; null if libcuda lacks it.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

template <typename T>
constexpr CUtensorMapDataType tma_dtype() {
  return std::is_same<T, f16>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// The map of a contiguous [B, S, Hx, D] tensor of 2-byte T read as row
// tiles of one (batch, head): boxes of `rows` rows x 64 columns, 128-byte
// swizzle, coordinates (column, head, row, batch); rows past S read as 0.
// Returns a cudaError_t.
template <typename T>
int encode_row_tiles(CUtensorMap* map, const void* base, int B, int S, int Hx, int D, int rows) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t e = sizeof(T);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(Hx), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {D * e, static_cast<cuuint64_t>(Hx) * D * e,
                                 static_cast<cuuint64_t>(S) * Hx * D * e};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / e), 1u, static_cast<cuuint32_t>(rows), 1u};
  const cuuint32_t elem_strides[4] = {1u, 1u, 1u, 1u};
  const CUresult r = fn(map, tma_dtype<T>(), 4, const_cast<void*>(base), dims, strides, box, elem_strides,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The map of a row-major [rows, cols] matrix (`row_bytes` apart, a multiple
// of 16; base 16-byte aligned) of `type` read in boxes of `box_rows` rows x
// `box_cols` columns of 128 bytes (the 128-byte swizzle, as row tiles lie);
// coordinates (column, row), and elements past either edge read as 0.
// Returns a cudaError_t.
inline int encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rows, int cols,
                     long long row_bytes, int box_rows, int box_cols) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1u, 1u};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace hopper
}  // namespace ptt
