// Hopper (sm_90a) building blocks shared by the flash-attention, fused-logprob
// and W8A16 kernels: mbarriers, TMA tile loads (4-D maps over [b, T, h, d]
// views, 2-D maps over matrices), named barriers, thread-block cluster
// barriers and distributed shared-memory reads, wgmma shared-memory
// descriptors and the wgmma products in the operand forms the kernels use
// (bf16, and TF32 for the fused head's f32 mode), and the host-side
// tensor-map encoders.
//
// Shared-memory tiles are TMA boxes of 64 bf16 columns (128 bytes, the
// 128-byte swizzle's span) by `rows` rows; a [rows, d] tile is d / 64 such
// boxes one after another (d rounded up to a whole box: at d = 96 the second
// box's columns 96-127 are TMA's zero fill), each rows * 128 bytes, every
// base 1024-aligned (the swizzle pattern repeats every 8 rows of 128 bytes).
// One tile can be read both ways:
// - K-major (the reduction runs along the 64 columns): start at the box of
//   column 16 kk, plus (kk % 4) * 32 bytes, leading offset unused, stride
//   1024 (8 rows);
// - MN-major (the reduction runs along the rows): start 16 kk rows into the
//   box of the output columns (kk * 2048 bytes), leading offset one box,
//   stride 1024 (8 reduction rows).
// The head-dim-96 flash kernels store a [rows, 96] tile as three boxes of 32
// columns (64 bytes, the 64-byte swizzle's span), each rows * 64 bytes and
// 1024-aligned, read through descriptors of the 64-byte swizzle
// (make_desc64): K-major from the box of column 16 kk plus (kk % 2) * 32
// bytes, stride 512 (8 rows of 64 bytes); MN-major 16 kk rows in (kk * 1024
// bytes), leading offset one box, stride 512, so an N = 96 product reads the
// three boxes and no padding.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- shared memory, mbarriers, TMA -------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared-memory base rounded up to 1024 bytes.
__device__ __forceinline__ unsigned char* align_1024(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box {64 columns, rows} of a 4-D map (d, t, h, b) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box {64 columns, rows} of a 2-D map (inner, outer) into shared memory.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Named barriers (id 0 is __syncthreads): `arrive` marks this thread's
// arrival and goes on, `sync` waits until `threads` have arrived.
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- thread-block clusters ---------------------------------------------------
// Every thread of every CTA of the cluster arrives (release) and waits
// (acquire): shared-memory writes before it are visible cluster-wide after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Four f32 at shared address `addr` of the cluster's CTA `rank`.
__device__ __forceinline__ float4 dsmem_ld4(uint32_t addr, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// ---- wgmma -------------------------------------------------------------------
// Shared-memory descriptor, 128-byte swizzle. Byte offsets: lbo is the
// stride between 64-element blocks along M/N (MN-major only), sbo the stride
// between groups of 8 rows (K-major) or 8 K-rows (MN-major).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

// The same descriptor for tiles stored with the 64-byte swizzle (rows of 64
// bytes; the pattern repeats every 8 rows, 512 bytes).
__device__ __forceinline__ uint64_t make_desc64(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)2 << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// Wait until at most one (two) committed batches are still in flight.
__device__ __forceinline__ void wgmma_wait1() { asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait2() { asm volatile("wgmma.wait_group.sync.aligned 2;\n" ::: "memory"); }

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma (its results are valid only after the wait).
template <int N = 32>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The same for the bf16 A fragments of a register-A wgmma: they must stay in
// their registers until the wait that ends the product.
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define TRLX_ACC16                                                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),  \
      "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define TRLX_REGS16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define TRLX_ACC32                                                                                             \
  TRLX_ACC16, "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]),       \
      "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),  \
      "+f"(d[31])
#define TRLX_REGS32                                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

#define TRLX_F4(o) "+f"(d[(o)]), "+f"(d[(o) + 1]), "+f"(d[(o) + 2]), "+f"(d[(o) + 3])
#define TRLX_F16(o) TRLX_F4(o), TRLX_F4((o) + 4), TRLX_F4((o) + 8), TRLX_F4((o) + 12)
#define TRLX_F64(o) TRLX_F16(o), TRLX_F16((o) + 16), TRLX_F16((o) + 32), TRLX_F16((o) + 48)
#define TRLX_ACC128 TRLX_F64(0), TRLX_F64(64)
#define TRLX_REGS128 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127" \
  "}"

// d[64 x 256] (+)= A[64 x 16] . B[16 x 256], both from shared memory, A
// K-major (TRANS_A = 0) or MN-major (TRANS_A = 1, bf16 allows it), B
// K-major (TRANS_B = 0) or MN-major (TRANS_B = 1). 128 accumulator
// registers a thread, in the layout of four m64n64 tiles side by side:
// d[4 j + e] is row 16 warp + g (+ 8 for e >= 2), column 8 j + 2 t +
// (e & 1), for lane = 4 g + t.
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n256(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " TRLX_REGS128 ", %128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : TRLX_ACC128
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_A), "n"(TRANS_B));
}

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TRLX_REGS32 ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : TRLX_ACC32
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 32] (+)= A[64 x 16] . B[16 x 32], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " TRLX_REGS16 ", %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : TRLX_ACC16
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x N] (+)= A . B for N = 32 or 64 (N / 2 accumulator registers a thread).
template <int N>
__device__ __forceinline__ void wgmma_ss_n(float* d, uint64_t da, uint64_t db, int accumulate) {
  static_assert(N == 32 || N == 64, "wgmma_ss_n: N is 32 or 64");
  if constexpr (N == 64)
    wgmma_ss(d, da, db, accumulate);
  else
    wgmma_ss_n32(d, da, db, accumulate);
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], A from registers (bf16 pairs in the
// mma.sync A-fragment layout), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TRLX_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : TRLX_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#define TRLX_ACC64 TRLX_F64(0)
#define TRLX_REGS64 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
  "}"

// d[64 x 128] (+)= A[64 x 16] . B[16 x 128], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TRLX_REGS64 ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : TRLX_ACC64
      : "l"(da), "l"(db), "r"(accumulate));
}

#define TRLX_ACC48 TRLX_F16(0), TRLX_F16(16), TRLX_F16(32)
#define TRLX_REGS48 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47" \
  "}"

// d[64 x 96] += A[64 x 16] . B[16 x 96], A from registers (bf16 pairs in the
// mma.sync A-fragment layout), B MN-major in shared memory: 48 accumulator
// registers a thread, d[4 j + e] at column 8 j + 2 t + (e & 1).
__device__ __forceinline__ void wgmma_rs_n96(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 " TRLX_REGS48 ", {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n"
      "}\n"
      : TRLX_ACC48
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x N] += A[64 x 16] . B[16 x N] for N = 8, 32, 64, 128 or 256 (N / 2
// accumulator registers a thread), A from registers (bf16 pairs in the
// mma.sync A-fragment layout), B K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs_kb(float* d, const uint32_t* a, uint64_t db) {
  static_assert(N == 8 || N == 32 || N == 64 || N == 128 || N == 256, "wgmma_rs_kb: N is 8, 32, 64, 128 or 256");
  if constexpr (N == 8) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
        "}\n"
        : TRLX_F4(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " TRLX_REGS16 ", {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
        "}\n"
        : TRLX_ACC16
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TRLX_REGS32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
        "}\n"
        : TRLX_ACC32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TRLX_REGS64 ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
        "}\n"
        : TRLX_ACC64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " TRLX_REGS128
        ", {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
        "}\n"
        : TRLX_ACC128
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

// d[64 x 128] (+)= A[64 x 8] . B[8 x 128] in TF32, A from registers (the
// warp's 16 rows: a[0] row g, column t; a[1] row g + 8, column t; a[2] row
// g, column t + 4; a[3] row g + 8, column t + 4, for lane = 4 g + t), B
// K-major in shared memory (TF32 has no transposed form). The tensor core
// reads the top 19 bits of each operand word.
__device__ __forceinline__ void wgmma_tf32_rs_n128(float* d, const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " TRLX_REGS64 ", {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : TRLX_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// Orders this thread's generic-proxy writes to shared memory before the
// async proxy's reads (wgmma through descriptors) that follow a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- host side: tensor maps --------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (no -lcuda).
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-D map (d, t, h, b) over a strided [b, T, h, d] bf16 view (element
// strides st, sh, sb); boxes of BOX_COLS columns by `rows` rows, zero fill
// past T: 64 columns at the 128-byte swizzle, or 32 (head dim 96) at the
// 64-byte swizzle.
template <int BOX_COLS = 64>
inline bool make_map(CUtensorMap* map, const void* base, int d, int T, int h, int b, int st, int sh, int sb,
                     int rows) {
  static_assert(BOX_COLS == 64 || BOX_COLS == 32, "make_map: boxes of 64 or 32 columns");
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)T, (cuuint64_t)h, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)st * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)BOX_COLS, (cuuint32_t)rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, BOX_COLS == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 2-D map over a row-major matrix [outer, inner] of ELEM_BYTES-wide
// elements (1: int8, 2: bf16, 4: f32) with a row stride of `ld` elements (a
// 16-byte multiple); boxes of BOX_BYTES bytes of columns (128: 128 int8, 64
// bf16 or 32 f32, the 128-byte swizzle's span; 64: the 64-byte swizzle's) by
// `rows` rows, swizzled at that span, zero fill past `inner` and `outer`.
template <int ELEM_BYTES = 2, int BOX_BYTES = 128>
inline bool make_map_2d(CUtensorMap* map, const void* base, int inner, int outer, long long ld, int rows) {
  static_assert(ELEM_BYTES == 1 || ELEM_BYTES == 2 || ELEM_BYTES == 4, "make_map_2d: int8, bf16 or f32");
  static_assert(BOX_BYTES == 64 || BOX_BYTES == 128, "make_map_2d: 64- or 128-byte boxes");
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * ELEM_BYTES};
  const cuuint32_t box[2] = {BOX_BYTES / ELEM_BYTES, (cuuint32_t)rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUtensorMapDataType type = ELEM_BYTES == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : ELEM_BYTES == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                     : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  return enc(map, type, 2, const_cast<void*>(base), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             BOX_BYTES == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
