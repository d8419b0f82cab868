// The GEMM mainloop of the fused-logprob kernels for Hopper (sm_90a): a
// warp-specialised walk that computes 128 x 256 f32 tiles of A . B by TMA
// and wgmma, and hands each finished tile to the caller's epilogue.
//
// Layout (384 threads, one CTA per SM, as the flash kernels):
// - warpgroup 0 is the producer: it gives its registers away (setmaxnreg 24)
//   and one thread issues the TMA boxes of every reduction chunk into a
//   GEMM_STAGES-deep ring of shared-memory stages (an A box of 128 rows x 64
//   reduction columns and a B tile of 256 columns x 64 reduction rows, 48 KB
//   a stage, 128-byte swizzle), guarded by a full and an empty mbarrier per
//   stage. Loads run up to GEMM_STAGES chunks ahead of the products, across
//   tile boundaries too, so a tile's epilogue overlaps the next tile's loads.
// - warpgroups 1 and 2 consume (setmaxnreg 240), each accumulating 64 rows
//   of the tile (128 f32 registers a thread) by wgmma m64n256k16 with both
//   operands read from shared memory through descriptors. A chunk's batch of
//   four products is committed and left in flight while the next chunk's
//   batch is issued (wait_group 1); only then is the older chunk's stage
//   freed.
//
// Operand forms: A is K-major when the matrix that holds it is [output row,
// reduction] in memory (one box of 128 rows x 64 reduction columns), MN-major
// when it is [reduction, output row] (two boxes of 64 rows side by side, one
// per consumer warpgroup, read through the transposed descriptor). B is
// K-major when its matrix is [output column, reduction] (one box of 256
// rows), MN-major when it is [reduction, output column] (four boxes of 64
// columns side by side, read through the transposed descriptor). Past the
// matrices' edges TMA fills zeros, so ragged rows, columns and reductions
// add nothing.

#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int GEMM_BM = 128;  // output rows per CTA: two consumer warpgroups of 64
constexpr int GEMM_BN = 256;  // output columns per tile: one wgmma N
constexpr int GEMM_BK = 64;   // reduction chunk: one 128-byte swizzle box
constexpr int GEMM_STAGES = 4;
constexpr int GEMM_THREADS = 384;
constexpr int GEMM_NACC = GEMM_BN / 2;                  // f32 accumulators a consumer thread
constexpr int GEMM_A_BYTES = GEMM_BM * GEMM_BK * 2;     // 16 KB
constexpr int GEMM_MN_BOX = 64 * GEMM_BK * 2;           // one MN-major box (A or B), 8 KB
constexpr int GEMM_B_BYTES = GEMM_BN * GEMM_BK * 2;     // 32 KB
constexpr int GEMM_STAGE_BYTES = GEMM_A_BYTES + GEMM_B_BYTES;
constexpr int GEMM_RING_BYTES = GEMM_STAGES * GEMM_STAGE_BYTES;
constexpr int GEMM_SMEM_BYTES = GEMM_RING_BYTES + 16 * GEMM_STAGES;  // stages, then full[] and empty[]

struct GemmRing {
  uint32_t base;  // shared address of stage 0, 1024-aligned

  __device__ __forceinline__ uint32_t a(int s) const { return base + s * GEMM_STAGE_BYTES; }
  __device__ __forceinline__ uint32_t b(int s) const { return a(s) + GEMM_A_BYTES; }
  __device__ __forceinline__ uint32_t full(int s) const { return base + GEMM_RING_BYTES + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return base + GEMM_RING_BYTES + 8 * (GEMM_STAGES + s); }

  // By one thread, before the CTA's first __syncthreads.
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < GEMM_STAGES; ++s) {
      mbar_init(full(s), 1);          // the producer's expect_tx
      mbar_init(empty(s), 2 * 128);   // every consumer thread
    }
    mbar_init_fence();
  }
};

// Producer (one thread): every reduction chunk's A and B boxes of the
// output tile at (m0, n0). `ta` maps A as (reduction, row) when A_KMAJOR,
// else as (row, reduction); `tb` maps B as (reduction, column) when
// B_KMAJOR, else as (column, reduction). `it` counts the chunks issued.
template <bool B_KMAJOR, bool A_KMAJOR = true>
__device__ __forceinline__ void gemm_produce_tile(const GemmRing& r, const CUtensorMap* ta, const CUtensorMap* tb,
                                                  int m0, int n0, int nk, uint32_t& it) {
  for (int kc = 0; kc < nk; ++kc, ++it) {
    const int s = it % GEMM_STAGES, k0 = kc * GEMM_BK;
    mbar_wait(r.empty(s), ((it / GEMM_STAGES) & 1) ^ 1);
    // Boxes that reach past an edge still count their full bytes.
    mbar_expect_tx(r.full(s), GEMM_STAGE_BYTES);
    if (A_KMAJOR) {
      tma_load_2d(r.a(s), ta, r.full(s), k0, m0);
    } else {
#pragma unroll
      for (int j = 0; j < GEMM_BM / 64; ++j) tma_load_2d(r.a(s) + j * GEMM_MN_BOX, ta, r.full(s), m0 + 64 * j, k0);
    }
    if (B_KMAJOR) {
      tma_load_2d(r.b(s), tb, r.full(s), k0, n0);
    } else {
#pragma unroll
      for (int j = 0; j < GEMM_BN / 64; ++j) tma_load_2d(r.b(s) + j * GEMM_MN_BOX, tb, r.full(s), n0 + 64 * j, k0);
    }
  }
}

// Producer (one thread): the output tiles n_lo .. n_hi - 1 of the CTA's
// row block m0, A K-major.
template <bool B_KMAJOR>
__device__ __forceinline__ void gemm_produce(const GemmRing& r, const CUtensorMap* ta, const CUtensorMap* tb, int m0,
                                             int n_lo, int n_hi, int nk) {
  uint32_t it = 0;
  for (int nt = n_lo; nt < n_hi; ++nt) gemm_produce_tile<B_KMAJOR>(r, ta, tb, m0, nt * GEMM_BN, nk, it);
}

// Consumer warpgroup cw (0 or 1): acc = rows 64 cw .. 64 cw + 63 of the
// next tile, summed over its nk chunks. `it` counts the chunks this
// warpgroup has taken from the ring (the producer's order).
template <bool B_KMAJOR, bool A_KMAJOR = true>
__device__ __forceinline__ void gemm_tile(const GemmRing& r, float (&acc)[GEMM_NACC], int cw, int nk, uint32_t& it) {
  int prev = -1;
  for (int kc = 0; kc < nk; ++kc, ++it) {
    const int s = it % GEMM_STAGES;
    mbar_wait(r.full(s), (it / GEMM_STAGES) & 1);
    fence_regs<GEMM_NACC>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GEMM_BK / 16; ++kk) {
      // K-major: 16 columns of the 128-byte rows (A: this warpgroup's 64
      // rows of the box). MN-major: 16 reduction rows down (A: this
      // warpgroup's box; B: the next 64 columns one box on).
      const uint64_t da = A_KMAJOR ? make_desc(r.a(s) + cw * 64 * 128 + kk * 32, 16, 1024)
                                   : make_desc(r.a(s) + cw * GEMM_MN_BOX + kk * 16 * 128, GEMM_MN_BOX, 1024);
      const uint64_t db = B_KMAJOR ? make_desc(r.b(s) + kk * 32, 16, 1024)
                                   : make_desc(r.b(s) + kk * 16 * 128, GEMM_MN_BOX, 1024);
      wgmma_ss_n256<A_KMAJOR ? 0 : 1, B_KMAJOR ? 0 : 1>(acc, da, db, kc > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait1();  // the previous chunk's batch is done: its stage is free
    fence_regs<GEMM_NACC>(acc);
    if (prev >= 0) mbar_arrive(r.empty(prev));
    prev = s;
  }
  wgmma_wait0();
  fence_regs<GEMM_NACC>(acc);
  mbar_arrive(r.empty(prev));
}

template <typename Kernel>
cudaError_t set_gemm_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace
