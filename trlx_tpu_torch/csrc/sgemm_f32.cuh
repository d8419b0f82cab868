// The f32 GEMM mainloop of the fused-logprob kernels' f32-activation mode,
// for Hopper (sm_90a): a register-tiled SIMT SGEMM on the CUDA cores that
// computes a 128 x 128 f32 tile of A . B with f32 products and f32 sums and
// leaves it in registers for the caller's epilogue.
//
// The TPU kernels compute in the activation's dtype (the weight tile is cast
// to x's dtype, trlx_tpu/ops/fused_logprob.py:109, :219, :258), so f32
// activations (ILQL's Q heads) take f32 products. A single TF32 pass keeps
// ~1e-3 of relative error, so the tensor cores are not used here.
//
// Layout: 256 threads; thread (ty, tx) = (tid / 16, tid % 16) holds the
// 8 x 8 outputs at rows sg_row(ty, 0..7) and columns sg_col(tx, 0..7): two
// runs of 4 rows (4 ty, 64 + 4 ty) and of 4 columns (4 tx, 64 + 4 tx), so
// every shared-memory read is a float4 and the threads of a half-warp share
// their A values. The reduction walks chunks of SG_BK = 16: each chunk's A
// and B tiles are loaded from global memory into registers (float4 where the
// rows allow it, scalars at ragged edges, zeros past them) while the previous
// chunk is multiplied, then stored into the other of two shared-memory
// stages as [k][m] and [k][n] (an operand whose rows run along the reduction
// is transposed on that store), one barrier a chunk.
//
// An operand is K-major when its matrix is stored [m or n][k] (the reduction
// contiguous), MN-major when it is stored [k][m or n].
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SG_BM = 128;  // output rows of a tile
constexpr int SG_BN = 128;  // output columns of a tile
constexpr int SG_BK = 16;   // reduction chunk
constexpr int SG_THREADS = 256;
constexpr int SG_LD = SG_BM + 4;  // shared row pitch of a [k][m] stage (pad against bank conflicts)

// One operand in device memory: `rows` x `cols` f32 with row stride `ld`
// (elements). `vec` says every row starts 16-byte aligned (ld % 4 == 0 and
// an aligned base), so 4 consecutive in-bounds elements load as a float4.
struct SgOperand {
  const float* p;
  long long ld;
  int rows, cols, vec;
};

// Max and sum over the 16 threads of a half-warp: the threads that hold
// the same rows of the tile.
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

inline bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

__device__ __forceinline__ int sg_row(int ty, int i) { return (i < 4 ? 4 * ty : 64 + 4 * ty) + (i & 3); }
__device__ __forceinline__ int sg_col(int tx, int j) { return (j < 4 ? 4 * tx : 64 + 4 * tx) + (j & 3); }

// Four consecutive elements of row r, columns c .. c + 3, zero past the edges.
__device__ __forceinline__ float4 sg_load4(const SgOperand& o, int r, int c) {
  if (r >= o.rows) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* row = o.p + (long long)r * o.ld;
  if (o.vec && c + 3 < o.cols) return __ldg(reinterpret_cast<const float4*>(row + c));
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = c + e < o.cols ? __ldg(row + c + e) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// This thread's two float4 of the 128 x 16 tile of operand `o` whose output
// rows (or columns) start at `mn0` and whose reduction starts at `k0`.
// K-major: float4 f covers row mn0 + f / 4, reduction k0 + 4 (f % 4) .. +3;
// MN-major: reduction row k0 + f / 32, columns mn0 + 4 (f % 32) .. +3.
template <bool KMAJOR>
__device__ __forceinline__ void sg_fetch(const SgOperand& o, int mn0, int k0, int tid, float4 (&r)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = tid + h * SG_THREADS;
    r[h] = KMAJOR ? sg_load4(o, mn0 + f / 4, k0 + 4 * (f % 4)) : sg_load4(o, k0 + f / 32, mn0 + 4 * (f % 32));
  }
}

// Store the fetched float4s into a [k][mn] stage.
template <bool KMAJOR>
__device__ __forceinline__ void sg_stash(float* s, int tid, const float4 (&r)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = tid + h * SG_THREADS;
    if (KMAJOR) {
      const int mn = f / 4, k = 4 * (f % 4);
      s[(k + 0) * SG_LD + mn] = r[h].x;
      s[(k + 1) * SG_LD + mn] = r[h].y;
      s[(k + 2) * SG_LD + mn] = r[h].z;
      s[(k + 3) * SG_LD + mn] = r[h].w;
    } else {
      *reinterpret_cast<float4*>(s + (f / 32) * SG_LD + 4 * (f % 32)) = r[h];
    }
  }
}

// Shared memory of the mainloop: two stages of A and B, [k][m] and [k][n].
struct SgSmem {
  float a[2][SG_BK * SG_LD];
  float b[2][SG_BK * SG_LD];
};

// acc = the 128 x 128 tile at output rows m0.., columns n0.. of A . B over
// the reduction [0, K). Every thread of the block calls it; it begins and
// ends with the stages free (a barrier after the last chunk).
template <bool A_KMAJOR, bool B_KMAJOR>
__device__ __forceinline__ void sgemm_tile(SgSmem& sm, const SgOperand& A, const SgOperand& B, int m0, int n0, int K,
                                           float (&acc)[8][8]) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int nk = (K + SG_BK - 1) / SG_BK;
  float4 ra[2], rb[2];
  sg_fetch<A_KMAJOR>(A, m0, 0, tid, ra);
  sg_fetch<B_KMAJOR>(B, n0, 0, tid, rb);
  sg_stash<A_KMAJOR>(sm.a[0], tid, ra);
  sg_stash<B_KMAJOR>(sm.b[0], tid, rb);
  __syncthreads();
  for (int kc = 0; kc < nk; ++kc) {
    const int s = kc & 1;
    const bool more = kc + 1 < nk;
    if (more) {
      sg_fetch<A_KMAJOR>(A, m0, (kc + 1) * SG_BK, tid, ra);
      sg_fetch<B_KMAJOR>(B, n0, (kc + 1) * SG_BK, tid, rb);
    }
    const float* as = sm.a[s];
    const float* bs = sm.b[s];
#pragma unroll
    for (int k = 0; k < SG_BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * SG_LD + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(as + k * SG_LD + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + k * SG_LD + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + k * SG_LD + 64 + 4 * tx);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      sg_stash<A_KMAJOR>(sm.a[s ^ 1], tid, ra);
      sg_stash<B_KMAJOR>(sm.b[s ^ 1], tid, rb);
    }
    __syncthreads();
  }
}

}  // namespace
