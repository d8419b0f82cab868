// Shared helpers for the port's Hopper kernels: the bf16 tensor-core MMA
// (mma.sync m16n8k16, f32 accumulate), bf16 packing, and the masking
// constants of the JAX kernels (trlx_tpu/ops/flash_attention.py:42-44).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

// Running-max init: finite, so a row whose every key is masked degrades to
// uniform weights exactly like the -1e9 additive bias of the einsum path.
#define TRLX_M_INIT (-1e30f)
// Masked scores are REPLACED by this value (not biased).
#define TRLX_MASK_VAL (-1e9f)
// A flash row whose walk reached no key by position has lse = TRLX_M_INIT;
// the backward kernels give such a row p = 0 on every tile (below this).
#define TRLX_DEAD_LSE (-1e29f)

// floor(a / b) for b > 0 and any sign of a (C's division truncates).
__host__ __device__ __forceinline__ int floor_div(int a, int b) { return a >= 0 ? a / b : -((b - 1 - a) / b); }

// The head dims the flash kernels are instantiated for (ops/flash_attention.py
// KERNEL_HEAD_DIMS); the C entries refuse every other d.
__host__ __device__ constexpr bool flash_head_dim_ok(int d) { return d == 64 || d == 96 || d == 128 || d == 256; }

// 64-column (128-byte) TMA boxes a row of d bf16 takes in shared memory: d
// rounded up to a whole box (d = 96: two boxes, columns 96-127 zero-filled).
__host__ __device__ constexpr int box_chunks(int d) { return (d + 63) / 64; }

// The flash kernels' position rule, shared by the forward, dq and dk/dv (the
// JAX kernels' _masked_scores): a key at position kpos of the query frame
// (its index plus the block's offset) is reachable from query row `row`
// under causality when kpos <= row, and within a window when
// kpos > row - window. Each thread turns it into bounds once, so the mask of
// a score is two compares:
// - the key indices a query row reaches, [lo, hi] within [0, T) (empty when
//   lo > hi: the row reaches no key);
__device__ __forceinline__ int2 flash_key_span(int row, int T, int causal, int window, int offset) {
  return make_int2(window > 0 ? max(0, row - window + 1 - offset) : 0, causal ? min(T - 1, row - offset) : T - 1);
}
// - the query rows that reach a key index, [lo, hi].
__device__ __forceinline__ int2 flash_query_span(int key, int causal, int window, int offset) {
  return make_int2(causal ? key + offset : INT_MIN, window > 0 ? key + offset + window - 1 : INT_MAX);
}

// Some pair of rows [r0, r1] and key positions [k0, k1] is reachable (the
// JAX kernels' _run_if_live): the tile test of all three flash kernels.
__host__ __device__ __forceinline__ bool flash_tile_live(int r0, int r1, int k0, int k1, int causal, int window) {
  return (!causal || k0 <= r1) && !(window > 0 && k1 <= r0 - window);
}

// D[16x8] += A[16x16] (row-major) * B[16x8] (column-major), bf16 in, f32 acc.
// Fragment layout for lane = 4*g + t (g = lane>>2, t = lane&3):
//   a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//   a2 = A[g][2t+8..+9],   a3 = A[g+8][2t+8..+9]
//   b0 = B[2t..2t+1][g],   b1 = B[2t+8..+9][g]
//   c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats → one 32-bit register of two bf16 (lo in the low half, which
// is the lower column index of a fragment pair).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma / mma.sync A fragments (bf16 pairs) of a [64, 16 * KS] f32 accumulator, k16 step kk
// from columns 16 kk .. 16 kk + 15.
template <int KS>
__device__ __forceinline__ void to_frags(uint32_t (&a)[KS][4], const float* r) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pack_bf16(r[(2 * kk) * 4 + 0], r[(2 * kk) * 4 + 1]);
    a[kk][1] = pack_bf16(r[(2 * kk) * 4 + 2], r[(2 * kk) * 4 + 3]);
    a[kk][2] = pack_bf16(r[(2 * kk + 1) * 4 + 0], r[(2 * kk + 1) * 4 + 1]);
    a[kk][3] = pack_bf16(r[(2 * kk + 1) * 4 + 2], r[(2 * kk + 1) * 4 + 3]);
  }
}

// Two bf16 at arbitrary (2-byte aligned) shared addresses → one register.
__device__ __forceinline__ uint32_t pack_bf16_pair(const __nv_bfloat16* lo, const __nv_bfloat16* hi) {
  uint16_t l = *reinterpret_cast<const uint16_t*>(lo);
  uint16_t h = *reinterpret_cast<const uint16_t*>(hi);
  return (uint32_t)l | ((uint32_t)h << 16);
}

// 2^x on the special-function unit alone (ex2.approx.ftz, one instruction:
// exp2f adds a denormal fixup). A result below 2^-126 flushes to 0, which
// is nothing beside the row sum of at least 1 it joins. The head-dim-96
// flash kernels' exponential.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return v;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}
