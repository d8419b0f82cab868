// Single-token flash-decode attention over the KV cache for Hopper: a bf16 or
// an int8 cache, read directly or through a per-slot block table.
//
// Replaces the four Pallas kernels of trlx_tpu/ops/decode_attention.py that
// share the body _decode_block / _finalize:
//   _kernel_plain       bf16 cache [B, T, h, d]                 (QUANT=0, PAGED=0)
//   _kernel_quant       int8 cache + f32 per-key scales [B,T,h] (QUANT=1, PAGED=0)
//   _paged_kernel_plain bf16 pool [n_blocks, bs, h, d] + table  (QUANT=0, PAGED=1)
//   _paged_kernel_quant int8 pool + scales [n_blocks, bs, h]    (QUANT=1, PAGED=1)
// For every batch row (slot) and head it computes softmax(q . K^T * scale
// [* ks] + bias) . ([vs *] V) over T keys, with one additive f32 bias row
// [B, T] per row that carries causality, cache validity and any window
// (0 valid / -1e9 masked). With QUANT the per-key scales are folded into the
// algebra exactly as the TPU kernel does: score = dot(q, k8) * scale * ks + bias,
// l += p, acc += (p * vs) * v8, so the int8 bytes are the only K/V bytes read.
// With PAGED, key t of slot s lives at pool[tbl[s, t / bs], t % bs] and T is
// the slot's virtual length bps * bs; the CTA loads its slot's table row into
// shared memory first. Same semantics as the TPU kernel otherwise: the
// running max starts at the finite -1e30, so a row whose keys all carry -1e9
// attends (near-)uniformly over its T keys, and the final division guards
// l == 0. Keys masked by the bias are still read and weighted by an exact
// zero, so the cache (values and scales) must hold finite numbers: the pools
// are zero-initialised with unit scales.
//
// What bounds it on an H100: it reads each key's K and V row once (2 * h * d
// bytes per key int8, twice that bf16, plus 8 bytes of scales per key and
// head) and does ~4 * h * d flops per key, under 2 flops per byte, so it is
// HBM-bound. Design: one CTA per (head, row) with 8 warps; each warp walks
// its own strided set of keys four at a time (d / 32 elements per lane: one
// 16-byte bf16 load or one 8-byte int8 load at d = 256), keeps its own
// online max/sum and a d-wide f32 accumulator spread over its lanes, and the
// warps' partial softmax states are merged through shared memory at the end.
// The TPU's sequential T-block grid axis becomes this in-block walk, so any
// cache length works, and the scales are read through strides: the TPU
// wrapper's [B, T, h] -> [B, h, T] transpose exists only for Mosaic tiling.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NWARPS = 8;
constexpr int UNROLL = 4;  // keys per warp per iteration

template <int BYTES> struct RawT;
template <> struct RawT<16> { using T = uint4; };
template <> struct RawT<8> { using T = uint2; };
template <> struct RawT<4> { using T = uint32_t; };
template <> struct RawT<2> { using T = uint16_t; };

// VEC consecutive elements of one K or V row, widened to f32.
template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* src, float* dst) {
  using V = typename RawT<VEC * 2>::T;
  V raw = *reinterpret_cast<const V*>(src);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) dst[i] = __bfloat162float(e[i]);
}

template <int VEC>
__device__ __forceinline__ void load_vec(const int8_t* src, float* dst) {
  using V = typename RawT<VEC>::T;
  V raw = *reinterpret_cast<const V*>(src);
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) dst[i] = static_cast<float>(e[i]);
}

struct DecodeParams {
  const __nv_bfloat16* q;  // [B, h, d] contiguous
  const void* k;           // bf16 or int8; [B, T, h, d] or pool [n_blocks, bs, h, d]
  const void* v;
  const float* ks;         // QUANT: [B, T, h] or [n_blocks, bs, h] f32, any strides
  const float* vs;
  const int* tbl;          // PAGED: [B, bps] int32 contiguous
  const float* bias;       // [B, T] contiguous (T = bps * bs when PAGED)
  __nv_bfloat16* o;        // [B, h, d] contiguous
  int B, T, h;
  int bs, bps;             // PAGED: block size, blocks per slot
  // Strides in elements: (batch or block, key or in-block offset, head).
  int ksb, kst, ksh, vsb, vst, vsh;
  int kssb, ksst, kssh, vssb, vsst, vssh;
  float scale;
};

template <int D, bool QUANT, bool PAGED>
__global__ void __launch_bounds__(NWARPS * 32) decode_attn_kernel(DecodeParams p) {
  using Elem = typename std::conditional<QUANT, int8_t, __nv_bfloat16>::type;
  constexpr int VEC = D / 32;
  __shared__ float sm_m[NWARPS], sm_l[NWARPS];
  __shared__ float sm_o[NWARPS][D];
  extern __shared__ int sm_tbl[];  // PAGED: this slot's table row

  const int hi = blockIdx.x, bi = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int T = p.T;
  const int d0 = lane * VEC;

  if (PAGED) {
    for (int i = threadIdx.x; i < p.bps; i += NWARPS * 32) sm_tbl[i] = p.tbl[(size_t)bi * p.bps + i];
    __syncthreads();
  }

  float q[VEC];
  load_vec<VEC>(p.q + ((size_t)bi * p.h + hi) * D + d0, q);
  const Elem* kbase = static_cast<const Elem*>(p.k) + (size_t)hi * p.ksh + d0;
  const Elem* vbase = static_cast<const Elem*>(p.v) + (size_t)hi * p.vsh + d0;
  const float* ksbase = QUANT ? p.ks + (size_t)hi * p.kssh : nullptr;
  const float* vsbase = QUANT ? p.vs + (size_t)hi * p.vssh : nullptr;
  if (!PAGED) {
    kbase += (size_t)bi * p.ksb;
    vbase += (size_t)bi * p.vsb;
    if (QUANT) {
      ksbase += (size_t)bi * p.kssb;
      vsbase += (size_t)bi * p.vssb;
    }
  }
  const float* bias = p.bias + (size_t)bi * T;

  float m = TRLX_M_INIT, l = 0.f;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  for (int base = warp * UNROLL; base < T; base += NWARPS * UNROLL) {
    float kf[UNROLL][VEC], vf[UNROLL][VEC], sc[UNROLL], kscale[UNROLL], vscale[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int t = base + j;
      kscale[j] = vscale[j] = 1.f;
      if (t < T) {
        // Row of key t: (batch offset already in the bases, key t) or
        // (physical block tbl[t / bs], offset t % bs) in the pool.
        size_t kr, vr, ksr = 0, vsr = 0;
        if (PAGED) {
          const int blk = sm_tbl[t / p.bs], off = t % p.bs;
          kr = (size_t)blk * p.ksb + (size_t)off * p.kst;
          vr = (size_t)blk * p.vsb + (size_t)off * p.vst;
          if (QUANT) {
            ksr = (size_t)blk * p.kssb + (size_t)off * p.ksst;
            vsr = (size_t)blk * p.vssb + (size_t)off * p.vsst;
          }
        } else {
          kr = (size_t)t * p.kst;
          vr = (size_t)t * p.vst;
          if (QUANT) {
            ksr = (size_t)t * p.ksst;
            vsr = (size_t)t * p.vsst;
          }
        }
        load_vec<VEC>(kbase + kr, kf[j]);
        load_vec<VEC>(vbase + vr, vf[j]);
        if (QUANT) {
          kscale[j] = ksbase[ksr];
          vscale[j] = vsbase[vsr];
        }
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kf[j][i] = vf[j][i] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) dot = fmaf(q[i], kf[j][i], dot);
      sc[j] = warp_sum(dot);
    }
    float mg = m;
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int t = base + j;
      float s = sc[j] * p.scale;
      if (QUANT) s *= kscale[j];
      sc[j] = t < T ? s + bias[t] : TRLX_MASK_VAL;
      mg = fmaxf(mg, sc[j]);
    }
    const float alpha = expf(m - mg);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      // Slots past T weigh exactly zero (their v rows were zero-filled too).
      float pj = (base + j) < T ? expf(sc[j] - mg) : 0.f;
      l += pj;
      if (QUANT) pj *= vscale[j];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(pj, vf[j][i], acc[i]);
    }
    m = mg;
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) sm_o[warp][d0 + i] = acc[i];
  __syncthreads();

  float M = TRLX_M_INIT;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, sm_m[w]);
  float L = 0.f, wgt[NWARPS];
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
    wgt[w] = expf(sm_m[w] - M);
    L += wgt[w] * sm_l[w];
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
  __nv_bfloat16* ob = p.o + ((size_t)bi * p.h + hi) * D;
  for (int d = threadIdx.x; d < D; d += NWARPS * 32) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) o = fmaf(wgt[w], sm_o[w][d], o);
    ob[d] = __float2bfloat16(o * inv);
  }
}

template <bool QUANT, bool PAGED>
int launch(const DecodeParams& p, int d, void* stream) {
  dim3 grid(p.h, p.B);
  const size_t smem = PAGED ? (size_t)p.bps * sizeof(int) : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: decode_attn_kernel<64, QUANT, PAGED><<<grid, NWARPS * 32, smem, s>>>(p); break;
    case 128: decode_attn_kernel<128, QUANT, PAGED><<<grid, NWARPS * 32, smem, s>>>(p); break;
    case 256: decode_attn_kernel<256, QUANT, PAGED><<<grid, NWARPS * 32, smem, s>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

DecodeParams common(const void* q, const void* k, const void* v, const void* bias, void* o, int B, int T, int h,
                    int ksb, int kst, int ksh, int vsb, int vst, int vsh, float scale) {
  DecodeParams p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.B = B; p.T = T; p.h = h;
  p.ksb = ksb; p.kst = kst; p.ksh = ksh;
  p.vsb = vsb; p.vst = vst; p.vsh = vsh;
  p.scale = scale;
  return p;
}

void set_scales(DecodeParams& p, const void* ks, const void* vs, int kssb, int ksst, int kssh, int vssb, int vsst,
                int vssh) {
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.kssb = kssb; p.ksst = ksst; p.kssh = kssh;
  p.vssb = vssb; p.vsst = vsst; p.vssh = vssh;
}

}  // namespace

extern "C" int decode_attn_bf16(const void* q, const void* k, const void* v, const void* bias, void* o, int B,
                                int T, int h, int d, int ksb, int kst, int ksh, int vsb, int vst, int vsh,
                                float scale, void* stream) {
  DecodeParams p = common(q, k, v, bias, o, B, T, h, ksb, kst, ksh, vsb, vst, vsh, scale);
  return launch<false, false>(p, d, stream);
}

extern "C" int decode_attn_int8(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                                const void* bias, void* o, int B, int T, int h, int d, int ksb, int kst, int ksh,
                                int vsb, int vst, int vsh, int kssb, int ksst, int kssh, int vssb, int vsst,
                                int vssh, float scale, void* stream) {
  DecodeParams p = common(q, k, v, bias, o, B, T, h, ksb, kst, ksh, vsb, vst, vsh, scale);
  set_scales(p, ks, vs, kssb, ksst, kssh, vssb, vsst, vssh);
  return launch<true, false>(p, d, stream);
}

extern "C" int paged_decode_attn_bf16(const void* q, const void* k, const void* v, const void* tbl,
                                      const void* bias, void* o, int S, int bs, int bps, int h, int d, int ksb,
                                      int kst, int ksh, int vsb, int vst, int vsh, float scale, void* stream) {
  DecodeParams p = common(q, k, v, bias, o, S, bs * bps, h, ksb, kst, ksh, vsb, vst, vsh, scale);
  p.tbl = static_cast<const int*>(tbl);
  p.bs = bs; p.bps = bps;
  return launch<false, true>(p, d, stream);
}

extern "C" int paged_decode_attn_int8(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                                      const void* tbl, const void* bias, void* o, int S, int bs, int bps, int h,
                                      int d, int ksb, int kst, int ksh, int vsb, int vst, int vsh, int kssb,
                                      int ksst, int kssh, int vssb, int vsst, int vssh, float scale,
                                      void* stream) {
  DecodeParams p = common(q, k, v, bias, o, S, bs * bps, h, ksb, kst, ksh, vsb, vst, vsh, scale);
  set_scales(p, ks, vs, kssb, ksst, kssh, vssb, vsst, vssh);
  p.tbl = static_cast<const int*>(tbl);
  p.bs = bs; p.bps = bps;
  return launch<true, true>(p, d, stream);
}
