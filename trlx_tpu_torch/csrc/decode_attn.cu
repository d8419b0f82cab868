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
// the slot's virtual length bps * bs. Same semantics as the TPU kernel
// otherwise: the running max starts at the finite -1e30, so a row whose keys
// all carry -1e9 attends (near-)uniformly over its T keys, and the final
// division guards l == 0. Keys masked by the bias inside a split that is
// read are weighted by an exact zero, so the cache (values and scales) must
// hold finite numbers: the pools are zero-initialised with unit scales.
//
// What bounds it on an H100: each visible key's K and V rows (2 * h * d
// bytes per key int8, twice that bf16, plus 8 bytes of scales per key and
// head) at ~4 * h * d flops per key, under 2 flops per byte: HBM bytes. The
// bound counts the keys the bias leaves visible (chip_smoke.phase_decode):
// at B = 8, T = 1024, h = 16, d = 256 and 6530 visible keys, 107 MB in
// 0.032 ms bf16.
//
// Design (split-T, "flash-decoding"): grid (splits, h, B), one CTA of 4
// warps per run of KS = 128 contiguous keys (the Pallas BLOCK_T and the
// engine's block size), so B * h = 128 rows give 1024 CTAs at T = 1024.
// Each lane reads 16 bytes of a row (8 bf16 or 16 int8 elements), so a
// warp-load covers 32 / (d * elem / 16) keys (one bf16 key at d = 256, two
// int8 keys), and each warp issues all its K and V loads for U = 8
// warp-loads (8 KB a warp at d = 256) before any math: one DRAM round trip
// per batch of U warp-loads, not per key. (Loading the next batch during
// this one's math raised the registers to 163-168 at d = 256 and slowed the
// paged bf16 walk by half on the card, so the batches stay apart.) Int8
// bytes are widened without I2F. The split's bias slice and
// its int8 scales are staged in shared memory once. A split whose bias
// entries are all masked (<= -5e8) reads no K/V when its row has at least
// one visible key elsewhere (found from the row's bias, T * 4 B from L2):
// exact, since exp(-1e9 - m) is 0 in f32 once m is a live score. A row
// with no visible key reads every split, as the TPU kernel does. With PAGED
// a split lies in one physical block, whose table entry is read once: the
// kernel takes bs % KS == 0 or a slot of one block (paged_decode_eligible's
// shapes) and refuses other block sizes.
// Partials: each split writes its unnormalised acc[d], its max m and its sum
// l (f32) to scratch [B, h, splits, d + 2]; a skipped split writes l = 0
// and no acc. A second small kernel merges them: M = max m_s over the
// splits with l_s > 0, L = sum e^(m_s - M) l_s, o = sum e^(m_s - M) acc_s /
// max(L, 1e-30), bf16 [B, h, d]. The merge reads splits * (d + 2) * 4 bytes
// a (row, head), 1 MB at the smoke's shape, ~0.3 us of bytes plus one launch.
// Registers and occupancy (ptxas, sm_90a) are printed by chip_smoke.py's
// [build] lines and written in PERF.md.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int KS = 128;  // keys per split = threads per CTA (one staged key each)
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int KEYS_PER_WARP = KS / NWARPS;
constexpr float SKIP_BIAS = -5e8f;  // a bias at or below this masks its key
static_assert(NTHREADS == KS, "one thread stages one key of the split");

// Elements of one 16-byte lane load, widened to f32.
__device__ __forceinline__ void widen(const uint4& raw, float* dst, __nv_bfloat16) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = __bfloat162float(e[i]);
}

// Signed bytes without I2F (a quarter-rate conversion on sm_90): bias each
// byte to unsigned (x ^ 0x80), place it in the mantissa of 2^23, subtract
// 2^23 + 128. Exact.
__device__ __forceinline__ void widen(const uint4& raw, float* dst, int8_t) {
  const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dst[4 * i + j] = __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540 + j)) - 8388736.f;
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
  float* part;             // [B, h, splits, d + 2] f32 scratch
  int B, T, h, splits;
  int bs, bps;             // PAGED: block size, blocks per slot
  // Strides in elements: (batch or block, key or in-block offset, head).
  int ksb, kst, ksh, vsb, vst, vsh;
  int kssb, ksst, kssh, vssb, vsst, vssh;
  float scale;
};

template <int D, bool QUANT, bool PAGED>
__global__ void __launch_bounds__(NTHREADS) decode_split_kernel(DecodeParams p) {
  using Elem = typename std::conditional<QUANT, int8_t, __nv_bfloat16>::type;
  constexpr int EPL = 16 / (int)sizeof(Elem);  // elements per lane load
  constexpr int LPK = D / EPL;                 // lanes per key row
  constexpr int KPW = 32 / LPK;                // keys per warp-load
  constexpr int U = KEYS_PER_WARP / KPW < 8 ? KEYS_PER_WARP / KPW : 8;  // warp-loads in flight
  constexpr int NBATCH = KEYS_PER_WARP / (U * KPW);
  static_assert(LPK >= 1 && LPK <= 32 && NBATCH * U * KPW == KEYS_PER_WARP, "lane layout");

  __shared__ float sm_bias[KS];
  __shared__ float sm_ks[QUANT ? KS : 1], sm_vs[QUANT ? KS : 1];
  __shared__ float sm_m[NWARPS], sm_l[NWARPS];
  __shared__ float sm_o[NWARPS][D];

  const int sp = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int T = p.T, t0 = sp * KS;
  const float* bias = p.bias + (size_t)bi * T;
  float* part = p.part + (((size_t)bi * p.h + hi) * p.splits + sp) * (D + 2);

  // PAGED: the one pool block the split lies in.
  const int blk = PAGED ? p.tbl[(size_t)bi * p.bps + t0 / p.bs] : 0;
  // Row offsets of key t: (batch offset in the bases, key t), or
  // (physical block, offset t % bs) in the pool.
  auto key_rows = [&](int t, size_t& kr, size_t& vr, size_t& ksr, size_t& vsr) {
    if (PAGED) {
      const int off = t % p.bs;
      kr = (size_t)blk * p.ksb + (size_t)off * p.kst;
      vr = (size_t)blk * p.vsb + (size_t)off * p.vst;
      ksr = (size_t)blk * p.kssb + (size_t)off * p.ksst;
      vsr = (size_t)blk * p.vssb + (size_t)off * p.vsst;
    } else {
      kr = (size_t)t * p.kst;
      vr = (size_t)t * p.vst;
      ksr = (size_t)t * p.ksst;
      vsr = (size_t)t * p.vsst;
    }
  };
  const Elem* kbase = static_cast<const Elem*>(p.k) + (size_t)hi * p.ksh;
  const Elem* vbase = static_cast<const Elem*>(p.v) + (size_t)hi * p.vsh;
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

  // Stage the split's bias (and scales); skip a fully masked split of a row
  // that has a visible key elsewhere.
  {
    const int t = t0 + tid;
    const float b = t < T ? bias[t] : TRLX_MASK_VAL;
    sm_bias[tid] = b;
    if (QUANT) {
      // Keys past T weigh exactly zero: their scales are zero, not unread.
      float kscale = 0.f, vscale = 0.f;
      if (t < T) {
        size_t kr, vr, ksr, vsr;
        key_rows(t, kr, vr, ksr, vsr);
        kscale = ksbase[ksr];
        vscale = vsbase[vsr];
      }
      sm_ks[tid] = kscale;
      sm_vs[tid] = vscale;
    }
    if (!__syncthreads_or(t < T && b > SKIP_BIAS)) {
      int row_live = 0;
      for (int j = tid; j < T; j += NTHREADS) row_live |= bias[j] > SKIP_BIAS;
      if (__syncthreads_or(row_live)) {
        if (tid == 0) {
          part[D] = TRLX_M_INIT;
          part[D + 1] = 0.f;
        }
        return;
      }
    }
  }

  const int kk = lane / LPK;          // this lane's key within a warp-load
  const int e0 = (lane % LPK) * EPL;  // this lane's first element of the row
  float q[EPL];
  {
    const __nv_bfloat16* qp = p.q + ((size_t)bi * p.h + hi) * D + e0;
#pragma unroll
    for (int c = 0; c < EPL; c += 8) widen(*reinterpret_cast<const uint4*>(qp + c), q + c, __nv_bfloat16());
  }

  float m = TRLX_M_INIT, l = 0.f, acc[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) acc[i] = 0.f;

  for (int b = 0; b < NBATCH; ++b) {
    const int jb = warp * KEYS_PER_WARP + b * U * KPW + kk;  // key index in the split
    uint4 kraw[U], vraw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + jb + u * KPW;
      kraw[u] = vraw[u] = make_uint4(0, 0, 0, 0);
      if (t < T) {
        size_t kr, vr, ksr, vsr;
        key_rows(t, kr, vr, ksr, vsr);
        kraw[u] = *reinterpret_cast<const uint4*>(kbase + kr + e0);
        vraw[u] = *reinterpret_cast<const uint4*>(vbase + vr + e0);
      }
    }
    float s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[EPL];
      widen(kraw[u], kf, Elem());
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) dot = fmaf(q[i], kf[i], dot);
#pragma unroll
      for (int o = LPK / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const int j = jb + u * KPW;
      float sc = dot * p.scale;
      if (QUANT) sc *= sm_ks[j];
      // Keys past T exist only as split padding: they never raise the max.
      s[u] = t0 + j < T ? sc + sm_bias[j] : TRLX_M_INIT;
    }
    float mb = m;
#pragma unroll
    for (int u = 0; u < U; ++u) mb = fmaxf(mb, s[u]);
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1) mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
    const float alpha = expf(m - mb);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = jb + u * KPW;
      float pj = t0 + j < T ? expf(s[u] - mb) : 0.f;
      l += pj;
      if (QUANT) pj *= sm_vs[j];
      float vf[EPL];
      widen(vraw[u], vf, Elem());
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc[i] = fmaf(pj, vf[i], acc[i]);
    }
    m = mb;
  }
  // m is uniform over the warp; l and acc are per key group: sum the groups.
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
  }
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  if (lane < LPK) {
#pragma unroll
    for (int i = 0; i < EPL; ++i) sm_o[warp][e0 + i] = acc[i];
  }
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
  for (int d = tid; d < D; d += NTHREADS) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) o = fmaf(wgt[w], sm_o[w][d], o);
    part[d] = o;
  }
  if (tid == 0) {
    part[D] = M;
    part[D + 1] = L;
  }
}

// One CTA of D threads per (row, head): merge the splits' partials.
template <int D>
__global__ void __launch_bounds__(D) decode_merge_kernel(const float* part, __nv_bfloat16* o, int splits) {
  const size_t row = (size_t)blockIdx.y * gridDim.x + blockIdx.x;  // (bi, hi)
  const float* pr = part + row * splits * (D + 2);
  float M = TRLX_M_INIT;
  for (int s = 0; s < splits; ++s)
    if (pr[s * (D + 2) + D + 1] > 0.f) M = fmaxf(M, pr[s * (D + 2) + D]);
  float L = 0.f, acc = 0.f;
  const int d = threadIdx.x;
  for (int s = 0; s < splits; ++s) {
    const float* ps = pr + s * (D + 2);
    const float ls = ps[D + 1];
    if (ls > 0.f) {  // l == 0: a skipped split, whose acc was never written
      const float w = expf(ps[D] - M);
      L = fmaf(w, ls, L);
      acc = fmaf(w, ps[d], acc);
    }
  }
  o[row * D + d] = __float2bfloat16(acc / fmaxf(L, 1e-30f));
}

template <int D, bool QUANT, bool PAGED>
int launch_d(const DecodeParams& p, cudaStream_t s) {
  decode_split_kernel<D, QUANT, PAGED><<<dim3(p.splits, p.h, p.B), NTHREADS, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_merge_kernel<D><<<dim3(p.h, p.B), D, 0, s>>>(p.part, p.o, p.splits);
  return (int)cudaGetLastError();
}

template <bool QUANT, bool PAGED>
int launch(const DecodeParams& p, int d, void* stream) {
  if (p.splits != (p.T + KS - 1) / KS) return (int)cudaErrorInvalidValue;
  if (PAGED && p.bs % KS != 0 && p.bps != 1) return (int)cudaErrorInvalidValue;  // a split across blocks
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_d<64, QUANT, PAGED>(p, s);
    case 128: return launch_d<128, QUANT, PAGED>(p, s);
    case 256: return launch_d<256, QUANT, PAGED>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

DecodeParams common(const void* q, const void* k, const void* v, const void* bias, void* o, void* part,
                    int splits, int B, int T, int h, int ksb, int kst, int ksh, int vsb, int vst, int vsh,
                    float scale) {
  DecodeParams p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.part = static_cast<float*>(part);
  p.splits = splits;
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

extern "C" int decode_attn_bf16(const void* q, const void* k, const void* v, const void* bias, void* o, void* part,
                                int splits, int B, int T, int h, int d, int ksb, int kst, int ksh, int vsb,
                                int vst, int vsh, float scale, void* stream) {
  DecodeParams p = common(q, k, v, bias, o, part, splits, B, T, h, ksb, kst, ksh, vsb, vst, vsh, scale);
  return launch<false, false>(p, d, stream);
}

extern "C" int decode_attn_int8(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                                const void* bias, void* o, void* part, int splits, int B, int T, int h, int d,
                                int ksb, int kst, int ksh, int vsb, int vst, int vsh, int kssb, int ksst,
                                int kssh, int vssb, int vsst, int vssh, float scale, void* stream) {
  DecodeParams p = common(q, k, v, bias, o, part, splits, B, T, h, ksb, kst, ksh, vsb, vst, vsh, scale);
  set_scales(p, ks, vs, kssb, ksst, kssh, vssb, vsst, vssh);
  return launch<true, false>(p, d, stream);
}

extern "C" int paged_decode_attn_bf16(const void* q, const void* k, const void* v, const void* tbl,
                                      const void* bias, void* o, void* part, int splits, int S, int bs, int bps,
                                      int h, int d, int ksb, int kst, int ksh, int vsb, int vst, int vsh,
                                      float scale, void* stream) {
  DecodeParams p = common(q, k, v, bias, o, part, splits, S, bs * bps, h, ksb, kst, ksh, vsb, vst, vsh, scale);
  p.tbl = static_cast<const int*>(tbl);
  p.bs = bs; p.bps = bps;
  return launch<false, true>(p, d, stream);
}

extern "C" int paged_decode_attn_int8(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                                      const void* tbl, const void* bias, void* o, void* part, int splits, int S,
                                      int bs, int bps, int h, int d, int ksb, int kst, int ksh, int vsb, int vst,
                                      int vsh, int kssb, int ksst, int kssh, int vssb, int vsst, int vssh,
                                      float scale, void* stream) {
  DecodeParams p = common(q, k, v, bias, o, part, splits, S, bs * bps, h, ksb, kst, ksh, vsb, vst, vsh, scale);
  set_scales(p, ks, vs, kssb, ksst, kssh, vssb, vsst, vssh);
  p.tbl = static_cast<const int*>(tbl);
  p.bs = bs; p.bps = bps;
  return launch<true, true>(p, d, stream);
}
