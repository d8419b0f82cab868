// Flash attention backward for Hopper (sm_90a): two kernels, bf16 in, f32
// accumulation.
//
// Replaces: trlx_tpu/ops/flash_attention.py:_bwd_dq_kernel and
// _bwd_dkv_kernel (pallas_calls in _flash_lse_bwd). Both recompute the
// probabilities from the forward's saved log-sum-exp instead of storing them:
//   s  = q . k^T * scale, masked scores REPLACED by -1e9 (the forward's rule)
//   p  = exp(s - lse_q)
//   dp = dO . v^T
//   ds = p * (dp - delta_q),  delta = rowsum(dO * O) - dlse (computed by the
//        caller, as the JAX package computes it outside Pallas)
//   dq = (ds . k) * scale,  dv = p^T . dO,  dk = (ds^T . q) * scale
// p and ds are rounded to bf16 before their products, as the TPU kernels cast
// them to the operand dtype. Tiles that the causal/window mask empties are
// skipped by the same test as the forward, so p is the forward's p.
//
// What bounds it on an H100: at the train shape [8, 1024, 16, 256] there are
// 67.2M live (query, key) pairs; dq costs 6*d flops a pair (1.03e11, 0.104 ms
// at the bf16 peak) and dk/dv 8*d (1.38e11, 0.139 ms) against ~0.34/0.40 GB of
// q, k, v, dO and outputs (~0.10/0.12 ms), so the tensor cores bound both.
// Design (no atomics, so the result is deterministic):
// - dq: one CTA per (64-query tile, head, batch row), 4 warps of 16 query rows,
//   looping over key tiles up to the diagonal. Q, dO, K and V tiles of 64 x d
//   sit in padded shared memory (135 KB at d = 256); the dq accumulator
//   (16 rows x d per warp, 128 f32 registers a thread at d = 256) never leaves
//   registers. dp is formed 8 keys at a time to keep register pressure at
//   the forward's level.
// - dk/dv: one CTA per (64-key tile, head, batch row), 8 warps in two groups
//   that split the two [64, d] accumulators: warps 0-3 form p (K . Q^T) and
//   accumulate dv += p^T . dO; warps 4-7 form dp^T (V . dO^T), read p from
//   shared memory (f32), and accumulate dk += ds^T . Q. Each group does two of
//   the four products, and each thread again holds one 16 x d accumulator.
// Loads are plain 16-byte vector loads; cp.async/TMA and wgmma are left to a
// later change.

#include "common.cuh"

namespace {

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // keys per tile

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;  // [b, T, h, d] contiguous
  const float* kmask;         // [b, T] key validity (> 0.5 = valid)
  const float* lse;           // [b, h, T]
  const float* delta;         // [b, h, T]
  __nv_bfloat16* dq;          // [b, T, h, d] contiguous
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int b, T, h;
  int qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh;  // element strides
  float scale;
  int window;
};

// Rows [t0, t0 + 64) of one (batch, head) slice into a padded tile; rows past
// T are zero-filled.
template <int D, int NT>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base, int t0, int T, int st) {
  constexpr int LD = D + 8;
  constexpr int VPR = D / 8;
  for (int i = threadIdx.x; i < 64 * VPR; i += NT) {
    int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t0 + r < T) val = *reinterpret_cast<const uint4*>(base + (size_t)(t0 + r) * st + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// acc[16 rows x 64 cols] (fragments s[8][4]) = A[rows r0, r0+8 of As] . B^T,
// where B's 64 rows are Bs rows 0..63: the product of two row-major tiles
// over their shared d axis.
template <int D>
__device__ __forceinline__ void rows_dot_rows(float (&s)[BK / 8][4], const __nv_bfloat16* arow0,
                                              const __nv_bfloat16* Bs, int g, int t) {
  constexpr int LD = D + 8;
  const __nv_bfloat16* arow1 = arow0 + 8 * LD;
#pragma unroll
  for (int nb = 0; nb < BK / 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll 4
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 + 2 * t;
    uint32_t a[4];
    a[0] = *reinterpret_cast<const uint32_t*>(arow0 + c);
    a[1] = *reinterpret_cast<const uint32_t*>(arow1 + c);
    a[2] = *reinterpret_cast<const uint32_t*>(arow0 + c + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(arow1 + c + 8);
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
      const __nv_bfloat16* brow = Bs + (nb * 8 + g) * LD;
      uint32_t bb[2];
      bb[0] = *reinterpret_cast<const uint32_t*>(brow + c);
      bb[1] = *reinterpret_cast<const uint32_t*>(brow + c + 8);
      mma_bf16_16816(s[nb], a, bb);
    }
  }
}

// acc[16 x D] += P[16 x 64] . B[64 x D], P given as f32 fragments (rounded to
// bf16 here) and B row-major in shared memory (rows = the 64-wide k axis).
template <int D>
__device__ __forceinline__ void frag_dot_tile(float (&acc)[D / 8][4], const float (&p)[BK / 8][4],
                                              const __nv_bfloat16* Bs, int g, int t) {
  constexpr int LD = D + 8;
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[kk][1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[kk][2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
  }
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + g;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const int r = kk * 16 + 2 * t;
      uint32_t bb[2];
      bb[0] = pack_bf16_pair(Bs + r * LD + col, Bs + (r + 1) * LD + col);
      bb[1] = pack_bf16_pair(Bs + (r + 8) * LD + col, Bs + (r + 9) * LD + col);
      mma_bf16_16816(acc[nd], pa[kk], bb);
    }
  }
}

__device__ __forceinline__ bool pair_valid(int query, int key, int T, float kval, int window) {
  bool valid = key < T && query < T && kval > 0.5f && key <= query;
  if (window > 0) valid = valid && (key > query - window);
  return valid;
}

template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[D / 8][4], int row0, int T,
                                           size_t orow, float mul, int t) {
  const int row1 = row0 + 8;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (row0 < T)
      *reinterpret_cast<uint32_t*>(out + (size_t)row0 * orow + col) = pack_bf16(acc[nd][0] * mul, acc[nd][1] * mul);
    if (row1 < T)
      *reinterpret_cast<uint32_t*>(out + (size_t)row1 * orow + col) = pack_bf16(acc[nd][2] * mul, acc[nd][3] * mul);
  }
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dq_kernel(BwdParams p) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + BQ * LD;
  __nv_bfloat16* Ks = dOs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;
  float* kval = reinterpret_cast<float*>(Vs + BK * LD);

  const int qt = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int q_start = qt * BQ;
  const int T = p.T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t orow = (size_t)p.h * D;

  const __nv_bfloat16* qb = p.q + (size_t)bi * p.qsb + (size_t)hi * p.qsh;
  const __nv_bfloat16* kb = p.k + (size_t)bi * p.ksb + (size_t)hi * p.ksh;
  const __nv_bfloat16* vb = p.v + (size_t)bi * p.vsb + (size_t)hi * p.vsh;
  const __nv_bfloat16* db = p.dout + (size_t)bi * T * orow + (size_t)hi * D;
  load_tile<D, 128>(Qs, qb, q_start, T, p.qst);
  load_tile<D, 128>(dOs, db, q_start, T, (int)orow);

  const int row0 = q_start + warp * 16 + g, row1 = row0 + 8;
  const float* lb = p.lse + ((size_t)bi * p.h + hi) * T;
  const float* dlb = p.delta + ((size_t)bi * p.h + hi) * T;
  // Rows past T: zero Q and dO, lse = delta = 0, so every term is finite and
  // nothing is written.
  const float lse0 = row0 < T ? lb[row0] : 0.f, lse1 = row1 < T ? lb[row1] : 0.f;
  const float dl0 = row0 < T ? dlb[row0] : 0.f, dl1 = row1 < T ? dlb[row1] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int nk = (T + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k_start = kt * BK;
    if (k_start > q_start + BQ - 1) continue;  // the forward's tile-skip test
    if (p.window > 0 && k_start + BK - 1 <= q_start - p.window) continue;

    __syncthreads();
    load_tile<D, 128>(Ks, kb, k_start, T, p.kst);
    load_tile<D, 128>(Vs, vb, k_start, T, p.vst);
    if (threadIdx.x < BK) {
      int key = k_start + threadIdx.x;
      kval[threadIdx.x] = key < T ? p.kmask[(size_t)bi * T + key] : 0.f;
    }
    __syncthreads();

    // p from the saved lse.
    float s[BK / 8][4];
    rows_dot_rows<D>(s, Qs + (warp * 16 + g) * LD, Ks, g, t);
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = nb * 8 + 2 * t + (e & 1);
        const int key = k_start + kk;
        const int row = (e < 2) ? row0 : row1;
        const float sv = pair_valid(row, key, T, kval[kk], p.window) ? s[nb][e] * p.scale : TRLX_MASK_VAL;
        // Keys past T exist only as tile padding: weight exactly zero.
        s[nb][e] = key < T ? expf(sv - (e < 2 ? lse0 : lse1)) : 0.f;
      }
    }

    // ds = p * (dO . V^T - delta), 8 keys at a time.
    const __nv_bfloat16* drow0 = dOs + (warp * 16 + g) * LD;
    const __nv_bfloat16* drow1 = drow0 + 8 * LD;
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
      float dp[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* vrow = Vs + (nb * 8 + g) * LD;
#pragma unroll 4
      for (int ks = 0; ks < D / 16; ++ks) {
        const int c = ks * 16 + 2 * t;
        uint32_t a[4], bb[2];
        a[0] = *reinterpret_cast<const uint32_t*>(drow0 + c);
        a[1] = *reinterpret_cast<const uint32_t*>(drow1 + c);
        a[2] = *reinterpret_cast<const uint32_t*>(drow0 + c + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(drow1 + c + 8);
        bb[0] = *reinterpret_cast<const uint32_t*>(vrow + c);
        bb[1] = *reinterpret_cast<const uint32_t*>(vrow + c + 8);
        mma_bf16_16816(dp, a, bb);
      }
      s[nb][0] *= dp[0] - dl0;
      s[nb][1] *= dp[1] - dl0;
      s[nb][2] *= dp[2] - dl1;
      s[nb][3] *= dp[3] - dl1;
    }

    // dq += ds . K (scale applied once at the end).
    frag_dot_tile<D>(acc, s, Ks, g, t);
  }

  store_rows<D>(p.dq + (size_t)bi * T * orow + (size_t)hi * D, acc, row0, T, orow, p.scale, t);
}

// ---------------------------------------------------------------------------
// dk / dv
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(256, 1) flash_bwd_dkv_kernel(BwdParams p) {
  constexpr int LD = D + 8;
  constexpr int LDP = BQ + 4;  // f32 P tile row (keys x queries)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + BK * LD;
  __nv_bfloat16* Qs = Vs + BK * LD;
  __nv_bfloat16* dOs = Qs + BQ * LD;
  float* Ps = reinterpret_cast<float*>(dOs + BQ * LD);
  float* lse_s = Ps + BK * LDP;
  float* delta_s = lse_s + BQ;

  const int kt = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int k_start = kt * BK;
  const int T = p.T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool p_group = warp < 4;  // warps 0-3: p and dv; warps 4-7: dp, ds and dk
  const int wl = warp & 3;
  const size_t orow = (size_t)p.h * D;

  const __nv_bfloat16* qb = p.q + (size_t)bi * p.qsb + (size_t)hi * p.qsh;
  const __nv_bfloat16* kb = p.k + (size_t)bi * p.ksb + (size_t)hi * p.ksh;
  const __nv_bfloat16* vb = p.v + (size_t)bi * p.vsb + (size_t)hi * p.vsh;
  const __nv_bfloat16* db = p.dout + (size_t)bi * T * orow + (size_t)hi * D;
  const float* lb = p.lse + ((size_t)bi * p.h + hi) * T;
  const float* dlb = p.delta + ((size_t)bi * p.h + hi) * T;
  load_tile<D, 256>(Ks, kb, k_start, T, p.kst);
  load_tile<D, 256>(Vs, vb, k_start, T, p.vst);

  const int kr0 = wl * 16 + g, kr1 = kr0 + 8;  // this thread's two key rows (tile-local)
  const int key0 = k_start + kr0, key1 = k_start + kr1;
  const float kv0 = key0 < T ? p.kmask[(size_t)bi * T + key0] : 0.f;
  const float kv1 = key1 < T ? p.kmask[(size_t)bi * T + key1] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int nq = (T + BQ - 1) / BQ;
  for (int qt = 0; qt < nq; ++qt) {
    const int q_start = qt * BQ;
    if (k_start > q_start + BQ - 1) continue;  // the forward's tile-skip test
    if (p.window > 0 && k_start + BK - 1 <= q_start - p.window) continue;

    __syncthreads();  // previous tile fully consumed
    load_tile<D, 256>(Qs, qb, q_start, T, p.qst);
    load_tile<D, 256>(dOs, db, q_start, T, (int)orow);
    if (threadIdx.x < BQ) {
      const int row = q_start + threadIdx.x;
      lse_s[threadIdx.x] = row < T ? lb[row] : 0.f;
      delta_s[threadIdx.x] = row < T ? dlb[row] : 0.f;
    }
    __syncthreads();

    float s[BQ / 8][4];  // [16 keys x 64 queries] per warp
    if (p_group) {
      // p^T = exp(K . Q^T * scale, masked, - lse_query).
      rows_dot_rows<D>(s, Ks + kr0 * LD, Qs, g, t);
#pragma unroll
      for (int nb = 0; nb < BQ / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = nb * 8 + 2 * t + (e & 1);
          const int query = q_start + ql;
          const int key = e < 2 ? key0 : key1;
          const float sv = pair_valid(query, key, T, e < 2 ? kv0 : kv1, p.window) ? s[nb][e] * p.scale
                                                                                   : TRLX_MASK_VAL;
          // Padding on either side (past T) carries exactly zero weight.
          const float pv = (query < T && key < T) ? expf(sv - lse_s[ql]) : 0.f;
          s[nb][e] = pv;
          Ps[(e < 2 ? kr0 : kr1) * LDP + ql] = pv;
        }
      }
    } else {
      // dp^T = V . dO^T.
      rows_dot_rows<D>(s, Vs + kr0 * LD, dOs, g, t);
    }
    __syncthreads();  // P visible to the dk group

    if (p_group) {
      frag_dot_tile<D>(acc, s, dOs, g, t);  // dv += p^T . dO
    } else {
#pragma unroll
      for (int nb = 0; nb < BQ / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = nb * 8 + 2 * t + (e & 1);
          s[nb][e] = Ps[(e < 2 ? kr0 : kr1) * LDP + ql] * (s[nb][e] - delta_s[ql]);
        }
      }
      frag_dot_tile<D>(acc, s, Qs, g, t);  // dk += ds^T . Q (scale at the end)
    }
  }

  const size_t out_off = (size_t)bi * T * orow + (size_t)hi * D;
  if (p_group)
    store_rows<D>(p.dv + out_off, acc, key0, T, orow, 1.f, t);
  else
    store_rows<D>(p.dk + out_off, acc, key0, T, orow, p.scale, t);
}

template <int D>
cudaError_t launch_dq(const BwdParams& p, cudaStream_t stream) {
  const int smem = 4 * 64 * (D + 8) * (int)sizeof(__nv_bfloat16) + BK * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.T + BQ - 1) / BQ, p.h, p.b);
  flash_bwd_dq_kernel<D><<<grid, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const BwdParams& p, cudaStream_t stream) {
  const int smem = 4 * 64 * (D + 8) * (int)sizeof(__nv_bfloat16) + (BK * (BQ + 4) + 2 * BQ) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.T + BK - 1) / BK, p.h, p.b);
  flash_bwd_dkv_kernel<D><<<grid, 256, smem, stream>>>(p);
  return cudaGetLastError();
}

BwdParams make_params(const void* q, const void* k, const void* v, const void* dout, const void* kmask,
                      const void* lse, const void* delta, int b, int T, int h, int qsb, int qst, int qsh, int ksb,
                      int kst, int ksh, int vsb, int vst, int vsh, float scale, int window) {
  BwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.kmask = static_cast<const float*>(kmask);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = p.dk = p.dv = nullptr;
  p.b = b; p.T = T; p.h = h;
  p.qsb = qsb; p.qst = qst; p.qsh = qsh;
  p.ksb = ksb; p.kst = kst; p.ksh = ksh;
  p.vsb = vsb; p.vst = vst; p.vsh = vsh;
  p.scale = scale; p.window = window;
  return p;
}

}  // namespace

extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout, const void* kmask,
                                 const void* lse, const void* delta, void* dq, int b, int T, int h, int d, int qsb,
                                 int qst, int qsh, int ksb, int kst, int ksh, int vsb, int vst, int vsh, float scale,
                                 int window, void* stream) {
  BwdParams p = make_params(q, k, v, dout, kmask, lse, delta, b, T, h, qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh,
                            scale, window);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return (int)launch_dq<64>(p, s);
    case 128: return (int)launch_dq<128>(p, s);
    case 256: return (int)launch_dq<256>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout, const void* kmask,
                                  const void* lse, const void* delta, void* dk, void* dv, int b, int T, int h, int d,
                                  int qsb, int qst, int qsh, int ksb, int kst, int ksh, int vsb, int vst, int vsh,
                                  float scale, int window, void* stream) {
  BwdParams p = make_params(q, k, v, dout, kmask, lse, delta, b, T, h, qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh,
                            scale, window);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return (int)launch_dkv<64>(p, s);
    case 128: return (int)launch_dkv<128>(p, s);
    case 256: return (int)launch_dkv<256>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
