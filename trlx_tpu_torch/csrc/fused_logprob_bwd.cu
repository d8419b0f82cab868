// Fused head projection + (logprob, logsumexp, entropy), backward, for Hopper
// (sm_90a).
//
// Replaces: trlx_tpu/ops/fused_logprob.py:_bwd_dx_kernel and _bwd_dw_kernel
// (pallas_calls in _bwd_calls; per-tile math in _ds_tile). Given the
// forward's row residuals (lse, entropy) and the three cotangents
// (dlp, dlse, dent), the score cotangent of row n, vocabulary column k is
//   ds = dlp * (1[k = y] - p) + dlse * p - dent * p * (s - E),
//   p = exp(s - lse), E = lse - entropy,
// and dx = ds . W^T (ds . W when tied), dW = x^T . ds (ds^T . x when tied),
// db = sum_n ds.
//
// What bounds it on an H100: at N = 2048, D = 4096, V = 50400 the least work
// is one recompute of s plus dx plus dW, 3 * 2NDV = 2.54e12 flops (2.57 ms at
// the bf16 peak), against ~1.65 GB of W in and dW out (0.49 ms): the tensor
// cores bound it. The TPU kernels keep a [128, D] dx accumulator and a
// [D, 256] dW accumulator in VMEM (2 MB and 4 MB); an SM has 228 KB of
// shared memory, and splitting D instead would recompute s D/bd times. So the
// work is cut along N instead. The wrapper walks N in chunks of C rows (C =
// 1024: a bf16 [C, V] ds buffer of ~103 MB, never a full [N, V] one), and per
// chunk launches
//   1. the ds kernel: one CTA per (128-row tile, 128-column vocabulary tile),
//      full-D reduction as in the forward, f32 W converted to bf16 on load,
//      bias added in f32; writes ds in bf16 (zero past V) and the tile's f32
//      column sums of ds (for db, merged later in a fixed order);
//   2. the dx kernel: dx[C, D] = ds . W^T, a tiled mma.sync product reducing
//      over V, W converted to bf16 on load and zeroed past V;
//   3. the dW kernel (a separate C entry): dW += x^T . ds, a tiled product
//      reducing over the chunk's rows, read-modify-write of the f32 dW in
//      device memory once per chunk (the first chunk stores). After the last
//      chunk one small kernel sums the column partials into db.
// s is computed once: 3 * 2NDV in all, against the TPU decomposition's 4.
// Every sum has a fixed order (no atomics), so the result is deterministic.

#include "common.cuh"

namespace {

constexpr int BM = 128;  // rows (or output rows) per CTA
constexpr int BN = 128;  // columns per CTA
constexpr int BKC = 64;  // reduction chunk of the ds and dx kernels
constexpr int BKW = 32;  // reduction chunk (rows) of the dW kernel
constexpr int NTHREADS = 256;
constexpr int LDS = BKC + 8;

__device__ __forceinline__ __nv_bfloat16 to_bf16(float v) { return __float2bfloat16(v); }
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 v) { return v; }

struct DsParams {
  const __nv_bfloat16* x;  // [rows, D] (the chunk)
  const void* w;           // [D, V] (untied) or [V, D] (tied)
  const float* bias;       // [V] or null
  const int* labels;       // [rows]
  const float *lse, *ent, *dlp, *dlse, *dent;  // [rows]
  __nv_bfloat16* ds;       // [C, ldv]
  float* dbpart;           // [ceil(rows / BM), V] (this chunk's row tiles) or null
  __nv_bfloat16* dx;       // [rows, D]
  int rows, D, V, ldv;
};

// Acc[16 rows per warp x 128 cols] += A[BM x BKC] . B^T, with A = As rows and
// B = Bs rows (both [row][k] in shared memory).
__device__ __forceinline__ void tile_mma(float (&acc)[BN / 8][4], const __nv_bfloat16* As,
                                         const __nv_bfloat16* Bs, int warp, int g, int t) {
  const __nv_bfloat16* ar0 = As + (warp * 16 + g) * LDS;
  const __nv_bfloat16* ar1 = ar0 + 8 * LDS;
#pragma unroll
  for (int ks = 0; ks < BKC / 16; ++ks) {
    const int c = ks * 16 + 2 * t;
    uint32_t a[4];
    a[0] = *reinterpret_cast<const uint32_t*>(ar0 + c);
    a[1] = *reinterpret_cast<const uint32_t*>(ar1 + c);
    a[2] = *reinterpret_cast<const uint32_t*>(ar0 + c + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(ar1 + c + 8);
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
      const __nv_bfloat16* br = Bs + (nb * 8 + g) * LDS;
      uint32_t b[2];
      b[0] = *reinterpret_cast<const uint32_t*>(br + c);
      b[1] = *reinterpret_cast<const uint32_t*>(br + c + 8);
      mma_bf16_16816(acc[nb], a, b);
    }
  }
}

// ---------------------------------------------------------------------------
// 1. ds (and the column partials of db)
// ---------------------------------------------------------------------------

template <typename WT, bool TIED>
__global__ void __launch_bounds__(NTHREADS) logprob_ds_kernel(DsParams p) {
  __shared__ __align__(16) __nv_bfloat16 Xs[BM * LDS];
  __shared__ __align__(16) __nv_bfloat16 Wt[BN * LDS];  // [vocab col][k]
  __shared__ float colsum[NTHREADS / 32][BN];

  const int row_tile = blockIdx.x, vt = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int N = p.rows, D = p.D, V = p.V;
  const int i0 = row_tile * BM, v0 = vt * BN;
  const WT* W = static_cast<const WT*>(p.w);

  float s[BN / 8][4];
#pragma unroll
  for (int nb = 0; nb < BN / 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
  for (int k0 = 0; k0 < D; k0 += BKC) {
    __syncthreads();
    for (int i = threadIdx.x; i < BM * (BKC / 8); i += NTHREADS) {
      const int r = i / (BKC / 8), c = (i % (BKC / 8)) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (i0 + r < N) val = *reinterpret_cast<const uint4*>(p.x + (size_t)(i0 + r) * D + k0 + c);
      *reinterpret_cast<uint4*>(Xs + r * LDS + c) = val;
    }
    if (TIED) {
      for (int i = threadIdx.x; i < BN * BKC; i += NTHREADS) {
        const int nn = i / BKC, kk = i % BKC, col = v0 + nn;
        Wt[nn * LDS + kk] = col < V ? to_bf16(W[(size_t)col * D + k0 + kk]) : __float2bfloat16(0.f);
      }
    } else {
      for (int i = threadIdx.x; i < BN * BKC; i += NTHREADS) {
        const int kk = i / BN, nn = i % BN, col = v0 + nn;
        Wt[nn * LDS + kk] = col < V ? to_bf16(W[(size_t)(k0 + kk) * V + col]) : __float2bfloat16(0.f);
      }
    }
    __syncthreads();
    tile_mma(s, Xs, Wt, warp, g, t);
  }

  // Epilogue: ds per element, written in bf16; column sums in f32.
  const int row0 = i0 + warp * 16 + g, row1 = row0 + 8;
  float lse[2], E[2], dlp[2], dlse[2], dent[2];
  int y[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    const bool in = row < N;
    lse[r] = in ? p.lse[row] : 0.f;
    E[r] = in ? lse[r] - p.ent[row] : 0.f;
    dlp[r] = in ? p.dlp[row] : 0.f;
    dlse[r] = in ? p.dlse[row] : 0.f;
    dent[r] = in ? p.dent[row] : 0.f;
    y[r] = in ? p.labels[row] : -1;
  }
#pragma unroll
  for (int nb = 0; nb < BN / 8; ++nb) {
    float cs[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const int col = v0 + nb * 8 + 2 * t + (e & 1);
      float dsv = 0.f;
      if (col < V && (r ? row1 : row0) < N) {
        const float sv = s[nb][e] + (p.bias != nullptr ? p.bias[col] : 0.f);
        const float pv = expf(sv - lse[r]);
        const float hit = col == y[r] ? 1.f : 0.f;
        dsv = dlp[r] * (hit - pv) + dlse[r] * pv - dent[r] * pv * (sv - E[r]);
      }
      s[nb][e] = dsv;
      cs[e & 1] += dsv;
    }
    // Rows past the chunk's valid rows are written as zeros (the dx and dW
    // kernels then read no garbage).
    const int col = v0 + nb * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(p.ds + (size_t)(i0 + warp * 16 + g) * p.ldv + col) = pack_bf16(s[nb][0], s[nb][1]);
    *reinterpret_cast<uint32_t*>(p.ds + (size_t)(i0 + warp * 16 + g + 8) * p.ldv + col) =
        pack_bf16(s[nb][2], s[nb][3]);
    if (p.dbpart != nullptr) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float v = cs[j];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) colsum[warp][nb * 8 + 2 * t + j] = v;
      }
    }
  }
  if (p.dbpart != nullptr) {
    __syncthreads();
    if (threadIdx.x < BN) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < NTHREADS / 32; ++w) v += colsum[w][threadIdx.x];
      const int col = v0 + threadIdx.x;
      if (col < V) p.dbpart[(size_t)row_tile * V + col] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// 2. dx = ds . W^T (untied W [D, V]) or ds . W (tied W [V, D])
// ---------------------------------------------------------------------------

template <typename WT, bool TIED>
__global__ void __launch_bounds__(NTHREADS) logprob_dx_kernel(DsParams p) {
  __shared__ __align__(16) __nv_bfloat16 As[BM * LDS];  // ds [row][v]
  __shared__ __align__(16) __nv_bfloat16 Bs[BN * LDS];  // W as [d][v]

  const int row_tile = blockIdx.x, dt = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int D = p.D, V = p.V;
  const int i0 = row_tile * BM, d0 = dt * BN;
  const WT* W = static_cast<const WT*>(p.w);

  float acc[BN / 8][4];
#pragma unroll
  for (int nb = 0; nb < BN / 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
  for (int k0 = 0; k0 < p.ldv; k0 += BKC) {
    __syncthreads();
    for (int i = threadIdx.x; i < BM * (BKC / 8); i += NTHREADS) {
      const int r = i / (BKC / 8), c = (i % (BKC / 8)) * 8;
      *reinterpret_cast<uint4*>(As + r * LDS + c) =
          *reinterpret_cast<const uint4*>(p.ds + (size_t)(i0 + r) * p.ldv + k0 + c);
    }
    // Vocabulary rows past V hold undefined memory in no buffer here, but
    // the tail of W is still zeroed: 0 * garbage must never reach the sum.
    if (TIED) {
      for (int i = threadIdx.x; i < BN * BKC; i += NTHREADS) {
        const int kk = i / BN, nn = i % BN, v = k0 + kk;
        Bs[nn * LDS + kk] = v < V ? to_bf16(W[(size_t)v * D + d0 + nn]) : __float2bfloat16(0.f);
      }
    } else {
      for (int i = threadIdx.x; i < BN * BKC; i += NTHREADS) {
        const int nn = i / BKC, kk = i % BKC, v = k0 + kk;
        Bs[nn * LDS + kk] = v < V ? to_bf16(W[(size_t)(d0 + nn) * V + v]) : __float2bfloat16(0.f);
      }
    }
    __syncthreads();
    tile_mma(acc, As, Bs, warp, g, t);
  }

  const int row0 = i0 + warp * 16 + g, row1 = row0 + 8;
#pragma unroll
  for (int nb = 0; nb < BN / 8; ++nb) {
    const int col = d0 + nb * 8 + 2 * t;
    if (row0 < p.rows)
      *reinterpret_cast<uint32_t*>(p.dx + (size_t)row0 * D + col) = pack_bf16(acc[nb][0], acc[nb][1]);
    if (row1 < p.rows)
      *reinterpret_cast<uint32_t*>(p.dx + (size_t)row1 * D + col) = pack_bf16(acc[nb][2], acc[nb][3]);
  }
}

// ---------------------------------------------------------------------------
// 3. dW (+)= A^T . B over the chunk's rows, f32 read-modify-write
// ---------------------------------------------------------------------------

struct DwParams {
  const __nv_bfloat16* a;  // [rows, lda]: row k holds A^T's column k (m along the row)
  const __nv_bfloat16* b;  // [rows, ldb]
  float* out;              // [m_valid, ldo] f32
  int rows, lda, ldb, ldo, m_valid, n_valid, accumulate;
};

template <int BKR>
__global__ void __launch_bounds__(NTHREADS) logprob_dw_kernel(DwParams p) {
  constexpr int LDT = BM + 8;
  __shared__ __align__(16) __nv_bfloat16 As[BKR * LDT];  // [k][m]
  __shared__ __align__(16) __nv_bfloat16 Bs[BKR * LDT];  // [k][n]

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  float acc[BN / 8][4];
#pragma unroll
  for (int nb = 0; nb < BN / 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
  for (int k0 = 0; k0 < p.rows; k0 += BKR) {
    __syncthreads();
    for (int i = threadIdx.x; i < BKR * (BM / 8); i += NTHREADS) {
      const int r = i / (BM / 8), c = (i % (BM / 8)) * 8;
      const bool in = k0 + r < p.rows;
      uint4 va = make_uint4(0, 0, 0, 0), vb = make_uint4(0, 0, 0, 0);
      if (in && m0 + c < p.lda) va = *reinterpret_cast<const uint4*>(p.a + (size_t)(k0 + r) * p.lda + m0 + c);
      if (in && n0 + c < p.ldb) vb = *reinterpret_cast<const uint4*>(p.b + (size_t)(k0 + r) * p.ldb + n0 + c);
      *reinterpret_cast<uint4*>(As + r * LDT + c) = va;
      *reinterpret_cast<uint4*>(Bs + r * LDT + c) = vb;
    }
    __syncthreads();
    const int m = warp * 16 + g;
#pragma unroll
    for (int ks = 0; ks < BKR / 16; ++ks) {
      const int r = ks * 16 + 2 * t;
      uint32_t a[4];
      a[0] = pack_bf16_pair(As + r * LDT + m, As + (r + 1) * LDT + m);
      a[1] = pack_bf16_pair(As + r * LDT + m + 8, As + (r + 1) * LDT + m + 8);
      a[2] = pack_bf16_pair(As + (r + 8) * LDT + m, As + (r + 9) * LDT + m);
      a[3] = pack_bf16_pair(As + (r + 8) * LDT + m + 8, As + (r + 9) * LDT + m + 8);
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb) {
        const int n = nb * 8 + g;
        uint32_t b[2];
        b[0] = pack_bf16_pair(Bs + r * LDT + n, Bs + (r + 1) * LDT + n);
        b[1] = pack_bf16_pair(Bs + (r + 8) * LDT + n, Bs + (r + 9) * LDT + n);
        mma_bf16_16816(acc[nb], a, b);
      }
    }
  }

  const int mr0 = m0 + warp * 16 + g, mr1 = mr0 + 8;
#pragma unroll
  for (int nb = 0; nb < BN / 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = e < 2 ? mr0 : mr1;
      const int n = n0 + nb * 8 + 2 * t + (e & 1);
      if (m < p.m_valid && n < p.n_valid) {
        float* o = p.out + (size_t)m * p.ldo + n;
        *o = p.accumulate ? *o + acc[nb][e] : acc[nb][e];
      }
    }
  }
}

// db[v] = sum over the row tiles of the column partials, in row-tile order.
__global__ void logprob_db_kernel(const float* dbpart, float* db, int n_tiles, int V) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  float s = 0.f;
  for (int i = 0; i < n_tiles; ++i) s += dbpart[(size_t)i * V + v];
  db[v] = s;
}

template <typename WT, bool TIED>
cudaError_t launch_ds_dx(const DsParams& p, cudaStream_t stream) {
  dim3 grid_ds((p.rows + BM - 1) / BM, p.ldv / BN);
  logprob_ds_kernel<WT, TIED><<<grid_ds, NTHREADS, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_dx((p.rows + BM - 1) / BM, p.D / BN);
  logprob_dx_kernel<WT, TIED><<<grid_dx, NTHREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// One chunk of rows: ds (bf16 [C, ldv], C >= rows rounded up to 128) and the
// db column partials, then dx. ldv = V rounded up to 128.
extern "C" int fused_logprob_bwd_ds_dx(const void* x, const void* w, const void* bias, const void* labels,
                                       const void* lse, const void* ent, const void* dlp, const void* dlse,
                                       const void* dent, void* ds, void* dbpart, void* dx, int rows, int D, int V,
                                       int ldv, int C, int tied, int w_is_bf16, void* stream) {
  if (D % BN != 0 || ldv % BN != 0 || ldv < V || rows > C || C % BM != 0) return (int)cudaErrorInvalidValue;
  DsParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = w;
  p.bias = static_cast<const float*>(bias);
  p.labels = static_cast<const int*>(labels);
  p.lse = static_cast<const float*>(lse);
  p.ent = static_cast<const float*>(ent);
  p.dlp = static_cast<const float*>(dlp);
  p.dlse = static_cast<const float*>(dlse);
  p.dent = static_cast<const float*>(dent);
  p.ds = static_cast<__nv_bfloat16*>(ds);
  p.dbpart = static_cast<float*>(dbpart);
  p.dx = static_cast<__nv_bfloat16*>(dx);
  p.rows = rows; p.D = D; p.V = V; p.ldv = ldv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_is_bf16)
    return (int)(tied ? launch_ds_dx<__nv_bfloat16, true>(p, s) : launch_ds_dx<__nv_bfloat16, false>(p, s));
  return (int)(tied ? launch_ds_dx<float, true>(p, s) : launch_ds_dx<float, false>(p, s));
}

// One chunk of rows: dW (f32; [D, V] untied, [V, D] tied) (+)= the chunk's
// product; with `db` set (the last chunk of a call with a bias), also sums
// the n_tiles column partials into db.
extern "C" int fused_logprob_bwd_dw(const void* x, const void* ds, void* dw, int rows, int D, int V, int ldv,
                                    int tied, int accumulate, const void* dbpart, void* db, int n_tiles,
                                    void* stream) {
  if (D % BN != 0 || ldv % BN != 0) return (int)cudaErrorInvalidValue;
  DwParams p;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* dsb = static_cast<const __nv_bfloat16*>(ds);
  if (tied) {  // dW[V, D] = ds^T . x
    p.a = dsb; p.lda = ldv; p.b = xb; p.ldb = D; p.ldo = D; p.m_valid = V; p.n_valid = D;
  } else {  // dW[D, V] = x^T . ds
    p.a = xb; p.lda = D; p.b = dsb; p.ldb = ldv; p.ldo = V; p.m_valid = D; p.n_valid = V;
  }
  p.out = static_cast<float*>(dw);
  p.rows = rows;
  p.accumulate = accumulate;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((p.m_valid + BM - 1) / BM, (p.n_valid + BN - 1) / BN);
  logprob_dw_kernel<BKW><<<grid, NTHREADS, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || db == nullptr) return (int)err;
  logprob_db_kernel<<<(V + 255) / 256, 256, 0, s>>>(static_cast<const float*>(dbpart), static_cast<float*>(db),
                                                    n_tiles, V);
  return (int)cudaGetLastError();
}
