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
// the bf16 peak), against ~1.2 GB of W in and dW out (0.37 ms): the tensor
// cores bound it. The TPU kernels keep a [128, D] dx accumulator and a
// [D, 256] dW accumulator in VMEM (2 MB and 4 MB); an SM has 228 KB of
// shared memory, and splitting D instead would recompute s D/bd times. So the
// work is cut along N instead. The wrapper walks N in chunks of C rows (C =
// 1024: a bf16 [C, ldv] ds buffer of ~103 MB, never a full [N, V] one), and
// per chunk launches
//   1. the ds kernel: the GEMM mainloop of logprob_gemm.cuh (TMA ring +
//      wgmma, warp-specialised) over x . W, grid = 128-row tiles x V splits
//      (one CTA per SM), each CTA walking its split's 256-column tiles; the
//      epilogue adds the bias in f32, forms ds in f32 on the accumulator
//      fragment, writes it in bf16 (zero past V and for rows past the
//      chunk's) and the tile's f32 column sums of ds (for db, merged later
//      in a fixed order);
//   2. the dx kernel: dx[C, D] = ds . W^T on the same mainloop, one CTA per
//      128 x 256 output tile (128 CTAs at C = 1024, D = 4096: one wave),
//      each reducing over the whole vocabulary with ds and W by TMA;
//   3. the dW kernel (a separate C entry): dW += x^T . ds, a tiled mma.sync
//      product reducing over the chunk's rows, read-modify-write of the f32
//      dW in device memory once per chunk (the first chunk stores). After
//      the last chunk one small kernel sums the column partials into db.
// W comes in bf16 (the wrapper's one cast of an f32 master, or the
// forward's copy), its rows 16-byte aligned for TMA. s is computed once:
// 3 * 2NDV in all, against the TPU decomposition's 4. Every sum has a fixed
// order (no atomics), so two calls give the same bits.

#include "logprob_gemm.cuh"

namespace {

// The dW kernel's tiles (mma.sync, 8 warps).
constexpr int BM = 128;  // output rows per CTA
constexpr int BN = 128;  // output columns per CTA
constexpr int BKW = 32;  // reduction chunk (rows)
constexpr int NTHREADS = 256;
constexpr int DS_LD = 128;  // ds rows are padded to a multiple of this (ldv)
constexpr int BAR_COLSUM = 1;  // named barrier of the ds kernel's column sums

struct DsParams {
  const float* bias;                           // [V] or null
  const int* labels;                           // [rows]
  const float *lse, *ent, *dlp, *dlse, *dent;  // [rows]
  __nv_bfloat16* ds;                           // [C, ldv]
  float* dbpart;                               // [ceil(rows / 128), V] (this chunk's row tiles) or null
  __nv_bfloat16* dx;                           // [rows, D]
  int rows, D, V, ldv, tiles_per_split;
};

// ---------------------------------------------------------------------------
// 1. ds (and the column partials of db)
// ---------------------------------------------------------------------------

// Shared memory past the ring: two [8 warps][256] f32 column-sum buffers,
// used by alternate tiles, so one named barrier a tile orders their reuse.
constexpr int DS_COLSUM = GEMM_SMEM_BYTES;
constexpr int DS_SMEM_BYTES = DS_COLSUM + 2 * 8 * GEMM_BN * 4;

template <bool TIED>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    logprob_ds_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw, DsParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  const GemmRing ring{smem_u32(sm)};
  float* colsum = reinterpret_cast<float*>(sm + DS_COLSUM);
  const int row_tile = blockIdx.x, split = blockIdx.y;
  const int N = p.rows, V = p.V;
  const int m0 = row_tile * GEMM_BM;
  const int n_vt = (V + GEMM_BN - 1) / GEMM_BN;
  const int vt_lo = split * p.tiles_per_split;
  const int vt_hi = min(vt_lo + p.tiles_per_split, n_vt);
  const int nk = p.D / GEMM_BK;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) gemm_produce<TIED>(ring, &tx, &tw, m0, vt_lo, vt_hi, nk);
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int cwarp = cw * 4 + warp;  // 0..7: the warp's 16 rows of the tile
  const int tid = threadIdx.x - 128;  // 0..255
  const int row0 = m0 + cwarp * 16 + g, row1 = row0 + 8;
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
  const bool in0 = row0 < N, in1 = row1 < N;

  float acc[GEMM_NACC];
  uint32_t it = 0;
  for (int vt = vt_lo; vt < vt_hi; ++vt) {
    gemm_tile<TIED>(ring, acc, cw, nk, it);
    const int v0 = vt * GEMM_BN;
    float* cs_buf = colsum + ((vt - vt_lo) & 1) * 8 * GEMM_BN;
#pragma unroll
    for (int j = 0; j < GEMM_BN / 8; ++j) {
      const int c0 = v0 + 8 * j + 2 * t4;
      float cs[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = c0 + (e & 1);
        float dsv = 0.f;
        if (col < V && (r ? in1 : in0)) {
          const float sv = acc[4 * j + e] + (p.bias != nullptr ? __ldg(p.bias + col) : 0.f);
          const float pv = expf(sv - lse[r]);
          const float hit = col == y[r] ? 1.f : 0.f;
          dsv = dlp[r] * (hit - pv) + dlse[r] * pv - dent[r] * pv * (sv - E[r]);
        }
        acc[4 * j + e] = dsv;
        cs[e & 1] += dsv;
      }
      // Every row of the tile is written (zeros past the chunk's rows and
      // past V), up to ldv: the dx and dW kernels then read no garbage.
      if (c0 < p.ldv) {
        *reinterpret_cast<uint32_t*>(p.ds + (size_t)row0 * p.ldv + c0) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(p.ds + (size_t)row1 * p.ldv + c0) = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
      }
      if (p.dbpart != nullptr) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = cs[h];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) cs_buf[cwarp * GEMM_BN + 8 * j + 2 * t4 + h] = v;
        }
      }
    }
    if (p.dbpart != nullptr) {
      // The 8 warps' sums of column tid, in warp order.
      named_sync(BAR_COLSUM, 256);
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) v += cs_buf[w * GEMM_BN + tid];
      const int col = v0 + tid;
      if (col < V) p.dbpart[(size_t)row_tile * V + col] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// 2. dx = ds . W^T (untied W [D, V]) or ds . W (tied W [V, D])
// ---------------------------------------------------------------------------

// Untied W [D, V] is a K-major B of this product (its rows are dx's
// columns); tied W [V, D] an MN-major one.
template <bool TIED>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    logprob_dx_kernel(const __grid_constant__ CUtensorMap tds, const __grid_constant__ CUtensorMap tw, DsParams p) {
  extern __shared__ unsigned char smem_raw[];
  const GemmRing ring{smem_u32(align_1024(smem_raw))};
  const int m0 = blockIdx.x * GEMM_BM, dt = blockIdx.y;
  const int nk = (p.V + GEMM_BK - 1) / GEMM_BK;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) gemm_produce<!TIED>(ring, &tds, &tw, m0, dt, dt + 1, nk);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = m0 + cw * 64 + warp * 16 + g, row1 = row0 + 8;
  float acc[GEMM_NACC];
  uint32_t it = 0;
  gemm_tile<!TIED>(ring, acc, cw, nk, it);
#pragma unroll
  for (int j = 0; j < GEMM_BN / 8; ++j) {
    const int col = dt * GEMM_BN + 8 * j + 2 * t4;
    if (col < p.D) {
      if (row0 < p.rows)
        *reinterpret_cast<uint32_t*>(p.dx + (size_t)row0 * p.D + col) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
      if (row1 < p.rows)
        *reinterpret_cast<uint32_t*>(p.dx + (size_t)row1 * p.D + col) = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
    }
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

template <bool TIED>
cudaError_t launch_ds_dx(const CUtensorMap& tx, const CUtensorMap& tw_s, const CUtensorMap& tds,
                         const CUtensorMap& tw_dx, const DsParams& p, int splits, cudaStream_t stream) {
  const int ds_smem = DS_SMEM_BYTES + 1024, dx_smem = GEMM_SMEM_BYTES + 1024;  // room to align to 1024
  cudaError_t err = set_gemm_smem(logprob_ds_kernel<TIED>, ds_smem);
  if (err != cudaSuccess) return err;
  err = set_gemm_smem(logprob_dx_kernel<TIED>, dx_smem);
  if (err != cudaSuccess) return err;
  const int row_tiles = (p.rows + GEMM_BM - 1) / GEMM_BM;
  logprob_ds_kernel<TIED><<<dim3(row_tiles, splits), GEMM_THREADS, ds_smem, stream>>>(tx, tw_s, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  logprob_dx_kernel<TIED><<<dim3(row_tiles, (p.D + GEMM_BN - 1) / GEMM_BN), GEMM_THREADS, dx_smem, stream>>>(
      tds, tw_dx, p);
  return cudaGetLastError();
}

}  // namespace

// One chunk of rows: ds (bf16 [C, ldv], C >= rows rounded up to 128) and the
// db column partials, then dx. ldv = V rounded up to 128. w is bf16 with row
// stride ldw elements (a multiple of 8, the base 16-byte aligned): [D, V]
// untied, [V, D] tied. `splits` V splits of the ds grid.
extern "C" int fused_logprob_bwd_ds_dx(const void* x, const void* w, const void* bias, const void* labels,
                                       const void* lse, const void* ent, const void* dlp, const void* dlse,
                                       const void* dent, void* ds, void* dbpart, void* dx, int rows, int D, int V,
                                       int ldv, int C, int ldw, int tied, int splits, void* stream) {
  if (D % GEMM_BK != 0 || ldv % DS_LD != 0 || ldv < V || rows > C || C % GEMM_BM != 0 || ldw % 8 != 0 ||
      splits < 1)
    return (int)cudaErrorInvalidValue;
  // W as the B of s = x . W (tied: K-major, one 256-row box a chunk; untied:
  // MN-major, four 64-row boxes) and as the B of dx (the other way round).
  CUtensorMap tx, tw_s, tds, tw_dx;
  const bool ok =
      make_map_2d(&tx, x, D, rows, D, GEMM_BM) && make_map_2d(&tds, ds, ldv, rows, ldv, GEMM_BM) &&
      (tied ? make_map_2d(&tw_s, w, D, V, ldw, GEMM_BN) && make_map_2d(&tw_dx, w, D, V, ldw, GEMM_BK)
            : make_map_2d(&tw_s, w, V, D, ldw, GEMM_BK) && make_map_2d(&tw_dx, w, V, D, ldw, GEMM_BN));
  if (!ok) return (int)cudaErrorInvalidValue;
  DsParams p;
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
  const int n_vt = (V + GEMM_BN - 1) / GEMM_BN;
  p.tiles_per_split = (n_vt + splits - 1) / splits;
  splits = (n_vt + p.tiles_per_split - 1) / p.tiles_per_split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(tied ? launch_ds_dx<true>(tx, tw_s, tds, tw_dx, p, splits, s)
                    : launch_ds_dx<false>(tx, tw_s, tds, tw_dx, p, splits, s));
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
