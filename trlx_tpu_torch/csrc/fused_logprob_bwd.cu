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
// work is cut along N instead. The wrapper walks N in chunks of C = 1024 rows
// for ds and dx, and per chunk launches
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
//   3. after the last chunk, the dW kernel (a separate C entry) over ds of
//      every chunk (the wrapper keeps a bf16 [N, ldv] ds, ~206 MB at
//      N = 2048): dW = x^T . ds (ds^T . x tied) on the same mainloop with
//      both operands MN-major, reducing over all N rows, so dW is written
//      once in f32 (826 MB at D = 4096, V = 50400: a read-modify-write per
//      chunk would move it three times); then one small kernel sums the db
//      column partials in row-tile order.
// The dW grid is persistent (one CTA per SM walking the 128 x 256 output
// tiles with a stride of the grid), ordered so that the tiles a wave runs
// together share their ds panel and walk the x panels, which (16 MB of x)
// stay in L2: ds is read from memory about once.
// W comes in bf16 (the wrapper's one cast of an f32 master, or the
// forward's copy), its rows 16-byte aligned for TMA. s is computed once:
// 3 * 2NDV in all, against the TPU decomposition's 4. Every sum has a fixed
// order (no atomics), so two calls give the same bits.
//
// The f32-activation mode (x, W f32: ILQL's Q heads, N = 4092, D = 8192,
// V = 50400) runs the same three steps and the same db merge on the SIMT
// mainloop of sgemm_f32.cuh, with ds kept in f32 (the TPU kernels round ds
// to x's dtype, here f32) and dx, dW and db in f32; 4 x 2NDV = 13.5 TFLOP a
// call at that shape, bound by operations.

#include "logprob_gemm.cuh"
#include "logprob_math.cuh"
#include "sgemm_f32.cuh"

namespace {

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
          dsv = ds_score(sv, lse[r], E[r], dlp[r], dlse[r], dent[r], col == y[r]);
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
// 3. dW = A^T . B over the rows, f32 (untied: x^T . ds; tied: ds^T . x)
// ---------------------------------------------------------------------------

// Both operands are held [rows, output dim] in memory with the output dim
// contiguous: MN-major A (two 64-row boxes a stage) and MN-major B (four
// 64-column boxes). Each output element is stored once.
struct DwParams {
  float* out;  // [m_valid, ldo]
  int m_valid, n_valid, ldo, nk, m_tiles, n_tiles, m_fastest;
};

// Output tile t of the walk: M-tile fastest when the ds operand is B
// (untied), N-tile fastest when it is A (tied).
__device__ __forceinline__ void dw_tile(const DwParams& p, int t, int& mt, int& nt) {
  if (p.m_fastest) {
    mt = t % p.m_tiles;
    nt = t / p.m_tiles;
  } else {
    nt = t % p.n_tiles;
    mt = t / p.n_tiles;
  }
}

__global__ void __launch_bounds__(GEMM_THREADS, 1)
    logprob_dw_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb, DwParams p) {
  extern __shared__ unsigned char smem_raw[];
  const GemmRing ring{smem_u32(align_1024(smem_raw))};
  const int n_tiles = p.m_tiles * p.n_tiles;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      uint32_t it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        int mt, nt;
        dw_tile(p, t, mt, nt);
        gemm_produce_tile<false, false>(ring, &ta, &tb, mt * GEMM_BM, nt * GEMM_BN, p.nk, it);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool pairs = (p.ldo & 1) == 0;  // 8-byte aligned column pairs
  float acc[GEMM_NACC];
  uint32_t it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int mt, nt;
    dw_tile(p, t, mt, nt);
    gemm_tile<false, false>(ring, acc, cw, p.nk, it);
    // The stores are issued and the next tile's products start behind them.
    const int row0 = mt * GEMM_BM + cw * 64 + warp * 16 + g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= p.m_valid) continue;
      float* orow = p.out + (size_t)row * p.ldo;
#pragma unroll
      for (int j = 0; j < GEMM_BN / 8; ++j) {
        const int col = nt * GEMM_BN + 8 * j + 2 * t4;
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (pairs && col + 1 < p.n_valid) {
          *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
        } else {
          if (col < p.n_valid) orow[col] = v0;
          if (col + 1 < p.n_valid) orow[col + 1] = v1;
        }
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

// ---------------------------------------------------------------------------
// The f32-activation mode on the SIMT mainloop (128 x 128 tiles)
// ---------------------------------------------------------------------------

struct DsF32Params {
  const float* bias;                           // [V] or null
  const int* labels;                           // [rows]
  const float *lse, *ent, *dlp, *dlse, *dent;  // [rows]
  float* ds;                                   // [C, ldv]
  float* dbpart;                               // [ceil(rows / 128), V] or null
  float* dx;                                   // [rows, D]
  int rows, D, V, ldv, tiles_per_split;
};

// 1. ds in f32 over the chunk's row tile and V split, every row of the tile
// written (zeros past the chunk's rows and past V); the db column partials
// summed over the tile's rows in a fixed order (each thread's 8 rows, then
// the 16 row groups in order).
template <bool TIED>
__global__ void __launch_bounds__(SG_THREADS, 2)
    logprob_ds_f32_kernel(const SgOperand x, const SgOperand w, DsF32Params p) {
  __shared__ __align__(16) SgSmem sm;
  __shared__ float colsum[16][SG_BN];
  const int row_tile = blockIdx.x, split = blockIdx.y;
  const int V = p.V;
  const int m0 = row_tile * SG_BM;
  const int n_vt = (V + SG_BN - 1) / SG_BN;
  const int vt_lo = split * p.tiles_per_split;
  const int vt_hi = min(vt_lo + p.tiles_per_split, n_vt);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  float acc[8][8];
  for (int vt = vt_lo; vt < vt_hi; ++vt) {
    const int v0 = vt * SG_BN;
    sgemm_tile<true, TIED>(sm, x, w, m0, v0, p.D, acc);
    float cs[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) cs[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      // The row's residuals and cotangents, read here rather than held in
      // registers across the mainloop.
      const int row = m0 + sg_row(ty, i);
      const bool in = row < p.rows;
      const float lse = in ? __ldg(p.lse + row) : 0.f;
      const float E = in ? lse - __ldg(p.ent + row) : 0.f;
      const float dlp = in ? __ldg(p.dlp + row) : 0.f;
      const float dlse = in ? __ldg(p.dlse + row) : 0.f;
      const float dent = in ? __ldg(p.dent + row) : 0.f;
      const int y = in ? __ldg(p.labels + row) : -1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = v0 + sg_col(tx, j);
        float dsv = 0.f;
        if (col < V && in) {
          const float sv = acc[i][j] + (p.bias != nullptr ? __ldg(p.bias + col) : 0.f);
          dsv = ds_score(sv, lse, E, dlp, dlse, dent, col == y);
        }
        acc[i][j] = dsv;
        cs[j] += dsv;
      }
      float* drow = p.ds + (size_t)(m0 + sg_row(ty, i)) * p.ldv + v0;
      *reinterpret_cast<float4*>(drow + 4 * tx) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(drow + 64 + 4 * tx) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    if (p.dbpart != nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j) colsum[ty][sg_col(tx, j)] = cs[j];
      __syncthreads();
      if (threadIdx.x < SG_BN) {
        float v = 0.f;
#pragma unroll
        for (int g = 0; g < 16; ++g) v += colsum[g][threadIdx.x];
        const int col = v0 + threadIdx.x;
        if (col < V) p.dbpart[(size_t)row_tile * V + col] = v;
      }
      // The next write to colsum follows the next tile's mainloop barriers.
    }
  }
}

// 2. dx = ds . W^T (untied W [D, V], a K-major B) or ds . W (tied W [V, D],
// MN-major), in f32, one CTA per 128 x 128 output tile.
template <bool TIED>
__global__ void __launch_bounds__(SG_THREADS, 2)
    logprob_dx_f32_kernel(const SgOperand ds, const SgOperand w, DsF32Params p) {
  __shared__ __align__(16) SgSmem sm;
  const int m0 = blockIdx.x * SG_BM, n0 = blockIdx.y * SG_BN;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[8][8];
  sgemm_tile<true, !TIED>(sm, ds, w, m0, n0, p.V, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + sg_row(ty, i);
    if (row >= p.rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + sg_col(tx, j);
      if (col < p.D) p.dx[(size_t)row * p.D + col] = acc[i][j];
    }
  }
}

// 3. dW = A^T . B over the rows, f32 (untied: x^T . ds -> [D, V]; tied:
// ds^T . x -> [V, D]), both operands MN-major, one CTA per 128 x 128 output
// tile, each element stored once. blockIdx.x walks the output rows, so the
// CTAs that run together share their B panel.
__global__ void __launch_bounds__(SG_THREADS, 2)
    logprob_dw_f32_kernel(const SgOperand a, const SgOperand b, float* out, int m_valid, int n_valid, int K) {
  __shared__ __align__(16) SgSmem sm;
  const int m0 = blockIdx.x * SG_BM, n0 = blockIdx.y * SG_BN;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[8][8];
  sgemm_tile<false, false>(sm, a, b, m0, n0, K, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + sg_row(ty, i);
    if (row >= m_valid) continue;
    float* orow = out + (size_t)row * n_valid;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + sg_col(tx, j);
      if (col < n_valid) orow[col] = acc[i][j];
    }
  }
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

// dW (f32; [D, V] untied, [V, D] tied) of `rows` rows of x [rows, D] and
// ds [rows, ldv] (bf16, zero past V), each element stored once. A
// persistent grid of min(tiles, sms) CTAs. With `db` set, also sums the
// n_tiles column partials into db.
extern "C" int fused_logprob_bwd_dw(const void* x, const void* ds, void* dw, int rows, int D, int V, int ldv,
                                    int tied, const void* dbpart, void* db, int n_tiles, int sms, void* stream) {
  if (D % GEMM_BK != 0 || ldv % DS_LD != 0 || ldv < V || rows < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  // Both maps are [rows, output dim] with boxes of 64 x 64.
  CUtensorMap tx, tds;
  if (!make_map_2d(&tx, x, D, rows, D, GEMM_BK) || !make_map_2d(&tds, ds, ldv, rows, ldv, GEMM_BK))
    return (int)cudaErrorInvalidValue;
  DwParams p;
  p.out = static_cast<float*>(dw);
  p.m_valid = tied ? V : D;
  p.n_valid = tied ? D : V;
  p.ldo = p.n_valid;
  p.nk = (rows + GEMM_BK - 1) / GEMM_BK;
  p.m_tiles = (p.m_valid + GEMM_BM - 1) / GEMM_BM;
  p.n_tiles = (p.n_valid + GEMM_BN - 1) / GEMM_BN;
  p.m_fastest = tied ? 0 : 1;  // keep the ds panel, walk the x panels
  const int smem = GEMM_SMEM_BYTES + 1024;  // room to align to 1024
  cudaError_t err = set_gemm_smem(logprob_dw_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = min(p.m_tiles * p.n_tiles, sms);
  logprob_dw_kernel<<<grid, GEMM_THREADS, smem, s>>>(tied ? tds : tx, tied ? tx : tds, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || db == nullptr) return (int)err;
  logprob_db_kernel<<<(V + 255) / 256, 256, 0, s>>>(static_cast<const float*>(dbpart), static_cast<float*>(db),
                                                    n_tiles, V);
  return (int)cudaGetLastError();
}

// The f32 mode, one chunk of rows: ds (f32 [C, ldv]) and the db column
// partials, then dx (f32 [rows, D]). x f32 [rows, D]; w f32 with row stride
// ldw and unit column stride: [D, V] untied, [V, D] tied. `splits` V splits
// of 128-column tiles for the ds grid.
extern "C" int fused_logprob_bwd_ds_dx_f32(const void* x, const void* w, const void* bias, const void* labels,
                                           const void* lse, const void* ent, const void* dlp, const void* dlse,
                                           const void* dent, void* ds, void* dbpart, void* dx, int rows, int D,
                                           int V, int ldv, int C, int ldw, int tied, int splits, void* stream) {
  if (rows < 1 || ldv % DS_LD != 0 || ldv < V || rows > C || C % SG_BM != 0 || splits < 1 || !aligned16(ds))
    return (int)cudaErrorInvalidValue;
  const SgOperand xo{static_cast<const float*>(x), D, rows, D, D % 4 == 0 && aligned16(x)};
  const int wvec = ldw % 4 == 0 && aligned16(w);
  const SgOperand wo = tied ? SgOperand{static_cast<const float*>(w), ldw, V, D, wvec}
                            : SgOperand{static_cast<const float*>(w), ldw, D, V, wvec};
  const SgOperand dso{static_cast<const float*>(ds), ldv, rows, V, 1};
  DsF32Params p;
  p.bias = static_cast<const float*>(bias);
  p.labels = static_cast<const int*>(labels);
  p.lse = static_cast<const float*>(lse);
  p.ent = static_cast<const float*>(ent);
  p.dlp = static_cast<const float*>(dlp);
  p.dlse = static_cast<const float*>(dlse);
  p.dent = static_cast<const float*>(dent);
  p.ds = static_cast<float*>(ds);
  p.dbpart = static_cast<float*>(dbpart);
  p.dx = static_cast<float*>(dx);
  p.rows = rows; p.D = D; p.V = V; p.ldv = ldv;
  const int n_vt = (V + SG_BN - 1) / SG_BN;
  p.tiles_per_split = (n_vt + splits - 1) / splits;
  splits = (n_vt + p.tiles_per_split - 1) / p.tiles_per_split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 ds_grid((rows + SG_BM - 1) / SG_BM, splits), dx_grid((rows + SG_BM - 1) / SG_BM, (D + SG_BN - 1) / SG_BN);
  if (tied) {
    logprob_ds_f32_kernel<true><<<ds_grid, SG_THREADS, 0, s>>>(xo, wo, p);
  } else {
    logprob_ds_f32_kernel<false><<<ds_grid, SG_THREADS, 0, s>>>(xo, wo, p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (tied) {
    logprob_dx_f32_kernel<true><<<dx_grid, SG_THREADS, 0, s>>>(dso, wo, p);
  } else {
    logprob_dx_f32_kernel<false><<<dx_grid, SG_THREADS, 0, s>>>(dso, wo, p);
  }
  return (int)cudaGetLastError();
}

// The f32 mode: dW (f32; [D, V] untied, [V, D] tied) of `rows` rows of x
// [rows, D] and ds [rows, ldv] (f32, zero past V), each element stored
// once; with `db` set, also sums the n_tiles column partials into db.
extern "C" int fused_logprob_bwd_dw_f32(const void* x, const void* ds, void* dw, int rows, int D, int V, int ldv,
                                        int tied, const void* dbpart, void* db, int n_tiles, void* stream) {
  if (rows < 1 || ldv % DS_LD != 0 || ldv < V || !aligned16(ds)) return (int)cudaErrorInvalidValue;
  const SgOperand xo{static_cast<const float*>(x), D, rows, D, D % 4 == 0 && aligned16(x)};
  const SgOperand dso{static_cast<const float*>(ds), ldv, rows, V, 1};
  const int m_valid = tied ? V : D, n_valid = tied ? D : V;
  const dim3 grid((m_valid + SG_BM - 1) / SG_BM, (n_valid + SG_BN - 1) / SG_BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  logprob_dw_f32_kernel<<<grid, SG_THREADS, 0, s>>>(tied ? dso : xo, tied ? xo : dso, static_cast<float*>(dw),
                                                   m_valid, n_valid, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || db == nullptr) return (int)err;
  logprob_db_kernel<<<(V + 255) / 256, 256, 0, s>>>(static_cast<const float*>(dbpart), static_cast<float*>(db),
                                                    n_tiles, V);
  return (int)cudaGetLastError();
}
