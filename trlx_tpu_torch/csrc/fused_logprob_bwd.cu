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
// V = 50400) runs the same three steps, the same epilogues and the same db
// merge with ds kept in f32 (the TPU kernels round ds to x's dtype, here
// f32) and dx, dW and db in f32, all three products on the 3xTF32 mainloop
// of logprob_gemm_tf32.cuh (f32-accurate products as three TF32 passes,
// 128 x 128 tiles): 3 x 2NDV = 10.1 TFLOP a call at that shape (s again,
// dx, dW), bound by operations (three TF32 passes of it at 495 TFLOP/s take
// 61 ms). The dW kernel first transposes x into an f32 scratch, so both of
// its operands reach the mainloop in forms it reads (see below).

#include "logprob_gemm.cuh"
#include "logprob_gemm_tf32.cuh"
#include "logprob_math.cuh"

namespace {

constexpr int DS_LD = 128;  // ds rows are padded to a multiple of this (ldv)
constexpr int BAR_COLSUM = 1;  // named barrier of the ds kernel's column sums

// T: the type of ds and dx (bf16, or f32 in the f32-activation mode).
template <typename T>
struct DsParamsT {
  const float* bias;                           // [V] or null
  const int* labels;                           // [rows]
  const float *lse, *ent, *dlp, *dlse, *dent;  // [rows]
  T* ds;                                       // [C, ldv]
  float* dbpart;                               // [ceil(rows / 128), V] (this chunk's row tiles) or null
  T* dx;                                       // [rows, D]
  int rows, D, V, ldv, tiles_per_split;
};
using DsParams = DsParamsT<__nv_bfloat16>;
using DsF32Params = DsParamsT<float>;

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
  const int V = p.V;
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
  const int row0 = m0 + cwarp * 16 + g;
  const DsRows d = ds_rows(p, row0, row0 + 8);

  float acc[GEMM_NACC];
  uint32_t it = 0;
  for (int vt = vt_lo; vt < vt_hi; ++vt) {
    gemm_tile<TIED>(ring, acc, cw, nk, it);
    float* cs_buf = colsum + ((vt - vt_lo) & 1) * 8 * GEMM_BN;
    ds_tile<GEMM_BN>(acc, p, d, vt * GEMM_BN, row0, row_tile, cwarp, g, t4, tid, cs_buf, BAR_COLSUM);
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
// The f32-activation mode: ds, dx and dW on the 3xTF32 mainloop
// (logprob_gemm_tf32.cuh, 128 x 128 tiles)
// ---------------------------------------------------------------------------

// Past the f32 ring and split buffers: two [8 warps][128] column-sum buffers.
constexpr int DS_F32_COLSUM = TG_SMEM_BYTES;
constexpr int DS_F32_SMEM_BYTES = DS_F32_COLSUM + 2 * 8 * TG_BN * 4;

// 1. ds in f32 over the chunk's row tile and V split, with the db column
// partials, as logprob_ds_kernel does: TIED W [V, D] is a K-major B, untied
// W [D, V] an MN-major one.
template <bool TIED>
__global__ void __launch_bounds__(TG_THREADS, 1)
    logprob_ds_f32_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                          DsF32Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  const TgRing ring{sm, smem_u32(sm)};
  float* colsum = reinterpret_cast<float*>(sm + DS_F32_COLSUM);
  const int row_tile = blockIdx.x, split = blockIdx.y;
  const int m0 = row_tile * TG_BM;
  const int n_vt = (p.V + TG_BN - 1) / TG_BN;
  const int vt_lo = split * p.tiles_per_split;
  const int vt_hi = min(vt_lo + p.tiles_per_split, n_vt);
  const int nk = tg_chunks(p.D);

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) tg_produce<TIED>(ring, &tx, &tw, m0, vt_lo, vt_hi, nk);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wg - 1, tid = threadIdx.x - 128;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int cwarp = cw * 4 + warp;
  const int row0 = m0 + cwarp * 16 + g;
  const DsRows d = ds_rows(p, row0, row0 + 8);

  float acc[TG_NACC];
  uint32_t it = 0;
  for (int vt = vt_lo; vt < vt_hi; ++vt) {
    tg_tile<TIED>(ring, acc, cw, tid, nk, it);
    float* cs_buf = colsum + ((vt - vt_lo) & 1) * 8 * TG_BN;
    ds_tile<TG_BN>(acc, p, d, vt * TG_BN, row0, row_tile, cwarp, g, t4, tid, cs_buf, BAR_COLSUM);
  }
}

// 2. dx = ds . W^T (untied W [D, V], a K-major B) or ds . W (tied W [V, D],
// MN-major), f32, one CTA per 128 x 128 output tile, reducing over the
// vocabulary (ds is zero past V up to ldv; TMA fills zeros past that).
template <bool TIED>
__global__ void __launch_bounds__(TG_THREADS, 1)
    logprob_dx_f32_kernel(const __grid_constant__ CUtensorMap tds, const __grid_constant__ CUtensorMap tw,
                          DsF32Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  const TgRing ring{sm, smem_u32(sm)};
  const int m0 = blockIdx.x * TG_BM, dt = blockIdx.y;
  const int nk = tg_chunks(p.V);

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) tg_produce<!TIED>(ring, &tds, &tw, m0, dt, dt + 1, nk);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wg - 1, tid = threadIdx.x - 128;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = m0 + cw * 64 + warp * 16 + g;
  float acc[TG_NACC];
  uint32_t it = 0;
  tg_tile<!TIED>(ring, acc, cw, tid, nk, it);
#pragma unroll
  for (int j = 0; j < TG_BN / 8; ++j) {
    const int col = dt * TG_BN + 8 * j + 2 * t4;
    if (col < p.D) {
      if (row0 < p.rows) store_pair(p.dx + (size_t)row0 * p.D + col, acc[4 * j], acc[4 * j + 1]);
      if (row0 + 8 < p.rows) store_pair(p.dx + (size_t)(row0 + 8) * p.D + col, acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

template <bool TIED>
cudaError_t launch_ds_dx_f32(const CUtensorMap& tx, const CUtensorMap& tw_s, const CUtensorMap& tds,
                             const CUtensorMap& tw_dx, const DsF32Params& p, int splits, cudaStream_t stream) {
  const int ds_smem = DS_F32_SMEM_BYTES + 1024, dx_smem = TG_SMEM_BYTES + 1024;  // room to align to 1024
  cudaError_t err = set_gemm_smem(logprob_ds_f32_kernel<TIED>, ds_smem);
  if (err != cudaSuccess) return err;
  err = set_gemm_smem(logprob_dx_f32_kernel<TIED>, dx_smem);
  if (err != cudaSuccess) return err;
  const int row_tiles = (p.rows + TG_BM - 1) / TG_BM;
  logprob_ds_f32_kernel<TIED><<<dim3(row_tiles, splits), TG_THREADS, ds_smem, stream>>>(tx, tw_s, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  logprob_dx_f32_kernel<TIED><<<dim3(row_tiles, (p.D + TG_BN - 1) / TG_BN), TG_THREADS, dx_smem, stream>>>(
      tds, tw_dx, p);
  return cudaGetLastError();
}

// 3. dW in f32 as one product for both cases, C = x^T . ds [D, V] over the
// rows (M over D, N over V, K over the rows): untied dW = C, tied dW = C^T
// ([V, D]), stored transposed by the epilogue. TF32 wgmma reads its shared
// operands K-major only and A not transposed, and both x [rows, D] and ds
// [rows, ldv] keep their output dimension contiguous (MN-major), so:
// - A = x^T comes from a scratch [D, ldr] (ldr = rows rounded up to 4: TMA
//   takes 16-byte row strides) that transpose_f32_kernel writes first; its
//   TMA map ends at `rows` and fills zeros past it, so the pad columns are
//   never written or read. A's boxes and fragments are then the forward's.
// - B = ds is MN-major, split and transposed by the consumers (tg_split_b),
//   as the untied forward takes W [D, V].
// So this is tg_tile<false>, the untied forward's call, over K = rows.

constexpr int XT_TILE = 32;  // the transpose's square tile
constexpr int XT_ROWS = 8;   // thread rows of its block (32 x 8 threads)
// m-tiles of a group of the dW walk (see dw_f32_tile).
constexpr int DW_GROUP_M = 12;

// xt[d][r] = x[r][d] for r < rows, d < D (x [rows, D] contiguous, xt row
// stride ldr): block (rb, db) moves the 32 x 32 tile at rows 32 rb, columns
// 32 db through shared memory; thread (tx, ty) reads x[32 rb + ty + 8 i][32
// db + tx] (a warp reads 32 consecutive floats) and writes xt[32 db + ty + 8
// i][32 rb + tx] (likewise), i = 0..3. The 33-float row pitch keeps both
// sides free of bank conflicts.
__global__ void __launch_bounds__(XT_TILE * XT_ROWS)
    transpose_f32_kernel(const float* __restrict__ x, float* __restrict__ xt, int rows, int D, int ldr) {
  __shared__ float tile[XT_TILE][XT_TILE + 1];
  const int r0 = blockIdx.x * XT_TILE, d0 = blockIdx.y * XT_TILE;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int i = 0; i < XT_TILE / XT_ROWS; ++i) {
    const int j = ty + XT_ROWS * i, r = r0 + j, d = d0 + tx;
    if (r < rows && d < D) tile[j][tx] = x[(size_t)r * D + d];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < XT_TILE / XT_ROWS; ++i) {
    const int j = ty + XT_ROWS * i, d = d0 + j, r = r0 + tx;
    if (d < D && r < rows) xt[(size_t)d * ldr + r] = tile[tx][j];
  }
}

struct DwF32Params {
  float* out;  // untied [D, V], tied [V, D]
  int D, V, nk, m_tiles, n_tiles, tied;
};

// Output tile t of the persistent walk over C's m_tiles x n_tiles tiles:
// groups of DW_GROUP_M m-tiles (the last group may be narrower), and in a
// group the m-tile fastest, so the tiles t .. t + 131 that 132 CTAs run
// together span ~12 m-tiles by ~11 n-tiles.
// Why (L2 reuse, at D = 8192, V = 50400, rows = 4092: 64 x 394 tiles, 192
// waves): each tile reads one x^T panel and one ds panel of 128 x 4092 f32,
// 2.1 MB each, and the CTAs of a wave walk their reductions about together,
// so the tiles of a wave that share a panel read it from the 50 MB L2 and
// memory serves about the distinct panels a wave touches. Row 6's order
// (m-tile fastest over all 64, the ds panel slowest) touches all 64 x^T
// panels and 3 ds panels a wave: 140 MB, more than the L2 holds, 26.8 GB a
// call (8.0 ms at 3.35 TB/s). Groups of 12 touch 23 panels in the median
// wave, 48 MB, 9.7 GB a call (2.9 ms).
__device__ __forceinline__ void dw_f32_tile(const DwF32Params& p, int t, int& mt, int& nt) {
  const int per_group = DW_GROUP_M * p.n_tiles;
  const int m_first = t / per_group * DW_GROUP_M;
  const int gm = min(DW_GROUP_M, p.m_tiles - m_first);
  const int local = t % per_group;
  mt = m_first + local % gm;
  nt = local / gm;
}

// A persistent grid of min(tiles, SMs) CTAs, each walking the output tiles
// t = blockIdx.x, + gridDim.x, ...: the producer issues every tile's chunks
// into one ring (its `it` runs on across tiles), the consumers finish a tile
// (tg_tile ends with no wgmma in flight), store it from registers and go on.
// The split buffers' one-barrier-a-chunk argument (logprob_gemm_tf32.cuh)
// holds across a tile boundary: both warpgroups take the same chunks in the
// same order, and the epilogue between two tiles touches no shared memory.
__global__ void __launch_bounds__(TG_THREADS, 1)
    logprob_dw_f32_kernel(const __grid_constant__ CUtensorMap txt, const __grid_constant__ CUtensorMap tds,
                          DwF32Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  const TgRing ring{sm, smem_u32(sm)};
  const int tiles = p.m_tiles * p.n_tiles;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      uint32_t it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int mt, nt;
        dw_f32_tile(p, t, mt, nt);
        tg_produce_tile<false>(ring, &txt, &tds, mt * TG_BM, nt * TG_BN, p.nk, it);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wg - 1, ct = threadIdx.x - 128;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool pairs = (p.V & 1) == 0;  // untied rows of even length: 8-byte aligned column pairs
  float acc[TG_NACC];
  uint32_t it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int mt, nt;
    dw_f32_tile(p, t, mt, nt);
    tg_tile<false>(ring, acc, cw, ct, p.nk, it);
    const int d0 = mt * TG_BM + cw * 64 + warp * 16 + g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = d0 + 8 * h;  // C's row: a column of x
      if (d >= p.D) continue;
#pragma unroll
      for (int j = 0; j < TG_BN / 8; ++j) {
        const int v = nt * TG_BN + 8 * j + 2 * t4;  // C's column: a vocabulary entry
        const float c0 = acc[4 * j + 2 * h], c1 = acc[4 * j + 2 * h + 1];
        if (p.tied) {
          if (v < p.V) p.out[(size_t)v * p.D + d] = c0;
          if (v + 1 < p.V) p.out[(size_t)(v + 1) * p.D + d] = c1;
        } else if (pairs && v + 1 < p.V) {
          store_pair(p.out + (size_t)d * p.V + v, c0, c1);
        } else {
          if (v < p.V) p.out[(size_t)d * p.V + v] = c0;
          if (v + 1 < p.V) p.out[(size_t)d * p.V + v + 1] = c1;
        }
      }
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
// ldw (a multiple of 4, the base 16-byte aligned: what TMA takes): [D, V]
// untied, [V, D] tied. `splits` V splits of 128-column tiles for the ds grid.
extern "C" int fused_logprob_bwd_ds_dx_f32(const void* x, const void* w, const void* bias, const void* labels,
                                           const void* lse, const void* ent, const void* dlp, const void* dlse,
                                           const void* dent, void* ds, void* dbpart, void* dx, int rows, int D,
                                           int V, int ldv, int C, int ldw, int tied, int splits, void* stream) {
  if (rows < 1 || D % 4 != 0 || ldv % DS_LD != 0 || ldv < V || rows > C || C % TG_BM != 0 || ldw % 4 != 0 ||
      splits < 1)
    return (int)cudaErrorInvalidValue;
  // W as the B of s = x . W (tied: K-major, one 128-row box a chunk; untied:
  // MN-major, four 32 x 32 boxes) and as the B of dx (the other way round).
  CUtensorMap tx, tw_s, tds, tw_dx;
  const bool ok =
      make_map_2d<4>(&tx, x, D, rows, D, TG_BM) && make_map_2d<4>(&tds, ds, ldv, rows, ldv, TG_BM) &&
      (tied ? make_map_2d<4>(&tw_s, w, D, V, ldw, TG_BN) && make_map_2d<4>(&tw_dx, w, D, V, ldw, TG_BK)
            : make_map_2d<4>(&tw_s, w, V, D, ldw, TG_BK) && make_map_2d<4>(&tw_dx, w, V, D, ldw, TG_BN));
  if (!ok) return (int)cudaErrorInvalidValue;
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
  const int n_vt = (V + TG_BN - 1) / TG_BN;
  p.tiles_per_split = (n_vt + splits - 1) / splits;
  splits = (n_vt + p.tiles_per_split - 1) / p.tiles_per_split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(tied ? launch_ds_dx_f32<true>(tx, tw_s, tds, tw_dx, p, splits, s)
                    : launch_ds_dx_f32<false>(tx, tw_s, tds, tw_dx, p, splits, s));
}

// The f32 mode: dW (f32; [D, V] untied, [V, D] tied) of `rows` rows of x
// [rows, D] and ds [rows, ldv] (f32, zero past V), each element stored
// once: x transposed into the scratch xt [D, ldr] (ldr >= rows, a multiple
// of 4), then the dW kernel on a persistent grid of min(tiles, sms) CTAs;
// with `db` set, also sums the n_tiles column partials into db.
extern "C" int fused_logprob_bwd_dw_f32(const void* x, const void* ds, void* xt, void* dw, int rows, int D, int V,
                                        int ldv, int ldr, int tied, const void* dbpart, void* db, int n_tiles,
                                        int sms, void* stream) {
  if (rows < 1 || D < 1 || V < 1 || ldv % DS_LD != 0 || ldv < V || ldr < rows || ldr % 4 != 0 || sms < 1 ||
      (D + XT_TILE - 1) / XT_TILE > 65535)
    return (int)cudaErrorInvalidValue;
  // A = x^T: (reduction, row) = (r, d), 128-row boxes; B = ds MN-major:
  // (column, reduction) = (v, r), four 32 x 32 boxes a chunk.
  CUtensorMap txt, tds;
  if (!make_map_2d<4>(&txt, xt, rows, D, ldr, TG_BM) || !make_map_2d<4>(&tds, ds, V, rows, ldv, TG_BK))
    return (int)cudaErrorInvalidValue;
  DwF32Params p;
  p.out = static_cast<float*>(dw);
  p.D = D; p.V = V; p.tied = tied;
  p.nk = tg_chunks(rows);
  p.m_tiles = (D + TG_BM - 1) / TG_BM;
  p.n_tiles = (V + TG_BN - 1) / TG_BN;
  const int smem = TG_SMEM_BYTES + 1024;  // room to align to 1024
  cudaError_t err = set_gemm_smem(logprob_dw_f32_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 xt_grid((rows + XT_TILE - 1) / XT_TILE, (D + XT_TILE - 1) / XT_TILE);
  const float* xp = static_cast<const float*>(x);
  transpose_f32_kernel<<<xt_grid, dim3(XT_TILE, XT_ROWS), 0, s>>>(xp, static_cast<float*>(xt), rows, D, ldr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  logprob_dw_f32_kernel<<<min(p.m_tiles * p.n_tiles, sms), TG_THREADS, smem, s>>>(txt, tds, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || db == nullptr) return (int)err;
  logprob_db_kernel<<<(V + 255) / 256, 256, 0, s>>>(static_cast<const float*>(dbpart), static_cast<float*>(db),
                                                    n_tiles, V);
  return (int)cudaGetLastError();
}
