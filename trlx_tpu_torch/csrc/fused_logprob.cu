// Fused vocab projection + label logprob / log-sum-exp / entropy, forward,
// for Hopper (sm_90a): TMA loads into an mbarrier ring, wgmma on the tensor
// cores, bf16 in, f32 epilogue.
//
// Replaces: trlx_tpu/ops/fused_logprob.py:_fwd_kernel (pallas_call in
// _fwd_call; per-tile math in _tile_scores). For each row n of x [N, D]
// (bf16) it streams the bf16 head weight W ([D, V], or the tied embedding
// [V, D]; the wrapper casts an f32 master once per call, as the TPU kernel
// casts each tile to x's dtype) over the vocabulary, computes the scores
// s = x . W (+ bias, in f32) one 256-column tile at a time, and keeps the
// online max m, sum l = sum exp(s - m), r = sum exp(s - m) * s and the
// label's score, so that
//   lse = m + log l,  logprob = s_label - lse,  entropy = lse - r / l
// come out in f32 and no [N, V] buffer is ever formed. Columns past V are
// REPLACED by -1e9 with weight exactly 0 (`_tile_scores`'s mask).
//
// What bounds it on an H100: 2 * N * D * V flops (846 GFLOP at N = 2048,
// D = 4096, V = 50400) against ~0.43 GB of bf16 weight and activations
// (0.13 ms), so the tensor cores bound it (~0.86 ms at the bf16 peak).
//
// Design: the TPU grid walks V sequentially per row block; here the V axis
// is split across CTAs too (grid = 128-row tiles x V splits, sized by the
// wrapper for one CTA per SM), and each CTA runs the mainloop of
// logprob_gemm.cuh over its split's 256-column tiles, reducing each finished
// tile in its epilogue (bias, label, mask, online max and sums on the wgmma
// accumulator fragment: quad shuffles for the row max) while the producer
// already loads the next tile's chunks. Each CTA writes its partial
// (m, l, r, label score) per row; a second small kernel merges the splits
// of each row in split order into (logprob, lse, entropy).
//
// The f32-activation mode (x and W f32, as ILQL's Q heads call it: N = 4092,
// D = 8192, V = 50400) multiplies in f32 on the CUDA cores, on the SIMT
// mainloop of sgemm_f32.cuh, into the same epilogue arithmetic
// (logprob_math.cuh), partials and merge. It is bound by operations: 3.38
// TFLOP at that shape, against 1.8 GB of f32 weight and activations.

#include "logprob_gemm.cuh"
#include "logprob_math.cuh"
#include "sgemm_f32.cuh"

namespace {

struct LogprobParams {
  const float* bias;      // [V] or null
  const int* labels;      // [N]
  float* part;            // [4, S, N]: m, l, r, label score
  float *lp, *lse, *ent;  // [N]
  int N, D, V, S, tiles_per_split;
};

// TIED: W [V, D], a K-major B; untied W [D, V], an MN-major B.
template <bool TIED>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    logprob_fwd_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                       LogprobParams p) {
  extern __shared__ unsigned char smem_raw[];
  const GemmRing ring{smem_u32(align_1024(smem_raw))};
  const int row_tile = blockIdx.x, split = blockIdx.y;
  const int N = p.N, V = p.V;
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
  const int row0 = m0 + cw * 64 + warp * 16 + g, row1 = row0 + 8;
  const int y0 = row0 < N ? p.labels[row0] : -1;
  const int y1 = row1 < N ? p.labels[row1] : -1;

  float m0s = TRLX_M_INIT, m1s = TRLX_M_INIT, l0 = 0.f, l1 = 0.f, r0 = 0.f, r1 = 0.f, lab0 = 0.f, lab1 = 0.f;
  float acc[GEMM_NACC];
  uint32_t it = 0;
  for (int vt = vt_lo; vt < vt_hi; ++vt) {
    gemm_tile<TIED>(ring, acc, cw, nk, it);
    const int v0 = vt * GEMM_BN;

    // Tile epilogue: bias, label gather, tail mask, online max / sums.
    float mx0 = TRLX_MASK_VAL, mx1 = TRLX_MASK_VAL;
#pragma unroll
    for (int j = 0; j < GEMM_BN / 8; ++j) {
      const int c0 = v0 + 8 * j + 2 * t4;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sv = lp_score(acc[4 * j + e], p.bias, c0 + (e & 1), V, e < 2 ? y0 : y1, e < 2 ? lab0 : lab1);
        acc[4 * j + e] = sv;
        if (e < 2) mx0 = fmaxf(mx0, sv); else mx1 = fmaxf(mx1, sv);
      }
    }
    const float mn0 = fmaxf(m0s, quad_max(mx0)), mn1 = fmaxf(m1s, quad_max(mx1));
    float ps0 = 0.f, ps1 = 0.f, pr0 = 0.f, pr1 = 0.f;
#pragma unroll
    for (int j = 0; j < GEMM_BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = v0 + 8 * j + 2 * t4 + (e & 1);
        const float sv = acc[4 * j + e];
        const float pv = col < V ? expf(sv - (e < 2 ? mn0 : mn1)) : 0.f;
        if (e < 2) { ps0 += pv; pr0 += pv * sv; } else { ps1 += pv; pr1 += pv * sv; }
      }
    }
    lp_online(m0s, l0, r0, mn0, quad_sum(ps0), quad_sum(pr0));
    lp_online(m1s, l1, r1, mn1, quad_sum(ps1), quad_sum(pr1));
  }
  lab0 = quad_sum(lab0);
  lab1 = quad_sum(lab1);
  if (t4 == 0) {
    const size_t SN = (size_t)p.S * N;
    float* base = p.part + (size_t)split * N;
    if (row0 < N) {
      base[row0] = m0s; base[SN + row0] = l0; base[2 * SN + row0] = r0; base[3 * SN + row0] = lab0;
    }
    if (row1 < N) {
      base[row1] = m1s; base[SN + row1] = l1; base[2 * SN + row1] = r1; base[3 * SN + row1] = lab1;
    }
  }
}

// Merge the V splits of each row, in split order, into (logprob, lse, entropy).
__global__ void logprob_combine_kernel(LogprobParams p) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.N) return;
  const size_t SN = (size_t)p.S * p.N;
  float M = TRLX_M_INIT;
  for (int s = 0; s < p.S; ++s) M = fmaxf(M, p.part[(size_t)s * p.N + n]);
  float L = 0.f, R = 0.f, lab = 0.f;
  for (int s = 0; s < p.S; ++s) {
    const size_t i = (size_t)s * p.N + n;
    const float w = expf(p.part[i] - M);
    L += w * p.part[SN + i];
    R += w * p.part[2 * SN + i];
    lab += p.part[3 * SN + i];
  }
  const float ls = fmaxf(L, 1e-30f);
  const float lse = M + logf(ls);
  p.lse[n] = lse;
  p.ent[n] = lse - R / ls;
  p.lp[n] = lab - lse;
}

template <bool TIED>
cudaError_t launch(const CUtensorMap& tx, const CUtensorMap& tw, const LogprobParams& p, cudaStream_t stream) {
  const int smem = GEMM_SMEM_BYTES + 1024;  // room to align the base to 1024
  cudaError_t err = set_gemm_smem(logprob_fwd_kernel<TIED>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.N + GEMM_BM - 1) / GEMM_BM, p.S);
  logprob_fwd_kernel<TIED><<<grid, GEMM_THREADS, smem, stream>>>(tx, tw, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  logprob_combine_kernel<<<(p.N + 255) / 256, 256, 0, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The f32-activation mode: x f32, W f32, f32 products and sums (ILQL's Q
// heads). The same grid of 128-row tiles x V splits and the same partials
// and merge as above, on the SIMT mainloop of sgemm_f32.cuh (128-column
// tiles); each thread reduces its 8 rows x 8 columns and the half-warp that
// shares those rows reduces across its 16 threads.
// ---------------------------------------------------------------------------

// TIED: W [V, D] is a K-major B; untied W [D, V] an MN-major one.
template <bool TIED>
__global__ void __launch_bounds__(SG_THREADS, 2)
    logprob_fwd_f32_kernel(const SgOperand x, const SgOperand w, LogprobParams p) {
  __shared__ __align__(16) SgSmem sm;
  const int row_tile = blockIdx.x, split = blockIdx.y;
  const int N = p.N, V = p.V;
  const int m0 = row_tile * SG_BM;
  const int n_vt = (V + SG_BN - 1) / SG_BN;
  const int vt_lo = split * p.tiles_per_split;
  const int vt_hi = min(vt_lo + p.tiles_per_split, n_vt);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  float m[8], l[8], r[8], lab[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = TRLX_M_INIT;
    l[i] = r[i] = lab[i] = 0.f;
  }
  float acc[8][8];
  for (int vt = vt_lo; vt < vt_hi; ++vt) {
    const int v0 = vt * SG_BN;
    sgemm_tile<true, TIED>(sm, x, w, m0, v0, p.D, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = m0 + sg_row(ty, i);
      const int y = row < N ? __ldg(p.labels + row) : -1;
      float mx = TRLX_MASK_VAL;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[i][j] = lp_score(acc[i][j], p.bias, v0 + sg_col(tx, j), V, y, lab[i]);
        mx = fmaxf(mx, acc[i][j]);
      }
      const float mn = fmaxf(m[i], half_warp_max(mx));
      float ps = 0.f, pr = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pv = v0 + sg_col(tx, j) < V ? expf(acc[i][j] - mn) : 0.f;
        ps += pv;
        pr += pv * acc[i][j];
      }
      lp_online(m[i], l[i], r[i], mn, half_warp_sum(ps), half_warp_sum(pr));
    }
  }
  const size_t SN = (size_t)p.S * N;
  float* base = p.part + (size_t)split * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float lb = half_warp_sum(lab[i]);
    const int row = m0 + sg_row(ty, i);
    if (tx == 0 && row < N) {
      base[row] = m[i]; base[SN + row] = l[i]; base[2 * SN + row] = r[i]; base[3 * SN + row] = lb;
    }
  }
}

template <bool TIED>
cudaError_t launch_f32(const SgOperand& x, const SgOperand& w, const LogprobParams& p, cudaStream_t stream) {
  dim3 grid((p.N + SG_BM - 1) / SG_BM, p.S);
  logprob_fwd_f32_kernel<TIED><<<grid, SG_THREADS, 0, stream>>>(x, w, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  logprob_combine_kernel<<<(p.N + 255) / 256, 256, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x bf16 [N, D] contiguous; w bf16 with row stride ldw elements (a multiple
// of 8, the base 16-byte aligned): [D, V] untied, [V, D] tied.
extern "C" int fused_logprob_fwd(const void* x, const void* w, const void* bias, const void* labels, void* lp,
                                 void* lse, void* ent, void* partials, int N, int D, int V, int ldw, int tied,
                                 int splits, void* stream) {
  if (D % GEMM_BK != 0 || splits < 1 || ldw % 8 != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  // B K-major (tied) is one 256-row box a chunk, MN-major (untied) four 64-row ones.
  const bool ok = make_map_2d(&tx, x, D, N, D, GEMM_BM) &&
                  (tied ? make_map_2d(&tw, w, D, V, ldw, GEMM_BN) : make_map_2d(&tw, w, V, D, ldw, GEMM_BK));
  if (!ok) return (int)cudaErrorInvalidValue;
  LogprobParams p;
  p.bias = static_cast<const float*>(bias);
  p.labels = static_cast<const int*>(labels);
  p.part = static_cast<float*>(partials);
  p.lp = static_cast<float*>(lp);
  p.lse = static_cast<float*>(lse);
  p.ent = static_cast<float*>(ent);
  p.N = N; p.D = D; p.V = V; p.S = splits;
  const int n_vt = (V + GEMM_BN - 1) / GEMM_BN;
  p.tiles_per_split = (n_vt + splits - 1) / splits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(tied ? launch<true>(tx, tw, p, s) : launch<false>(tx, tw, p, s));
}

// The f32 mode: x f32 [N, D] contiguous; w f32 with row stride ldw elements
// and unit column stride: [D, V] untied, [V, D] tied. `splits` V splits of
// 128-column tiles.
extern "C" int fused_logprob_fwd_f32(const void* x, const void* w, const void* bias, const void* labels, void* lp,
                                     void* lse, void* ent, void* partials, int N, int D, int V, int ldw, int tied,
                                     int splits, void* stream) {
  if (N < 1 || D < 1 || V < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  const SgOperand xo{static_cast<const float*>(x), D, N, D, D % 4 == 0 && aligned16(x)};
  const int wvec = ldw % 4 == 0 && aligned16(w);
  const SgOperand wo = tied ? SgOperand{static_cast<const float*>(w), ldw, V, D, wvec}
                            : SgOperand{static_cast<const float*>(w), ldw, D, V, wvec};
  LogprobParams p;
  p.bias = static_cast<const float*>(bias);
  p.labels = static_cast<const int*>(labels);
  p.part = static_cast<float*>(partials);
  p.lp = static_cast<float*>(lp);
  p.lse = static_cast<float*>(lse);
  p.ent = static_cast<float*>(ent);
  p.N = N; p.D = D; p.V = V; p.S = splits;
  const int n_vt = (V + SG_BN - 1) / SG_BN;
  p.tiles_per_split = (n_vt + splits - 1) / splits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(tied ? launch_f32<true>(xo, wo, p, s) : launch_f32<false>(xo, wo, p, s));
}
