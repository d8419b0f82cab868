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
// D = 8192, V = 50400) computes f32-accurate products as three TF32
// tensor-core passes on the mainloop of logprob_gemm_tf32.cuh, into the same
// epilogue (logprob_math.cuh), partials and merge. It is bound by
// operations: 3.38 TFLOP at that shape, whose three TF32 passes take 20.5 ms
// at the 495 TFLOP/s peak, against 1.8 GB of f32 weight and activations
// (0.54 ms).

#include "logprob_gemm.cuh"
#include "logprob_gemm_tf32.cuh"
#include "logprob_math.cuh"

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
  const int row[2] = {m0 + cw * 64 + warp * 16 + g, m0 + cw * 64 + warp * 16 + g + 8};
  const int y[2] = {row[0] < N ? p.labels[row[0]] : -1, row[1] < N ? p.labels[row[1]] : -1};

  float m[2] = {TRLX_M_INIT, TRLX_M_INIT}, l[2] = {0.f, 0.f}, r[2] = {0.f, 0.f}, lab[2] = {0.f, 0.f};
  float acc[GEMM_NACC];
  uint32_t it = 0;
  for (int vt = vt_lo; vt < vt_hi; ++vt) {
    gemm_tile<TIED>(ring, acc, cw, nk, it);
    // Tile epilogue: bias, label gather, tail mask, online max / sums.
    lp_tile<GEMM_BN>(acc, p.bias, vt * GEMM_BN, V, t4, y, m, l, r, lab);
  }
  lp_write_partials(p.part, p.S, N, split, t4, row, m, l, r, lab);
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
// The f32-activation mode: x f32, W f32, f32-accurate products as three TF32
// passes (ILQL's Q heads). The same grid of 128-row tiles x V splits, the
// same epilogue, partials and merge as above, on the 3xTF32 mainloop of
// logprob_gemm_tf32.cuh (128-column tiles).
// ---------------------------------------------------------------------------

// TIED: W [V, D] is a K-major B; untied W [D, V] an MN-major one, split
// into K-major B_hi / B_lo by the consumers.
template <bool TIED>
__global__ void __launch_bounds__(TG_THREADS, 1)
    logprob_fwd_f32_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                           LogprobParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  const TgRing ring{sm, smem_u32(sm)};
  const int row_tile = blockIdx.x, split = blockIdx.y;
  const int N = p.N, V = p.V;
  const int m0 = row_tile * TG_BM;
  const int n_vt = (V + TG_BN - 1) / TG_BN;
  const int vt_lo = split * p.tiles_per_split;
  const int vt_hi = min(vt_lo + p.tiles_per_split, n_vt);
  const int nk = tg_chunks(p.D);

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) tg_produce<TIED>(ring, &tx, &tw, m0, vt_lo, vt_hi, nk);
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wg - 1, ct = threadIdx.x - 128;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row[2] = {m0 + cw * 64 + warp * 16 + g, m0 + cw * 64 + warp * 16 + g + 8};
  const int y[2] = {row[0] < N ? p.labels[row[0]] : -1, row[1] < N ? p.labels[row[1]] : -1};

  float m[2] = {TRLX_M_INIT, TRLX_M_INIT}, l[2] = {0.f, 0.f}, r[2] = {0.f, 0.f}, lab[2] = {0.f, 0.f};
  float acc[TG_NACC];
  uint32_t it = 0;
  for (int vt = vt_lo; vt < vt_hi; ++vt) {
    tg_tile<TIED>(ring, acc, cw, ct, nk, it);
    lp_tile<TG_BN>(acc, p.bias, vt * TG_BN, V, t4, y, m, l, r, lab);
  }
  lp_write_partials(p.part, p.S, N, split, t4, row, m, l, r, lab);
}

template <bool TIED>
cudaError_t launch_f32(const CUtensorMap& tx, const CUtensorMap& tw, const LogprobParams& p, cudaStream_t stream) {
  const int smem = TG_SMEM_BYTES + 1024;  // room to align the base to 1024
  cudaError_t err = set_gemm_smem(logprob_fwd_f32_kernel<TIED>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.N + TG_BM - 1) / TG_BM, p.S);
  logprob_fwd_f32_kernel<TIED><<<grid, TG_THREADS, smem, stream>>>(tx, tw, p);
  err = cudaGetLastError();
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

// The f32 mode: x f32 [N, D] contiguous; w f32 with row stride ldw
// elements (a multiple of 4, the base 16-byte aligned: what TMA takes):
// [D, V] untied, [V, D] tied. `splits` V splits of 128-column tiles.
extern "C" int fused_logprob_fwd_f32(const void* x, const void* w, const void* bias, const void* labels, void* lp,
                                     void* lse, void* ent, void* partials, int N, int D, int V, int ldw, int tied,
                                     int splits, void* stream) {
  if (N < 1 || D < 1 || V < 1 || splits < 1 || D % 4 != 0 || ldw % 4 != 0) return (int)cudaErrorInvalidValue;
  // B K-major (tied) is one 128-row box a chunk, MN-major (untied) four 32 x 32 ones.
  CUtensorMap tx, tw;
  const bool ok = make_map_2d<4>(&tx, x, D, N, D, TG_BM) &&
                  (tied ? make_map_2d<4>(&tw, w, D, V, ldw, TG_BN) : make_map_2d<4>(&tw, w, V, D, ldw, TG_BK));
  if (!ok) return (int)cudaErrorInvalidValue;
  LogprobParams p;
  p.bias = static_cast<const float*>(bias);
  p.labels = static_cast<const int*>(labels);
  p.part = static_cast<float*>(partials);
  p.lp = static_cast<float*>(lp);
  p.lse = static_cast<float*>(lse);
  p.ent = static_cast<float*>(ent);
  p.N = N; p.D = D; p.V = V; p.S = splits;
  const int n_vt = (V + TG_BN - 1) / TG_BN;
  p.tiles_per_split = (n_vt + splits - 1) / splits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(tied ? launch_f32<true>(tx, tw, p, s) : launch_f32<false>(tx, tw, p, s));
}
