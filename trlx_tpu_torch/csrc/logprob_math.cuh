// The per-score arithmetic of the fused-logprob kernels, shared by the bf16
// kernels on the wgmma mainloop (logprob_gemm.cuh) and the f32 kernels on
// the SIMT mainloop (sgemm_f32.cuh), so both compute the same function
// (trlx_tpu/ops/fused_logprob.py: _tile_scores, the online update of
// _fwd_kernel, _ds_tile).
#pragma once

#include "common.cuh"

// One score of the forward: the bias added in f32, the label column's score
// summed into `lab`, a column past V REPLACED by TRLX_MASK_VAL (its weight
// is then made exactly 0 by the caller's `col < V` test).
__device__ __forceinline__ float lp_score(float acc, const float* bias, int col, int V, int y, float& lab) {
  const bool valid = col < V;
  float sv = acc;
  if (bias != nullptr && valid) sv += __ldg(bias + col);
  if (valid && col == y) lab += sv;
  return valid ? sv : TRLX_MASK_VAL;
}

// The online update of a row's (max m, sum l = sum exp(s - m), r = sum
// exp(s - m) * s) to the new max `mn`, given the tile's sums ps and pr
// taken against `mn`.
__device__ __forceinline__ void lp_online(float& m, float& l, float& r, float mn, float ps, float pr) {
  const float al = expf(m - mn);
  l = al * l + ps;
  r = al * r + pr;
  m = mn;
}

// The score cotangent of one column with score sv (bias included):
// ds = dlp * (1[k = y] - p) + dlse * p - dent * p * (s - E),
// p = exp(s - lse), E = lse - entropy.
__device__ __forceinline__ float ds_score(float sv, float lse, float E, float dlp, float dlse, float dent, bool hit) {
  const float pv = expf(sv - lse);
  return dlp * ((hit ? 1.f : 0.f) - pv) + dlse * pv - dent * pv * (sv - E);
}
