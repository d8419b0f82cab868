// The per-score arithmetic of the fused-logprob kernels, shared by the bf16
// kernels on the wgmma mainloop (logprob_gemm.cuh) and the f32 forward and
// ds kernels on the 3xTF32 mainloop (logprob_gemm_tf32.cuh), so all
// compute the same function (trlx_tpu/ops/fused_logprob.py: _tile_scores,
// the online update of _fwd_kernel, _ds_tile); and the tile epilogues of
// the wgmma kernels, which share one accumulator layout: acc[4 j + e] is row
// g (+ 8 for e >= 2) of the warp's 16, column 8 j + 2 t4 + (e & 1) of the
// tile, for lane = 4 g + t4.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

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

// The forward's epilogue of one finished tile of BN columns from v0: bias,
// label gather, tail mask, then the online max and sums of the thread's two
// rows (max over the quad that holds a row, sums over it after the exps).
template <int BN>
__device__ __forceinline__ void lp_tile(float* acc, const float* bias, int v0, int V, int t4, const int (&y)[2],
                                        float (&m)[2], float (&l)[2], float (&r)[2], float (&lab)[2]) {
  float mx[2] = {TRLX_MASK_VAL, TRLX_MASK_VAL};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c0 = v0 + 8 * j + 2 * t4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float sv = lp_score(acc[4 * j + e], bias, c0 + (e & 1), V, y[e >> 1], lab[e >> 1]);
      acc[4 * j + e] = sv;
      mx[e >> 1] = fmaxf(mx[e >> 1], sv);
    }
  }
  const float mn[2] = {fmaxf(m[0], quad_max(mx[0])), fmaxf(m[1], quad_max(mx[1]))};
  float ps[2] = {0.f, 0.f}, pr[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = v0 + 8 * j + 2 * t4 + (e & 1);
      const float sv = acc[4 * j + e];
      const float pv = col < V ? expf(sv - mn[e >> 1]) : 0.f;
      ps[e >> 1] += pv;
      pr[e >> 1] += pv * sv;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) lp_online(m[h], l[h], r[h], mn[h], quad_sum(ps[h]), quad_sum(pr[h]));
}

// The forward's per-row partials (m, l, r, label score) of split `split`
// into part [4, S, N]: the label score summed over the quad, written by its
// first thread.
__device__ __forceinline__ void lp_write_partials(float* part, int S, int N, int split, int t4, const int (&row)[2],
                                                  const float (&m)[2], const float (&l)[2], const float (&r)[2],
                                                  float (&lab)[2]) {
  lab[0] = quad_sum(lab[0]);
  lab[1] = quad_sum(lab[1]);
  if (t4 != 0) return;
  const size_t SN = (size_t)S * N;
  float* base = part + (size_t)split * N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] < N) {
      base[row[h]] = m[h]; base[SN + row[h]] = l[h]; base[2 * SN + row[h]] = r[h]; base[3 * SN + row[h]] = lab[h];
    }
  }
}

// The residuals and cotangents of the thread's two rows of a ds tile (zero
// and label -1 past the chunk's rows).
struct DsRows {
  float lse[2], E[2], dlp[2], dlse[2], dent[2];
  int y[2];
  bool in[2];
};

template <typename P>
__device__ __forceinline__ DsRows ds_rows(const P& p, int row0, int row1) {
  DsRows d;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    const bool in = row < p.rows;
    d.in[r] = in;
    d.lse[r] = in ? p.lse[row] : 0.f;
    d.E[r] = in ? d.lse[r] - p.ent[row] : 0.f;
    d.dlp[r] = in ? p.dlp[row] : 0.f;
    d.dlse[r] = in ? p.dlse[row] : 0.f;
    d.dent[r] = in ? p.dent[row] : 0.f;
    d.y[r] = in ? p.labels[row] : -1;
  }
  return d;
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
}

__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// The ds kernels' epilogue of one finished tile of BN columns from v0 (rows
// row0 and row0 + 8 of the thread; cwarp 0..7 the warp's 16 rows of the
// 128-row tile, tid 0..255 the consumer thread): ds in f32 from the score,
// stored in p.ds's type (every row of the tile, zeros past the chunk's rows
// and past V, up to ldv, so the dx and dW kernels read no garbage); with
// p.dbpart, the tile's column sums of ds into dbpart[row_tile], summed over
// each warp's rows by shuffles, then over the 8 warps in warp order through
// cs_buf ([8][BN] f32, one of two alternating buffers), behind the named
// barrier bar.
template <int BN, typename P>
__device__ __forceinline__ void ds_tile(float* acc, const P& p, const DsRows& d, int v0, int row0, int row_tile,
                                        int cwarp, int g, int t4, int tid, float* cs_buf, int bar) {
  const int V = p.V;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c0 = v0 + 8 * j + 2 * t4;
    float cs[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, col = c0 + (e & 1);
      float dsv = 0.f;
      if (col < V && d.in[r]) {
        const float sv = acc[4 * j + e] + (p.bias != nullptr ? __ldg(p.bias + col) : 0.f);
        dsv = ds_score(sv, d.lse[r], d.E[r], d.dlp[r], d.dlse[r], d.dent[r], col == d.y[r]);
      }
      acc[4 * j + e] = dsv;
      cs[e & 1] += dsv;
    }
    if (c0 < p.ldv) {
      store_pair(p.ds + (size_t)row0 * p.ldv + c0, acc[4 * j], acc[4 * j + 1]);
      store_pair(p.ds + (size_t)(row0 + 8) * p.ldv + c0, acc[4 * j + 2], acc[4 * j + 3]);
    }
    if (p.dbpart != nullptr) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = cs[h];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) cs_buf[cwarp * BN + 8 * j + 2 * t4 + h] = v;
      }
    }
  }
  if (p.dbpart != nullptr) {
    // The 8 warps' sums of column tid, in warp order.
    named_sync(bar, 256);
    if (tid < BN) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) v += cs_buf[w * BN + tid];
      const int col = v0 + tid;
      if (col < V) p.dbpart[(size_t)row_tile * V + col] = v;
    }
  }
}
