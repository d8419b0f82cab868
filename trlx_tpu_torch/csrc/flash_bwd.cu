// Flash attention backward for Hopper (sm_90a): two warp-specialised kernels,
// TMA loads into mbarrier rings, wgmma on the tensor cores, bf16 in, f32
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
// them to the operand dtype. Masking follows the forward (common.cuh
// flash_key_span / flash_query_span: causal or not, a window, key k at
// position k + offset of the query frame). Tiles that the position rule empties are skipped by the
// forward's test (a tile is live when some pair in it is reachable by
// position), so p is the forward's p on every visited pair and exactly 0 on
// the valid rows' masked pairs. A row whose forward reached no key (lse =
// -1e30, e.g. a wholly future ring chunk) gets p = 0 on every tile, so it
// adds nothing to dq, dk or dv. Rows past T have zero q and dO (TMA's
// out-of-bounds fill) and lse = delta = 0, so every term they add is 0.
//
// What bounds it on an H100: at the train shape [8, 1024, 16, 256] there are
// 67.2M live (query, key) pairs; dq costs 6*d flops a pair (1.03e11, 0.104 ms
// at the bf16 peak) and dk/dv 8*d (1.38e11, 0.139 ms) against ~0.34/0.40 GB of
// q, k, v, dO and outputs (~0.10/0.12 ms), so the tensor cores bound both, and
// the design keeps them fed: operands arrive by TMA while the other
// warpgroup's products run, and every product is a wgmma.
//
// Determinism: no atomics. Each output element is summed by one thread in a
// fixed order (the JAX package's two-kernel split), so two calls on the same
// inputs give the same bits.
//
// Both kernels: 384 threads, one CTA per SM. Warpgroup 0 is the producer
// (setmaxnreg 24; one thread issues the TMA boxes, its lanes stage the
// kv_mask / lse / delta slices, which need not be 16-byte aligned, and
// arrive on the full barrier a second time); warpgroups 1 and 2 consume
// (setmaxnreg 240). Products (hopper.cuh): S-like ones read both operands
// from shared memory, K-major (wgmma SS); the accumulating ones take A = P^T,
// dS or dS^T as bf16 fragments straight from the f32 accumulator in
// registers and read B through the MN-major descriptor of the same tile
// (wgmma RS), so nothing is transposed.
//
// Grid order: the tiles of one (batch row, head) are neighbouring CTAs, so
// each of the ~8 heads of a wave loads a K / V (dq) or Q / dO (dk/dv) tile
// from HBM once and its other CTAs find it in L2. Ordered head by head, as
// the forward orders its grid, the 132 CTAs of a wave share nothing: dk/dv
// then streams 1.1 GB of Q and dO from HBM at the train shape (0.34 ms of
// HBM time, reckoned) and took 0.62 ms against 0.40 ms this way (one H100
// SXM at 700 W).
//
// dq (one CTA per (128-query tile, head, row), longest causal walk of a
// head first): Q and dO are loaded once (64 rows a consumer warpgroup); K
// and V tiles of BK keys stream through a 2-stage ring. Per tile a
// warpgroup issues S = Q.K^T and dP = dO.V^T together, forms P and dS in
// registers, then dq += dS.K; dq (64 x d f32, d / 2 registers a thread)
// stays in registers for the whole walk and is scaled once at the end. A
// warpgroup skips the math of a tile its 64 rows cannot reach but still
// waits on the tile's full barrier and frees the stage, so both consumers
// observe every phase. BK per d: 32 at d = 256 (Q + dO 128 KB, two stages
// of K + V, 32 KB each: 192 KB; registers 128 dq + 16 S + 16 dP + 8 dS a
// thread), 64 at d <= 128 (64 + 64 KB at d = 128).
//
// dk/dv (one CTA per (64-key tile, head, row), key tile 0 of a head first: it
// walks the most query tiles): K and V are loaded once; Q, dO and the tile's lse /
// delta slices stream through a 2-stage ring of 64-query tiles, from the
// diagonal in the offset frame (from tile 0 without causality) to T (with a
// window, to the last query that still sees a key of the tile: every visited
// tile is live). The two [64, d] accumulators do not
// fit one warpgroup at d = 256, so the work is split:
// - warpgroup 1: S^T = K.Q^T (SS), P^T = exp(S^T * scale - lse) in
//   registers, hands P^T (f32) to warpgroup 2 through shared memory behind
//   named barrier 1, then dv += P^T.dO (RS, dO MN-major);
// - warpgroup 2: dP^T = V.dO^T (SS), takes P^T after named barrier 1, frees
//   the exchange tile on named barrier 2, forms dS^T = P^T * (dP^T - delta),
//   then dk += dS^T.Q (RS, Q MN-major).
// Forming S^T rather than S puts P^T and dS^T straight into the A-fragment
// layout. Shared memory at d = 256: K + V 64 KB, two stages of Q + dO 128
// KB, the P^T tile 16 KB: 208 KB. One design serves d = 64/96/128/256.
//
// d = 96 (GPT-NeoX-20B) keeps d = 128's tiles and layout: a row of 96 bf16
// (192 bytes) is stored as two 64-column boxes whose second box has its
// columns 96-127 zero-filled by TMA's out-of-bounds fill (the tensor maps'
// inner dimension is d, so nothing past column 96 is read from memory). The
// products that reduce over d (S = Q.K^T, dP = dO.V^T and their transposes)
// take the 6 k16 steps of the 96 columns only; those whose N is d (dS.K,
// P^T.dO, dS^T.Q) run m64n64 on both boxes, and the accumulators' columns
// 96-127 (zeros) are not stored.

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int STAGES = 2;
constexpr int NTHREADS = 384;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int DQ_BQ = 128;      // dq: query rows per CTA (two consumer warpgroups of 64)
constexpr int DQ_BK = 64;       // dq: keys per ring tile at d <= 128
constexpr int DQ_BK_D256 = 32;  // dq: keys per ring tile at d = 256
constexpr int DKV_BK = 64;      // dk/dv: keys per CTA
constexpr int DKV_BQ = 64;      // dk/dv: queries per ring tile
constexpr int BAR_PT_FULL = 1;  // named barriers of the P^T exchange
constexpr int BAR_PT_EMPTY = 2;

struct BwdParams {
  const float* kmask;  // [b, T] key validity (> 0.5 = valid)
  const float* lse;    // [b, h, T]
  const float* delta;  // [b, h, T]
  __nv_bfloat16* dq;   // [b, T, h, d] contiguous
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int b, T, h, n_tiles;
  float scale;
  int window;
  int causal;  // 0: every key position is reachable (subject to the window)
  int offset;  // key k sits at k + offset in the query frame
};

// out rows row0 and row0 + 8 of a [64, d] f32 accumulator (the wgmma
// fragment of this thread, box_chunks(d) boxes of 64 columns) times `mul`,
// as bf16, rows past T and the zero-filled columns past d dropped.
template <int D, int CH = box_chunks(D)>
__device__ __forceinline__ void store_acc(__nv_bfloat16* out, const float (&acc)[CH][32], int row0, int T,
                                          size_t orow, float mul, int t4) {
  const int row1 = row0 + 8;
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (c * 64 + j * 8 >= D) continue;
      const int col = c * 64 + j * 8 + 2 * t4;
      if (row0 < T)
        *reinterpret_cast<uint32_t*>(out + (size_t)row0 * orow + col) =
            pack_bf16(acc[c][j * 4 + 0] * mul, acc[c][j * 4 + 1] * mul);
      if (row1 < T)
        *reinterpret_cast<uint32_t*>(out + (size_t)row1 * orow + col) =
            pack_bf16(acc[c][j * 4 + 2] * mul, acc[c][j * 4 + 3] * mul);
    }
}

// A fragments (bf16 pairs) of a [64, 16 * KS] f32 accumulator, k16 step kk
// from columns 16 kk .. 16 kk + 15.
template <int KS>
__device__ __forceinline__ void to_frags(uint32_t (&a)[KS][4], const float* r) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pack_bf16(r[(2 * kk) * 4 + 0], r[(2 * kk) * 4 + 1]);
    a[kk][1] = pack_bf16(r[(2 * kk) * 4 + 2], r[(2 * kk) * 4 + 3]);
    a[kk][2] = pack_bf16(r[(2 * kk + 1) * 4 + 0], r[(2 * kk + 1) * 4 + 1]);
    a[kk][3] = pack_bf16(r[(2 * kk + 1) * 4 + 2], r[(2 * kk + 1) * 4 + 3]);
  }
}

// A row's lse in log2 units, or +inf where its forward reached no key
// (lse = M_INIT): exp2(s - inf) = 0, so the row adds nothing.
__device__ __forceinline__ float dead_or_log2(float lse) {
  return lse > TRLX_DEAD_LSE ? lse * LOG2E : __int_as_float(0x7f800000);
}

template <int CH>
__device__ __forceinline__ void init_acc(float (&acc)[CH][32]) {
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

template <int D>
struct DqSmem {
  static constexpr int BK = D == 256 ? DQ_BK_D256 : DQ_BK;
  static constexpr int Q_BYTES = DQ_BQ * box_chunks(D) * 128;  // Q, and dO
  static constexpr int KV_BYTES = BK * box_chunks(D) * 128;    // one K or V tile
  static constexpr int Q = 0;
  static constexpr int DO = Q + Q_BYTES;
  static constexpr int K = DO + Q_BYTES;               // K[stage]
  static constexpr int V = K + STAGES * KV_BYTES;      // V[stage]
  static constexpr int KMASK = V + STAGES * KV_BYTES;  // float[stage][BK]
  static constexpr int BAR = KMASK + STAGES * BK * 4;  // q, full[stage], empty[stage]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES);
  static constexpr int ALLOC = BYTES + 1024;  // room to align the base to 1024
};

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                        BwdParams p) {
  using L = DqSmem<D>;
  constexpr int CH = box_chunks(D), BK = L::BK, NS = BK / 2;  // NS: registers of a 64 x BK tile a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  const uint32_t sbase = smem_u32(sm);
  float* kms = reinterpret_cast<float*>(sm + L::KMASK);
  const uint32_t bar_q = sbase + L::BAR;
  auto bar_f = [&](int s) { return sbase + L::BAR + 8 * (1 + s); };
  auto bar_e = [&](int s) { return sbase + L::BAR + 8 * (1 + STAGES + s); };

  // Tiles of a head are neighbours in the grid, so a wave's CTAs share
  // their K / V tiles in L2; within a head the longest causal walk first (at
  // any offset a later tile's walk is no shorter).
  const int bh = blockIdx.x / p.n_tiles, hi = bh % p.h, bi = bh / p.h;
  const int qt = p.n_tiles - 1 - (int)(blockIdx.x % p.n_tiles);
  const int q0 = qt * DQ_BQ, T = p.T;
  // Key tiles the CTA visits (the forward's walk): under causality up to the
  // diagonal of its last row, with a window from the first key its first row
  // sees, both in the offset frame; none when no row reaches a key.
  const int n_kt = (T + BK - 1) / BK;
  const int kt_hi = p.causal ? min(n_kt - 1, floor_div(min(q0 + DQ_BQ, T) - 1 - p.offset, BK)) : n_kt - 1;
  const int kt_lo = p.window > 0 ? max(0, floor_div(q0 - p.window + 1 - p.offset, BK)) : 0;
  const int n_kv = max(0, kt_hi - kt_lo + 1);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_f(s), 2);  // the TMA's expect_tx and the staged kv_mask slice
      mbar_init(bar_e(s), 2 * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_expect_tx(bar_q, 2 * L::Q_BYTES);
      for (int c = 0; c < CH; ++c) {
        tma_load(sbase + L::Q + c * DQ_BQ * 128, &tq, bar_q, c * 64, q0, hi, bi);
        tma_load(sbase + L::DO + c * DQ_BQ * 128, &tdo, bar_q, c * 64, q0, hi, bi);
      }
    }
    for (int i = 0; i < n_kv; ++i) {
      const int s = i % STAGES, k0 = (kt_lo + i) * BK;
      mbar_wait(bar_e(s), ((i / STAGES) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(bar_f(s), 2 * L::KV_BYTES);
        for (int c = 0; c < CH; ++c) {
          tma_load(sbase + L::K + s * L::KV_BYTES + c * BK * 128, &tk, bar_f(s), c * 64, k0, hi, bi);
          tma_load(sbase + L::V + s * L::KV_BYTES + c * BK * 128, &tv, bar_f(s), c * 64, k0, hi, bi);
        }
      }
      for (int j = lane; j < BK; j += 32) {
        const int key = k0 + j;
        kms[s * BK + j] = key < T ? p.kmask[(size_t)bi * T + key] : 0.f;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_f(s));
    }
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wg - 1;                    // 64-row half of the tile
  const int warp = (threadIdx.x / 32) & 3;  // warp within the warpgroup: 16 rows
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int rlo = q0 + cw * 64;  // first row of this warpgroup
  const int row0 = rlo + warp * 16 + g, row1 = row0 + 8;
  const float sl2 = p.scale * LOG2E;  // scores in log2 units
  const float mask2 = TRLX_MASK_VAL * LOG2E;
  const size_t rv = ((size_t)bi * p.h + hi) * T;
  const float lse0 = row0 < T ? dead_or_log2(p.lse[rv + row0]) : 0.f;
  const float lse1 = row1 < T ? dead_or_log2(p.lse[rv + row1]) : 0.f;
  const float dl0 = row0 < T ? p.delta[rv + row0] : 0.f;
  const float dl1 = row1 < T ? p.delta[rv + row1] : 0.f;
  const int2 sp0 = flash_key_span(row0, T, p.causal, p.window, p.offset);
  const int2 sp1 = flash_key_span(row1, T, p.causal, p.window, p.offset);

  float acc[CH][32];
  init_acc<CH>(acc);
  const uint32_t q_base = sbase + L::Q + cw * 64 * 128;
  const uint32_t do_base = sbase + L::DO + cw * 64 * 128;
  mbar_wait(bar_q, 0);

  for (int i = 0; i < n_kv; ++i) {
    const int s = i % STAGES;
    const uint32_t par = (i / STAGES) & 1;
    const int k0 = (kt_lo + i) * BK;
    // Tile liveness for this warpgroup's 64 rows and the tile's keys, both cut
    // at T (the TPU kernel's _run_if_live; a warpgroup whose rows all lie past
    // T has none).
    const bool live = rlo < T && flash_tile_live(rlo, min(rlo + 63, T - 1), k0 + p.offset,
                                                 min(k0 + BK, T) - 1 + p.offset, p.causal, p.window);
    // Wait on every phase, live or not: a parity wait on a phase skipped two
    // tiles back would pass at once.
    mbar_wait(bar_f(s), par);
    if (live) {
      const uint32_t k_base = sbase + L::K + s * L::KV_BYTES;
      const uint32_t v_base = sbase + L::V + s * L::KV_BYTES;
      float sc[NS], dp[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) sc[j] = dp[j] = 0.f;
      fence_regs<NS>(sc);
      fence_regs<NS>(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * BK * 128 + (kk % 4) * 32;
        const uint32_t aoff = (kk / 4) * DQ_BQ * 128 + (kk % 4) * 32;
        wgmma_ss_n<BK>(sc, make_desc(q_base + aoff, 16, 1024), make_desc(k_base + off, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * BK * 128 + (kk % 4) * 32;
        const uint32_t aoff = (kk / 4) * DQ_BQ * 128 + (kk % 4) * 32;
        wgmma_ss_n<BK>(dp, make_desc(do_base + aoff, 16, 1024), make_desc(v_base + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs<NS>(sc);
      fence_regs<NS>(dp);

      // p = exp(s * scale - lse) with the forward's mask, ds = p * (dp - delta).
      const float* km = kms + s * BK;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = j * 8 + 2 * t4 + (e & 1);
          const int key = k0 + kk;
          const int2 sp = e < 2 ? sp0 : sp1;
          const bool valid = km[kk] > 0.5f && key >= sp.x && key <= sp.y;
          const float pv = exp2f((valid ? sc[j * 4 + e] * sl2 : mask2) - (e < 2 ? lse0 : lse1));
          sc[j * 4 + e] = pv * (dp[j * 4 + e] - (e < 2 ? dl0 : dl1));
        }
      }
      uint32_t da[BK / 16][4];  // dS rounded to bf16 (the TPU kernel's cast)
      to_frags<BK / 16>(da, sc);

#pragma unroll
      for (int c = 0; c < CH; ++c) fence_regs(acc[c]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs(acc[c], da[kk], make_desc(k_base + c * BK * 128 + kk * 16 * 128, BK * 128, 1024));
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int c = 0; c < CH; ++c) fence_regs(acc[c]);
    }
    mbar_arrive(bar_e(s));
  }

  const size_t orow = (size_t)p.h * D;
  store_acc<D>(p.dq + (size_t)bi * T * orow + (size_t)hi * D, acc, row0, T, orow, p.scale, t4);
}

// ---------------------------------------------------------------------------
// dk / dv
// ---------------------------------------------------------------------------

template <int D>
struct DkvSmem {
  static constexpr int KV_BYTES = DKV_BK * box_chunks(D) * 128;  // K, or V
  static constexpr int QD_BYTES = DKV_BQ * box_chunks(D) * 128;  // one Q or dO tile
  static constexpr int K = 0;
  static constexpr int V = K + KV_BYTES;
  static constexpr int Q = V + KV_BYTES;                  // Q[stage]
  static constexpr int DO = Q + STAGES * QD_BYTES;        // dO[stage]
  static constexpr int PT = DO + STAGES * QD_BYTES;       // f32 P^T exchange, 64 x 64
  static constexpr int KMASK = PT + DKV_BK * DKV_BQ * 4;  // float[BK]
  static constexpr int LSE = KMASK + DKV_BK * 4;          // float[stage][BQ], log2 units
  static constexpr int DELTA = LSE + STAGES * DKV_BQ * 4; // float[stage][BQ]
  static constexpr int BAR = DELTA + STAGES * DKV_BQ * 4; // kv, full[stage], empty[stage]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES);
  static constexpr int ALLOC = BYTES + 1024;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                         BwdParams p) {
  using L = DkvSmem<D>;
  constexpr int CH = box_chunks(D);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  const uint32_t sbase = smem_u32(sm);
  float* kms = reinterpret_cast<float*>(sm + L::KMASK);
  float* lse_s = reinterpret_cast<float*>(sm + L::LSE);
  float* delta_s = reinterpret_cast<float*>(sm + L::DELTA);
  float4* pt = reinterpret_cast<float4*>(sm + L::PT);
  const uint32_t bar_kv = sbase + L::BAR;
  auto bar_f = [&](int s) { return sbase + L::BAR + 8 * (1 + s); };
  auto bar_e = [&](int s) { return sbase + L::BAR + 8 * (1 + STAGES + s); };

  // Tiles of a head are neighbours in the grid, so a wave's CTAs share
  // their Q / dO tiles in L2; within a head key tile 0, the longest walk, first.
  const int bh = blockIdx.x / p.n_tiles, hi = bh % p.h, bi = bh / p.h;
  const int k0 = (int)(blockIdx.x % p.n_tiles) * DKV_BK, T = p.T;
  // Query tiles the CTA visits, all live: under causality from the tile of
  // the first query that sees key k0 (its diagonal in the offset frame), to
  // T, or with a window to the last query that still sees the tile's last
  // key below T; none when no query reaches a key of the tile (dk = dv = 0).
  const int nq = (T + DKV_BQ - 1) / DKV_BQ;
  const int qt_lo = !p.causal ? 0 : k0 + p.offset > T - 1 ? nq : max(0, floor_div(k0 + p.offset, DKV_BQ));
  const int qt_hi =
      p.window > 0 ? min(nq - 1, floor_div(min(k0 + DKV_BK, T) - 2 + p.offset + p.window, DKV_BQ)) : nq - 1;
  const int n_q = max(0, qt_hi - qt_lo + 1);
  const size_t rv = ((size_t)bi * p.h + hi) * T;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 2);  // the TMA's expect_tx and the staged kv_mask slice
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_f(s), 2);  // the TMA's expect_tx and the staged lse / delta slices
      mbar_init(bar_e(s), 2 * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_expect_tx(bar_kv, 2 * L::KV_BYTES);
      for (int c = 0; c < CH; ++c) {
        tma_load(sbase + L::K + c * DKV_BK * 128, &tk, bar_kv, c * 64, k0, hi, bi);
        tma_load(sbase + L::V + c * DKV_BK * 128, &tv, bar_kv, c * 64, k0, hi, bi);
      }
    }
    for (int j = lane; j < DKV_BK; j += 32) {
      const int key = k0 + j;
      kms[j] = key < T ? p.kmask[(size_t)bi * T + key] : 0.f;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_kv);
    for (int i = 0; i < n_q; ++i) {
      const int s = i % STAGES, q0 = (qt_lo + i) * DKV_BQ;
      mbar_wait(bar_e(s), ((i / STAGES) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(bar_f(s), 2 * L::QD_BYTES);
        for (int c = 0; c < CH; ++c) {
          tma_load(sbase + L::Q + s * L::QD_BYTES + c * DKV_BQ * 128, &tq, bar_f(s), c * 64, q0, hi, bi);
          tma_load(sbase + L::DO + s * L::QD_BYTES + c * DKV_BQ * 128, &tdo, bar_f(s), c * 64, q0, hi, bi);
        }
      }
      for (int j = lane; j < DKV_BQ; j += 32) {
        const int row = q0 + j;
        lse_s[s * DKV_BQ + j] = row < T ? dead_or_log2(p.lse[rv + row]) : 0.f;
        delta_s[s * DKV_BQ + j] = row < T ? p.delta[rv + row] : 0.f;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_f(s));
    }
    return;
  }

  // ---- consumers: warpgroup 1 forms P^T and dv, warpgroup 2 dP^T, dS^T and dk ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const bool p_group = wg == 1;
  const int tw = threadIdx.x - 128 * wg;  // thread within the warpgroup
  const int warp = tw / 32;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;  // this thread's two key rows
  const float sl2 = p.scale * LOG2E;
  const float mask2 = TRLX_MASK_VAL * LOG2E;

  float acc[CH][32];
  init_acc<CH>(acc);
  mbar_wait(bar_kv, 0);
  const bool kv0 = kms[key0 - k0] > 0.5f, kv1 = kms[key1 - k0] > 0.5f;
  // The query rows that reach keys key0 and key1 by position.
  const int2 qs0 = flash_query_span(key0, p.causal, p.window, p.offset);
  const int2 qs1 = flash_query_span(key1, p.causal, p.window, p.offset);
  // A of the first product: K for S^T, V for dP^T.
  const uint32_t a_base = sbase + (p_group ? L::K : L::V);

  for (int i = 0; i < n_q; ++i) {
    const int s = i % STAGES;
    const int q0 = (qt_lo + i) * DKV_BQ;
    const uint32_t q_s = sbase + L::Q + s * L::QD_BYTES, do_s = sbase + L::DO + s * L::QD_BYTES;
    // B of the first product (K-major): Q^T or dO^T; B of the second (MN-major): dO or Q.
    const uint32_t b1 = p_group ? q_s : do_s, b2 = p_group ? do_s : q_s;
    mbar_wait(bar_f(s), (i / STAGES) & 1);

    float st[32];  // S^T, then P^T (group 1); dP^T, then dS^T (group 2): [64 keys x 64 queries]
#pragma unroll
    for (int j = 0; j < 32; ++j) st[j] = 0.f;
    fence_regs(st);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t aoff = (kk / 4) * DKV_BK * 128 + (kk % 4) * 32;
      const uint32_t boff = (kk / 4) * DKV_BQ * 128 + (kk % 4) * 32;
      wgmma_ss(st, make_desc(a_base + aoff, 16, 1024), make_desc(b1 + boff, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(st);

    const float* ls = lse_s + s * DKV_BQ;
    const float* dl = delta_s + s * DKV_BQ;
    if (p_group) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = j * 8 + 2 * t4 + (e & 1);
          const int query = q0 + ql;
          const int2 qs = e < 2 ? qs0 : qs1;
          const bool valid = (e < 2 ? kv0 : kv1) && query >= qs.x && query <= qs.y;
          st[j * 4 + e] = exp2f((valid ? st[j * 4 + e] * sl2 : mask2) - ls[ql]);
        }
      }
      // Hand P^T (f32) to warpgroup 2 once it has read the previous tile's.
      if (i > 0) named_sync(BAR_PT_EMPTY, 256);
#pragma unroll
      for (int j = 0; j < 8; ++j) pt[j * 128 + tw] = make_float4(st[4 * j], st[4 * j + 1], st[4 * j + 2], st[4 * j + 3]);
      __threadfence_block();
      named_arrive(BAR_PT_FULL, 256);
    } else {
      named_sync(BAR_PT_FULL, 256);
      float pv[32];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 v = pt[j * 128 + tw];
        pv[4 * j] = v.x; pv[4 * j + 1] = v.y; pv[4 * j + 2] = v.z; pv[4 * j + 3] = v.w;
      }
      if (i + 1 < n_q) named_arrive(BAR_PT_EMPTY, 256);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j * 4 + e] = pv[j * 4 + e] * (st[j * 4 + e] - dl[j * 8 + 2 * t4 + (e & 1)]);
    }
    uint32_t fa[DKV_BQ / 16][4];  // P^T or dS^T rounded to bf16
    to_frags<DKV_BQ / 16>(fa, st);

#pragma unroll
    for (int c = 0; c < CH; ++c) fence_regs(acc[c]);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk)
        wgmma_rs(acc[c], fa[kk], make_desc(b2 + c * DKV_BQ * 128 + kk * 16 * 128, DKV_BQ * 128, 1024));
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int c = 0; c < CH; ++c) fence_regs(acc[c]);
    mbar_arrive(bar_e(s));
  }

  const size_t orow = (size_t)p.h * D;
  const size_t off = (size_t)bi * T * orow + (size_t)hi * D;
  if (p_group)
    store_acc<D>(p.dv + off, acc, key0, T, orow, 1.f, t4);
  else
    store_acc<D>(p.dk + off, acc, key0, T, orow, p.scale, t4);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Maps {
  CUtensorMap q, k, v, dout;
};

// Tensor maps over the strided q/k/v views and the contiguous dO, with boxes
// of `qrows` rows for q and dO and `krows` for k and v.
bool make_maps(Maps* m, const void* q, const void* k, const void* v, const void* dout, int b, int T, int h, int d,
               int qsb, int qst, int qsh, int ksb, int kst, int ksh, int vsb, int vst, int vsh, int qrows,
               int krows) {
  return make_map(&m->q, q, d, T, h, b, qst, qsh, qsb, qrows) && make_map(&m->k, k, d, T, h, b, kst, ksh, ksb, krows) &&
         make_map(&m->v, v, d, T, h, b, vst, vsh, vsb, krows) &&
         make_map(&m->dout, dout, d, T, h, b, h * d, d, T * h * d, qrows);
}

BwdParams make_params(const void* kmask, const void* lse, const void* delta, int b, int T, int h, float scale,
                      int window, int causal, int offset) {
  BwdParams p;
  p.kmask = static_cast<const float*>(kmask);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = p.dk = p.dv = nullptr;
  p.b = b; p.T = T; p.h = h; p.n_tiles = 0;
  p.scale = scale; p.window = window;
  p.causal = causal; p.offset = offset;
  return p;
}

template <int D>
cudaError_t launch_dq(const Maps& m, BwdParams p, cudaStream_t stream) {
  const int smem = DqSmem<D>::ALLOC;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  p.n_tiles = (p.T + DQ_BQ - 1) / DQ_BQ;
  flash_bwd_dq_kernel<D><<<p.n_tiles * p.b * p.h, NTHREADS, smem, stream>>>(m.q, m.k, m.v, m.dout, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Maps& m, BwdParams p, cudaStream_t stream) {
  const int smem = DkvSmem<D>::ALLOC;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  p.n_tiles = (p.T + DKV_BK - 1) / DKV_BK;
  flash_bwd_dkv_kernel<D><<<p.n_tiles * p.b * p.h, NTHREADS, smem, stream>>>(m.q, m.k, m.v, m.dout, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout, const void* kmask,
                                 const void* lse, const void* delta, void* dq, int b, int T, int h, int d, int qsb,
                                 int qst, int qsh, int ksb, int kst, int ksh, int vsb, int vst, int vsh, float scale,
                                 int window, int causal, int offset, void* stream) {
  if (!flash_head_dim_ok(d)) return (int)cudaErrorInvalidValue;
  Maps m;
  if (!make_maps(&m, q, k, v, dout, b, T, h, d, qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, DQ_BQ,
                 d == 256 ? DQ_BK_D256 : DQ_BK))
    return (int)cudaErrorInvalidValue;
  BwdParams p = make_params(kmask, lse, delta, b, T, h, scale, window, causal, offset);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return (int)launch_dq<64>(m, p, s);
    case 96: return (int)launch_dq<96>(m, p, s);
    case 128: return (int)launch_dq<128>(m, p, s);
    case 256: return (int)launch_dq<256>(m, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout, const void* kmask,
                                  const void* lse, const void* delta, void* dk, void* dv, int b, int T, int h, int d,
                                  int qsb, int qst, int qsh, int ksb, int kst, int ksh, int vsb, int vst, int vsh,
                                  float scale, int window, int causal, int offset, void* stream) {
  if (!flash_head_dim_ok(d)) return (int)cudaErrorInvalidValue;
  Maps m;
  if (!make_maps(&m, q, k, v, dout, b, T, h, d, qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, DKV_BQ, DKV_BK))
    return (int)cudaErrorInvalidValue;
  BwdParams p = make_params(kmask, lse, delta, b, T, h, scale, window, causal, offset);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return (int)launch_dkv<64>(m, p, s);
    case 96: return (int)launch_dkv<96>(m, p, s);
    case 128: return (int)launch_dkv<128>(m, p, s);
    case 256: return (int)launch_dkv<256>(m, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
