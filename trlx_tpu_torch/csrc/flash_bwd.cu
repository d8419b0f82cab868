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
// KB, the P^T tile 16 KB: 208 KB. This design serves d = 64/128/256.
//
// d = 96 (GPT-NeoX-20B): dq keeps d = 128's tiles and layout, a row of 96
// bf16 (192 bytes) stored as two 64-column boxes whose second box has its
// columns 96-127 zero-filled by TMA's out-of-bounds fill (the tensor maps'
// inner dimension is d, so nothing past column 96 is read from memory); its
// reductions over d take the 6 k16 steps of the 96 columns only, its dS.K
// runs m64n64 on both boxes, and the accumulator's columns 96-127 (zeros)
// are not stored.
//
// dk/dv at d = 96 has a kernel of its own, flash_bwd_dkv_d96_kernel. What
// bounds it at [8, 1024, 64, 96]: 8 * d flops a live pair, 2.06e11 (0.209
// ms at the bf16 peak), against 0.60 GB of q, k, v, dO, dk, dv (0.18 ms);
// the split above has no cause here (its reason, accumulators too large
// for one warpgroup, holds only at d = 256) and ran the two warpgroups in
// series through the P^T exchange. The design:
// - one CTA per DKV_BK_D96 = 128 keys; consumer warpgroup cw owns keys
//   k0 + 64 cw .. + 63 and computes everything for them: S^T = K.Q^T and
//   dP^T = V.dO^T (m64n64k16, SS), P^T and dS^T in registers, then dv +=
//   P^T.dO and dk += dS^T.Q (m64n96k16, RS, dO and Q MN-major). No P^T
//   exchange, no named barriers 1 and 2. Registers a consumer thread: dk 48
//   + dv 48 + S^T 32 + dP^T 32 + bf16 fragments 32, no spills.
// - no padding: K, V and the Q / dO tiles are three 32-column boxes at the
//   64-byte swizzle (hopper.cuh make_desc64).
// - one ring of DKV_STAGES_D96 = 4 stages of 64-query Q, dO, lse and delta
//   tiles serves both warpgroups, so Q / dO cross L2 once for 128 keys, not
//   64 (4096 CTAs at this shape where the template launches 8192); K + V 48
//   KB + 4 x 24 KB: 144 KB.
// - the causal walk: the CTA walks from its first key's diagonal; the upper
//   half's keys reach their diagonal one query tile later, so a warpgroup
//   skips the math of the tiles its keys miss (a contiguous run) but still
//   waits on every phase of the ring and frees every stage.
// - overlap as the d = 96 forward: a warpgroup issues tile i's S^T and dP^T,
//   then tile i-1's dv and dk, and forms tile i's P^T while dP^T and those
//   run, then its dS^T while dv and dk run; the two warpgroups take turns issuing through named barriers 3 and
//   4 (n + 1 turns each, idle tiles too).
// - the position test only on tiles where some query misses some key of
//   the warpgroup (the diagonal, a window's edge); elsewhere only each key
//   row's validity.

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
constexpr int DKV_BK_D96 = 128;    // dk/dv at d = 96: keys per CTA, 64 a consumer warpgroup
constexpr int DKV_STAGES_D96 = 4;  // dk/dv at d = 96: Q / dO ring depth
constexpr int BOX_D96 = 32;        // columns per TMA box at d = 96 (64 bytes: the 64-byte swizzle)
constexpr int BAR_TURN = 3;        // dk/dv at d = 96: consumer warpgroup cw's turn is named barrier BAR_TURN + cw

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
// dk / dv at d = 96: one warpgroup per 64-key half of a 128-key CTA (header)
// ---------------------------------------------------------------------------

struct DkvSmem96 {
  static constexpr int ST = DKV_STAGES_D96;
  static constexpr int CH = 96 / BOX_D96;           // three boxes a row
  static constexpr int KV_BOX = DKV_BK_D96 * 64;    // one box of K or V: 128 rows of 64 bytes
  static constexpr int QD_BOX = DKV_BQ * 64;        // one box of a Q or dO tile
  static constexpr int KV_BYTES = CH * KV_BOX;
  static constexpr int QD_BYTES = CH * QD_BOX;
  static constexpr int K = 0;
  static constexpr int V = K + KV_BYTES;
  static constexpr int Q = V + KV_BYTES;                  // Q[stage]
  static constexpr int DO = Q + ST * QD_BYTES;            // dO[stage]
  static constexpr int KMASK = DO + ST * QD_BYTES;        // float[DKV_BK_D96]
  static constexpr int LSE = KMASK + DKV_BK_D96 * 4;      // float[stage][BQ], log2 units
  static constexpr int DELTA = LSE + ST * DKV_BQ * 4;     // float[stage][BQ]
  static constexpr int BAR = DELTA + ST * DKV_BQ * 4;     // kv, full[stage], empty[stage]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * ST);
  static constexpr int ALLOC = BYTES + 1024;
};

// S^T = K.Q^T and dP^T = V.dO^T of a warpgroup's 64 keys and a 64-query
// tile: m64n64k16 over the 6 k16 steps of the 96 columns, all operands
// K-major; a commit group each, so P^T forms while dP^T runs.
__device__ __forceinline__ void issue_sdp96(float (&st)[32], float (&dp)[32], uint32_t k_base, uint32_t v_base,
                                            uint32_t q_s, uint32_t do_s) {
  using L = DkvSmem96;
  fence_regs<32>(st);
  fence_regs<32>(dp);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 6; ++kk) {
    const uint32_t off = (kk % 2) * 32;  // 16 columns of the 64-byte row
    wgmma_ss(st, make_desc64(k_base + (kk / 2) * L::KV_BOX + off, 16, 512),
             make_desc64(q_s + (kk / 2) * L::QD_BOX + off, 16, 512), kk > 0);
  }
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < 6; ++kk) {
    const uint32_t off = (kk % 2) * 32;
    wgmma_ss(dp, make_desc64(v_base + (kk / 2) * L::KV_BOX + off, 16, 512),
             make_desc64(do_s + (kk / 2) * L::QD_BOX + off, 16, 512), kk > 0);
  }
  wgmma_commit();
}

// dv += P^T.dO and dk += dS^T.Q: m64n96k16 over the tile's 4 k16 steps of
// queries, A from registers, dO and Q MN-major (three boxes one leading
// offset apart); one commit group.
__device__ __forceinline__ void issue_acc96(float (&dv)[48], float (&dk)[48], const uint32_t (&pf)[DKV_BQ / 16][4],
                                            const uint32_t (&df)[DKV_BQ / 16][4], uint32_t q_s, uint32_t do_s) {
  using L = DkvSmem96;
  fence_regs<48>(dv);
  fence_regs<48>(dk);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DKV_BQ / 16; ++kk) wgmma_rs_n96(dv, pf[kk], make_desc64(do_s + kk * 16 * 64, L::QD_BOX, 512));
#pragma unroll
  for (int kk = 0; kk < DKV_BQ / 16; ++kk) wgmma_rs_n96(dk, df[kk], make_desc64(q_s + kk * 16 * 64, L::QD_BOX, 512));
  wgmma_commit();
}

// P^T = 2^(S^T * sl2 - lse) with the forward's mask for this thread's keys
// key0 (valid kv0, queries qs0) and key1, in place (st becomes P^T).
// WHOLE: every query of the tile reaches every key of the warpgroup by
// position, so only the keys' validity masks (one per row). lse is read two
// queries at once.
template <bool WHOLE>
__device__ __forceinline__ void probs96(float (&st)[32], const float* ls, int q0, bool kv0, bool kv1, int2 qs0,
                                        int2 qs1, float sl2, int t4) {
  const float mask2 = TRLX_MASK_VAL * LOG2E;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(ls + j * 8 + 2 * t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int query = q0 + j * 8 + 2 * t4 + (e & 1);
      const int2 qs = e < 2 ? qs0 : qs1;
      const bool valid = (e < 2 ? kv0 : kv1) && (WHOLE || (query >= qs.x && query <= qs.y));
      st[j * 4 + e] = exp2_ftz((valid ? st[j * 4 + e] * sl2 : mask2) - (e & 1 ? l2.y : l2.x));
    }
  }
}

// dS^T = P^T (dP^T - delta), in place (dp becomes dS^T).
__device__ __forceinline__ void dsT96(const float (&st)[32], float (&dp)[32], const float* dl, int t4) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 d2 = *reinterpret_cast<const float2*>(dl + j * 8 + 2 * t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[j * 4 + e] = st[j * 4 + e] * (dp[j * 4 + e] - (e & 1 ? d2.y : d2.x));
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dkv_d96_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                             BwdParams p) {
  using L = DkvSmem96;
  constexpr int BKC = DKV_BK_D96, BQT = DKV_BQ, ST = L::ST, CH = L::CH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  const uint32_t sbase = smem_u32(sm);
  float* kms = reinterpret_cast<float*>(sm + L::KMASK);
  float* lse_s = reinterpret_cast<float*>(sm + L::LSE);
  float* delta_s = reinterpret_cast<float*>(sm + L::DELTA);
  const uint32_t bar_kv = sbase + L::BAR;
  auto bar_f = [&](int s) { return sbase + L::BAR + 8 * (1 + s); };
  auto bar_e = [&](int s) { return sbase + L::BAR + 8 * (1 + ST + s); };

  // Key tiles of a head are neighbours in the grid (key tile 0, the longest
  // walk, first), so a wave's CTAs share their Q / dO tiles in L2.
  const int bh = (int)blockIdx.x / p.n_tiles, hi = bh % p.h, bi = bh / p.h;
  const int k0 = (int)(blockIdx.x % p.n_tiles) * BKC, T = p.T;
  // Query tiles the CTA visits: under causality from the diagonal of key k0
  // in the offset frame, to T, or with a window to the last query that still
  // sees the CTA's last key below T; none when no query reaches a key of it.
  const int nq = (T + BQT - 1) / BQT;
  const int qt_lo = !p.causal ? 0 : k0 + p.offset > T - 1 ? nq : max(0, floor_div(k0 + p.offset, BQT));
  const int qt_hi =
      p.window > 0 ? min(nq - 1, floor_div(min(k0 + BKC, T) - 2 + p.offset + p.window, BQT)) : nq - 1;
  const int n_q = max(0, qt_hi - qt_lo + 1);
  const size_t rv = ((size_t)bi * p.h + hi) * T;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 2);  // the TMA's expect_tx and the staged kv_mask slice
    for (int s = 0; s < ST; ++s) {
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
        tma_load(sbase + L::K + c * L::KV_BOX, &tk, bar_kv, c * BOX_D96, k0, hi, bi);
        tma_load(sbase + L::V + c * L::KV_BOX, &tv, bar_kv, c * BOX_D96, k0, hi, bi);
      }
    }
    for (int j = lane; j < BKC; j += 32) {
      const int key = k0 + j;
      kms[j] = key < T ? p.kmask[(size_t)bi * T + key] : 0.f;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_kv);
    for (int i = 0; i < n_q; ++i) {
      const int s = i % ST, q0 = (qt_lo + i) * BQT;
      mbar_wait(bar_e(s), ((i / ST) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(bar_f(s), 2 * L::QD_BYTES);
        for (int c = 0; c < CH; ++c) {
          tma_load(sbase + L::Q + s * L::QD_BYTES + c * L::QD_BOX, &tq, bar_f(s), c * BOX_D96, q0, hi, bi);
          tma_load(sbase + L::DO + s * L::QD_BYTES + c * L::QD_BOX, &tdo, bar_f(s), c * BOX_D96, q0, hi, bi);
        }
      }
      for (int j = lane; j < BQT; j += 32) {
        const int row = q0 + j;
        lse_s[s * BQT + j] = row < T ? dead_or_log2(p.lse[rv + row]) : 0.f;
        delta_s[s * BQT + j] = row < T ? p.delta[rv + row] : 0.f;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_f(s));
    }
    return;
  }

  // ---- consumers: warpgroup cw owns keys kw0 .. kw0 + 63 and all their math ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int kw0 = k0 + cw * 64;
  const int key0 = kw0 + warp * 16 + g, key1 = key0 + 8;  // this thread's two key rows
  const float sl2 = p.scale * LOG2E;

  // The query tiles whose math this warpgroup runs (the forward's tile test
  // on its 64 keys, cut at T) are a contiguous run [a, b] of the CTA's walk:
  // the upper half's keys reach their diagonal one query tile later.
  int a = n_q, b = -1;
  for (int i = 0; i < n_q; ++i) {
    const int q0 = (qt_lo + i) * BQT;
    if (kw0 < T && flash_tile_live(q0, min(q0 + BQT - 1, T - 1), kw0 + p.offset, min(kw0 + 64, T) - 1 + p.offset,
                                   p.causal, p.window)) {
      a = min(a, i);
      b = i;
    }
  }

  float dk[48], dv[48], st[32], dp[32];
#pragma unroll
  for (int i = 0; i < 48; ++i) dk[i] = dv[i] = 0.f;
  uint32_t pf[BQT / 16][4], df[BQT / 16][4];  // P^T and dS^T rounded to bf16
  mbar_wait(bar_kv, 0);
  const bool kv0 = kms[key0 - k0] > 0.5f, kv1 = kms[key1 - k0] > 0.5f;
  // The query rows that reach keys key0 and key1 by position.
  const int2 qs0 = flash_query_span(key0, p.causal, p.window, p.offset);
  const int2 qs1 = flash_query_span(key1, p.causal, p.window, p.offset);
  const uint32_t k_base = sbase + L::K + cw * 64 * 64, v_base = sbase + L::V + cw * 64 * 64;
  auto q_at = [&](int i) { return sbase + L::Q + (i % ST) * L::QD_BYTES; };
  auto do_at = [&](int i) { return sbase + L::DO + (i % ST) * L::QD_BYTES; };
  auto par = [&](int i) { return (uint32_t)((i / ST) & 1); };
  // Tile i's P^T, with the position test only where some query of the tile
  // misses some key of the warpgroup (the diagonal, a window's edge); its dS^T.
  auto probs = [&](int i) {
    const int q0 = (qt_lo + i) * BQT;
    const bool whole = (!p.causal || kw0 + 63 + p.offset <= q0) &&
                       (p.window <= 0 || kw0 + p.offset + p.window > q0 + BQT - 1);
    const float *ls = lse_s + (i % ST) * BQT;
    if (whole)
      probs96<true>(st, ls, q0, kv0, kv1, qs0, qs1, sl2, t4);
    else
      probs96<false>(st, ls, q0, kv0, kv1, qs0, qs1, sl2, t4);
  };
  auto dsT = [&](int i) { dsT96(st, dp, delta_s + (i % ST) * BQT, t4); };

  // Turns at the tensor core, as the d = 96 forward takes them: n_q + 1 each.
  const int my_turn = BAR_TURN + cw, other_turn = BAR_TURN + 1 - cw;
  if (cw == 1) named_arrive(BAR_TURN, 256);
  auto hand_over = [&](int r) {
    if (cw == 0 || r < n_q) named_arrive(other_turn, 256);
  };
  auto idle_round = [&](int r) {
    if (r < n_q) mbar_wait(bar_f(r % ST), par(r));
    named_sync(my_turn, 256);
    hand_over(r);
    if (r < n_q) mbar_arrive(bar_e(r % ST));
  };

  if (a > b) {
    for (int r = 0; r <= n_q; ++r) idle_round(r);
  } else {
    for (int r = 0; r < a; ++r) idle_round(r);
    // Prologue: S^T and dP^T of tile a.
    mbar_wait(bar_f(a % ST), par(a));
    named_sync(my_turn, 256);
    issue_sdp96(st, dp, k_base, v_base, q_at(a), do_at(a));
    hand_over(a);
    wgmma_wait1();
    fence_regs<32>(st);
    probs(a);
    wgmma_wait0();
    fence_regs<32>(dp);
    dsT(a);
    to_frags<BQT / 16>(pf, st);
    to_frags<BQT / 16>(df, dp);
    // Steady state: tile i's S^T, dP^T and tile i-1's dv, dk in flight together.
    for (int i = a + 1; i <= b; ++i) {
      mbar_wait(bar_f(i % ST), par(i));
      named_sync(my_turn, 256);
      issue_sdp96(st, dp, k_base, v_base, q_at(i), do_at(i));
      issue_acc96(dv, dk, pf, df, q_at(i - 1), do_at(i - 1));
      hand_over(i);
      wgmma_wait2();
      fence_regs<32>(st);
      probs(i);
      wgmma_wait1();
      fence_regs<32>(dp);
      dsT(i);
      wgmma_wait0();
      fence_regs<48>(dv);
      fence_regs<48>(dk);
      fence_frags<BQT / 4>(&pf[0][0]);
      fence_frags<BQT / 4>(&df[0][0]);
      mbar_arrive(bar_e((i - 1) % ST));
      to_frags<BQT / 16>(pf, st);
      to_frags<BQT / 16>(df, dp);
    }
    // Epilogue: dv and dk of tile b, in the round of tile b + 1.
    const int r = b + 1;
    if (r < n_q) mbar_wait(bar_f(r % ST), par(r));
    named_sync(my_turn, 256);
    issue_acc96(dv, dk, pf, df, q_at(b), do_at(b));
    hand_over(r);
    wgmma_wait0();
    fence_regs<48>(dv);
    fence_regs<48>(dk);
    fence_frags<BQT / 4>(&pf[0][0]);
    fence_frags<BQT / 4>(&df[0][0]);
    mbar_arrive(bar_e(b % ST));
    if (r < n_q) mbar_arrive(bar_e(r % ST));
    for (int rr = b + 2; rr <= n_q; ++rr) idle_round(rr);
  }

  const size_t orow = (size_t)p.h * 96;
  const size_t off = (size_t)bi * T * orow + (size_t)hi * 96;
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const int col = j * 8 + 2 * t4;
    if (key0 < T) {
      *reinterpret_cast<uint32_t*>(p.dv + off + (size_t)key0 * orow + col) = pack_bf16(dv[j * 4 + 0], dv[j * 4 + 1]);
      *reinterpret_cast<uint32_t*>(p.dk + off + (size_t)key0 * orow + col) =
          pack_bf16(dk[j * 4 + 0] * p.scale, dk[j * 4 + 1] * p.scale);
    }
    if (key1 < T) {
      *reinterpret_cast<uint32_t*>(p.dv + off + (size_t)key1 * orow + col) = pack_bf16(dv[j * 4 + 2], dv[j * 4 + 3]);
      *reinterpret_cast<uint32_t*>(p.dk + off + (size_t)key1 * orow + col) =
          pack_bf16(dk[j * 4 + 2] * p.scale, dk[j * 4 + 3] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Maps {
  CUtensorMap q, k, v, dout;
};

// Tensor maps over the strided q/k/v views and the contiguous dO, with boxes
// of `qrows` rows for q and dO and `krows` for k and v, BOX_COLS columns wide.
template <int BOX_COLS = 64>
bool make_maps(Maps* m, const void* q, const void* k, const void* v, const void* dout, int b, int T, int h, int d,
               int qsb, int qst, int qsh, int ksb, int kst, int ksh, int vsb, int vst, int vsh, int qrows,
               int krows) {
  return make_map<BOX_COLS>(&m->q, q, d, T, h, b, qst, qsh, qsb, qrows) &&
         make_map<BOX_COLS>(&m->k, k, d, T, h, b, kst, ksh, ksb, krows) &&
         make_map<BOX_COLS>(&m->v, v, d, T, h, b, vst, vsh, vsb, krows) &&
         make_map<BOX_COLS>(&m->dout, dout, d, T, h, b, h * d, d, T * h * d, qrows);
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

// d = 96 launches its own dk/dv kernel.
template <>
cudaError_t launch_dkv<96>(const Maps& m, BwdParams p, cudaStream_t stream) {
  const int smem = DkvSmem96::ALLOC;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_d96_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  p.n_tiles = (p.T + DKV_BK_D96 - 1) / DKV_BK_D96;
  flash_bwd_dkv_d96_kernel<<<p.n_tiles * p.b * p.h, NTHREADS, smem, stream>>>(m.q, m.k, m.v, m.dout, p);
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
  const bool maps = d == 96 ? make_maps<BOX_D96>(&m, q, k, v, dout, b, T, h, d, qsb, qst, qsh, ksb, kst, ksh, vsb,
                                                 vst, vsh, DKV_BQ, DKV_BK_D96)
                            : make_maps(&m, q, k, v, dout, b, T, h, d, qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh,
                                        DKV_BQ, DKV_BK);
  if (!maps) return (int)cudaErrorInvalidValue;
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
