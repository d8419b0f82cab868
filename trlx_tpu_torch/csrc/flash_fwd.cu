// Flash attention forward for Hopper (sm_90a): TMA loads into an mbarrier
// ring, wgmma on the tensor cores, bf16 in, f32 softmax.
//
// Replaces: trlx_tpu/ops/flash_attention.py:_fwd_kernel (pallas_call in _fwd).
// Computes online-softmax attention over q/k/v [b, T, h, d] with a key
// padding mask, causal or not, an optional trailing window and a key-position
// offset, and emits o [b, T, h, d] (bf16) plus the per-row log-sum-exp lse
// [b, h, T] (f32). The offset puts key k at position k + offset of the query
// frame (ring attention: the visiting chunk's displacement); the causal and
// window tests read that position (common.cuh flash_key_span). Semantics kept
// from the TPU kernel: masked scores are REPLACED by -1e9, the running max
// starts at the finite -1e30, key tiles that the position rule empties are
// skipped, and P is rounded to bf16 before P.V. A row that reaches no key by
// position (every tile skipped, or a wholly future ring chunk) writes zeros
// with lse = -1e30, the JAX kernel's finalisation for l == 0: a log-sum-exp
// combine gives it weight 0 and the backward kernels give it p = 0. Rows that
// reach keys but no valid one (left padding) attend over the tiles their
// warpgroup visits; nothing reads them.
//
// What bounds it on an H100: at the rollout shapes ([8, 768..1024, 16, 256])
// the causal QK^T and P.V are 39-69 GFLOP against 200-270 MB of q/k/v/o:
// HBM bytes (60-80 us) with the tensor cores close behind (39-69 us at the
// 989 TFLOP/s bf16 peak). So the kernel must keep the tensor cores fed.
//
// Design (warp-specialised, one CTA per (128-query tile, head, row), 384
// threads, one CTA per SM):
// - warpgroup 0 is the producer: it gives its registers away (setmaxnreg 24)
//   and one thread issues TMA loads (cp.async.bulk.tensor, 128-byte swizzle,
//   boxes of 64 columns, so a d = 256 row is four boxes): the Q tile once,
//   then K and V tiles of 64 keys into a 2-stage ring guarded by full (one
//   for K, one for V) and empty mbarriers. Its lanes stage each key tile's
//   kv_mask slice in shared memory beside it. Rows past T are zero-filled
//   by TMA's out-of-bounds fill.
// - warpgroups 1 and 2 are consumers (setmaxnreg 240), each owning 64 query
//   rows: S = Q.K^T by wgmma.mma_async m64n64k16 with both operands read
//   from shared memory through descriptors (K-major), the online softmax on
//   the f32 accumulator fragment in registers, then O += P.V by wgmma with
//   A = P from registers (bf16) and B = V through the MN-major (transposed)
//   descriptor, so V needs no transpose. The f32 O accumulator (64 x d per
//   warpgroup, d / 2 registers a thread) stays in registers for the whole
//   key walk. While one warpgroup does its softmax the other's wgmma runs.
// - query tiles are scheduled longest causal walk first (grid y counts the
//   tiles down; at any offset a later tile's causal walk is no shorter, and
//   without causality all walks are equal), and a warpgroup skips the math of
//   the key tiles its 64 rows cannot see; it still waits on their full
//   barriers and frees their stage, so each consumer observes every phase of
//   the ring. A CTA whose rows reach no key walks no tile.
// Shared memory at d = 256: Q 64 KB + 2 x (K 32 KB + V 32 KB) = 192 KB.
// The same template serves d = 64 (GPT-2) and 128 (GPT-Neo 1.3B / 2.7B).
//
// d = 96 (GPT-NeoX-20B: 6144 / 64 heads) has a kernel of its own,
// flash_fwd_d96_kernel. What bounds it at [8, 1024, 64, 96]: 1.03e11 flops
// of Q.K^T and P.V (0.104 ms at the bf16 peak) against 0.40 GB of q, k, v
// and o (0.121 ms at 3.35 TB/s), with 64 heads of 96 giving 2.7e8 scores,
// 2.7x as many a flop as d = 256's: their exp2s (~0.07 ms of the SFUs) and
// scale, mask, max, sum and pack (~0.09 ms) are as large as the bound, so
// they must run while the tensor cores do. The design:
// - no padding: a [rows, 96] tile is three 32-column TMA boxes at the 64-byte
//   swizzle (hopper.cuh make_desc64), so Q.K^T reduces over 6 k16 steps and
//   P.V runs m64n96k16 (wgmma_rs_n96): O is 48 registers a thread, none on
//   zero columns. (d = 128's two 128-byte boxes with columns 96-127 zero-
//   filled spent 1/7 of the tensor work and 16 O registers on padding.)
//   Chosen over reading columns 0-95 of those two boxes with an N = 96
//   MN-major descriptor: 96 is not a whole number of the 128-byte swizzle's
//   64-column atoms, while it is three of the 64-byte swizzle's, and the
//   tiles take 168 KB of shared memory for 3 stages, not 224.
// - key tiles of BK_D96 = 128 (Q.K^T m64n128k16 x 6) in a ring of
//   STAGES_D96 = 3: Q 24 KB + 3 x (K 24 KB + V 24 KB) = 168 KB. Registers a
//   consumer thread: S 64 + O 48 + P fragments 32.
// - intra-warpgroup pipelining: a warpgroup issues S(i) = Q.K(i)^T, then
//   P(i-1).V(i-1), waits for S(i) alone (wgmma.wait_group 1), runs tile i's
//   softmax while P(i-1).V(i-1) runs, then waits for it, rescales O and packs
//   P(i). The walk is written as prologue (S of the first live tile), steady
//   state and epilogue (P.V of the last), so no wgmma sits behind a branch
//   inside the loop.
// - ping-pong (FA3's schedule): the consumers take turns issuing their
//   products through named barriers 1 and 2, so one warpgroup's softmax runs
//   while the other's products hold the tensor cores. Every warpgroup takes
//   n_kv + 1 turns, skipped tiles too, so the turns always pair up.
// - masks as bits: the producer stages each tile's key validity (kv_mask >
//   0.5, below T) as 128 ballot bits. A tile that every row of the
//   warpgroup reaches whole by position and whose keys are all valid skips
//   the mask; the others (diagonal, window-edge, past-T and padded tiles)
//   AND the bits with each row's position span (two prefix masks of the
//   thread's columns) and set the masked raw scores to -inf, which weigh 0
//   beside any valid key, one select a score. Either way the row max is
//   taken on the raw scores and scaled once (rounding is monotone) and p is
//   one fma and one ex2, so a valid score has the same bits on both paths.
//   Testing each score's staged kv_mask float and span instead cost the
//   masked tiles (half of them at this shape, with the rollouts' left
//   padding) more than the tensor work they hold.
// - the query tiles of one head are neighbouring CTAs (longest causal walk
//   first within the head), so a wave's CTAs share each head's K / V in L2:
//   ordered head-fastest, every CTA would stream its K / V tiles from HBM
//   (~0.9 GB at this shape, 0.27 ms).
// Tensor maps are encoded on the host per call over the strided views,
// through cudaGetDriverEntryPoint (no -lcuda), and passed as
// __grid_constant__ parameters.

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 128;  // query rows per CTA (two consumer warpgroups of 64)
constexpr int BK = 64;   // keys per tile
constexpr int STAGES = 2;
constexpr int NTHREADS = 384;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct FlashParams {
  const float* kmask;  // [b, T] key validity (> 0.5 = valid)
  __nv_bfloat16* o;    // [b, T, h, d] contiguous
  float* lse;          // [b, h, T]
  int b, T, h, n_qt;
  float scale;
  int window;
  int causal;  // 0: every key position is reachable (subject to the window)
  int offset;  // key k sits at k + offset in the query frame
};

// ---- shared-memory layout ---------------------------------------------------
template <int D>
struct Smem {
  static constexpr int CHUNKS = box_chunks(D);             // 128-byte column boxes per row
  static constexpr int Q_BYTES = BQ * CHUNKS * 128;
  static constexpr int KV_BYTES = BK * CHUNKS * 128;
  static constexpr int Q = 0;
  static constexpr int K = Q + Q_BYTES;                     // K[stage]
  static constexpr int V = K + STAGES * KV_BYTES;           // V[stage]
  static constexpr int KMASK = V + STAGES * KV_BYTES;       // float[stage][BK]
  static constexpr int BAR = KMASK + STAGES * BK * 4;       // mbarriers
  static constexpr int BYTES = BAR + 8 * (1 + 3 * STAGES);
  static constexpr int ALLOC = BYTES + 1024;                // room to align the base to 1024
};

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, FlashParams p) {
  using L = Smem<D>;
  constexpr int CH = L::CHUNKS;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned: the 128-byte swizzle pattern repeats every 8 rows of 128 bytes.
  unsigned char* sm = align_1024(smem_raw);
  const uint32_t sbase = smem_u32(sm);
  float* kms = reinterpret_cast<float*>(sm + L::KMASK);
  const uint32_t bar_q = sbase + L::BAR;
  auto bar_k = [&](int s) { return sbase + L::BAR + 8 * (1 + s); };
  auto bar_v = [&](int s) { return sbase + L::BAR + 8 * (1 + STAGES + s); };
  auto bar_e = [&](int s) { return sbase + L::BAR + 8 * (1 + 2 * STAGES + s); };

  const int bh = blockIdx.x, hi = bh % p.h, bi = bh / p.h;
  const int qt = p.n_qt - 1 - (int)blockIdx.y;  // longest causal walk first
  const int q0 = qt * BQ, T = p.T;
  // Key tiles the CTA visits: under causality up to the diagonal of its last
  // row, with a window from the first key its first row sees (both in the
  // offset frame); none when no row reaches a key.
  const int n_kt = (T + BK - 1) / BK;
  const int kt_hi = p.causal ? min(n_kt - 1, floor_div(min(q0 + BQ, T) - 1 - p.offset, BK)) : n_kt - 1;
  const int kt_lo = p.window > 0 ? max(0, floor_div(q0 - p.window + 1 - p.offset, BK)) : 0;
  const int n_kv = max(0, kt_hi - kt_lo + 1);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k(s), 2);  // the TMA's expect_tx and the staged kv_mask slice
      mbar_init(bar_v(s), 1);
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
      mbar_expect_tx(bar_q, L::Q_BYTES);
      for (int c = 0; c < CH; ++c) tma_load(sbase + L::Q + c * BQ * 128, &tq, bar_q, c * 64, q0, hi, bi);
    }
    for (int i = 0; i < n_kv; ++i) {
      const int s = i % STAGES, k0 = (kt_lo + i) * BK;
      mbar_wait(bar_e(s), ((i / STAGES) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(bar_k(s), L::KV_BYTES);
        for (int c = 0; c < CH; ++c)
          tma_load(sbase + L::K + s * L::KV_BYTES + c * BK * 128, &tk, bar_k(s), c * 64, k0, hi, bi);
        mbar_expect_tx(bar_v(s), L::KV_BYTES);
        for (int c = 0; c < CH; ++c)
          tma_load(sbase + L::V + s * L::KV_BYTES + c * BK * 128, &tv, bar_v(s), c * 64, k0, hi, bi);
      }
      // The mask slice loads while the tiles are in flight; its arrival is
      // the K barrier's second.
      for (int j = lane; j < BK; j += 32) {
        const int key = k0 + j;
        kms[s * BK + j] = key < T ? p.kmask[(size_t)bi * T + key] : 0.f;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_k(s));
    }
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wg - 1;                   // 64-row half of the tile
  const int warp = (threadIdx.x / 32) & 3; // warp within the warpgroup: 16 rows
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int rlo = q0 + cw * 64;            // first row of this warpgroup
  const int row0 = rlo + warp * 16 + g, row1 = row0 + 8;
  const float sl2 = p.scale * LOG2E;       // scores in log2 units
  const float mask2 = TRLX_MASK_VAL * LOG2E;

  float o[CH][32];
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m0 = TRLX_M_INIT, m1 = TRLX_M_INIT, l0 = 0.f, l1 = 0.f;
  // The keys rows row0 and row1 reach by position (past T excluded).
  const int2 sp0 = flash_key_span(row0, T, p.causal, p.window, p.offset);
  const int2 sp1 = flash_key_span(row1, T, p.causal, p.window, p.offset);

  mbar_wait(bar_q, 0);
  const uint32_t q_base = sbase + L::Q + cw * 64 * 128;

  for (int i = 0; i < n_kv; ++i) {
    const int s = i % STAGES;
    const uint32_t par = (i / STAGES) & 1;
    const int k0 = (kt_lo + i) * BK;
    // Tile liveness for this warpgroup's 64 rows and the tile's keys, both cut
    // at T (the TPU kernel's _run_if_live).
    const bool live = rlo < T && flash_tile_live(rlo, min(rlo + 63, T - 1), k0 + p.offset,
                                                 min(k0 + BK, T) - 1 + p.offset, p.causal, p.window);
    // Both warpgroups wait on every phase of the ring, live or not: a parity
    // wait on a phase it skipped two tiles back would pass at once.
    mbar_wait(bar_k(s), par);
    if (!live) {
      mbar_wait(bar_v(s), par);
    } else {
      float sc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = 0.f;
      const uint32_t k_base = sbase + L::K + s * L::KV_BYTES;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns of the 128-byte row
        const uint64_t da = make_desc(q_base + (kk / 4) * BQ * 128 + off, 16, 1024);
        const uint64_t db = make_desc(k_base + (kk / 4) * BK * 128 + off, 16, 1024);
        wgmma_ss(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);

      // Scale, mask (replace, not add), online softmax in log2 units.
      const float* km = kms + s * BK;
      float mx0 = mask2, mx1 = mask2;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = j * 8 + 2 * t4 + (e & 1);
          const int key = k0 + kk;
          const int2 sp = e < 2 ? sp0 : sp1;
          const float v = km[kk] > 0.5f && key >= sp.x && key <= sp.y ? sc[j * 4 + e] * sl2 : mask2;
          sc[j * 4 + e] = v;
          if (e < 2) mx0 = fmaxf(mx0, v); else mx1 = fmaxf(mx1, v);
        }
      }
      const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
      const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + 2 * t4 + (e & 1);
          // Keys past T exist only as tile padding: weight exactly zero.
          const float pv = key < T ? exp2f(sc[j * 4 + e] - (e < 2 ? mn0 : mn1)) : 0.f;
          sc[j * 4 + e] = pv;
          if (e < 2) rs0 += pv; else rs1 += pv;
        }
      }
      l0 = al0 * l0 + quad_sum(rs0);
      l1 = al1 * l1 + quad_sum(rs1);
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[c][j * 4 + 0] *= al0; o[c][j * 4 + 1] *= al0;
          o[c][j * 4 + 2] *= al1; o[c][j * 4 + 3] *= al1;
        }
      // P rounded to bf16 (the value dtype) as the TPU kernel does, in the
      // A-fragment layout: keys 16kk.. of rows g and g + 8.
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[(2 * kk) * 4 + 0], sc[(2 * kk) * 4 + 1]);
        pa[kk][1] = pack_bf16(sc[(2 * kk) * 4 + 2], sc[(2 * kk) * 4 + 3]);
        pa[kk][2] = pack_bf16(sc[(2 * kk + 1) * 4 + 0], sc[(2 * kk + 1) * 4 + 1]);
        pa[kk][3] = pack_bf16(sc[(2 * kk + 1) * 4 + 2], sc[(2 * kk + 1) * 4 + 3]);
      }

      mbar_wait(bar_v(s), par);
      const uint32_t v_base = sbase + L::V + s * L::KV_BYTES;
#pragma unroll
      for (int c = 0; c < CH; ++c) fence_regs(o[c]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs(o[c], pa[kk], make_desc(v_base + c * BK * 128 + kk * 16 * 128, BK * 128, 1024));
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int c = 0; c < CH; ++c) fence_regs(o[c]);
    }
    mbar_arrive(bar_e(s));
  }

  // Finalize: o = acc / l; lse = m + log l (natural units); a row that
  // reaches no key by position (l == 0 if its tiles were all skipped, else
  // only masked keys of a live tile) gets o = 0 and lse = M_INIT.
  const bool live0 = l0 > 0.f && sp0.x <= sp0.y;
  const bool live1 = l1 > 0.f && sp1.x <= sp1.y;
  const float ls0 = fmaxf(l0, 1e-30f), ls1 = fmaxf(l1, 1e-30f);
  const float inv0 = live0 ? 1.f / ls0 : 0.f, inv1 = live1 ? 1.f / ls1 : 0.f;
  const size_t orow = (size_t)p.h * D;
  __nv_bfloat16* ob = p.o + (size_t)bi * T * orow + (size_t)hi * D;
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c * 64 + j * 8 + 2 * t4;
      if (row0 < T)
        *reinterpret_cast<uint32_t*>(ob + (size_t)row0 * orow + col) =
            pack_bf16(o[c][j * 4 + 0] * inv0, o[c][j * 4 + 1] * inv0);
      if (row1 < T)
        *reinterpret_cast<uint32_t*>(ob + (size_t)row1 * orow + col) =
            pack_bf16(o[c][j * 4 + 2] * inv1, o[c][j * 4 + 3] * inv1);
    }
  if (t4 == 0) {
    float* lb = p.lse + ((size_t)bi * p.h + hi) * T;
    if (row0 < T) lb[row0] = live0 ? m0 * LN2 + logf(ls0) : TRLX_M_INIT;
    if (row1 < T) lb[row1] = live1 ? m1 * LN2 + logf(ls1) : TRLX_M_INIT;
  }
}

// ---------------------------------------------------------------------------
// d = 96: its own tiles, layout and schedule (header).
// ---------------------------------------------------------------------------
constexpr int BK_D96 = 128;    // keys per tile at d = 96
constexpr int STAGES_D96 = 3;  // K / V ring depth at d = 96
constexpr int BOX_D96 = 32;    // columns per TMA box at d = 96 (64 bytes: the 64-byte swizzle)
constexpr int BAR_TURN = 1;    // named barriers 1 and 2: consumer warpgroup cw's turn is BAR_TURN + cw

struct Smem96 {
  static constexpr int CH = 96 / BOX_D96;                  // three boxes a row
  static constexpr int Q_BOX = BQ * 64;                    // one box of the Q tile: 128 rows of 64 bytes
  static constexpr int KV_BOX = BK_D96 * 64;               // one box of a K or V tile
  static constexpr int Q_BYTES = CH * Q_BOX;
  static constexpr int KV_BYTES = CH * KV_BOX;
  static constexpr int Q = 0;
  static constexpr int K = Q + Q_BYTES;                         // K[stage]
  static constexpr int V = K + STAGES_D96 * KV_BYTES;           // V[stage]
  static constexpr int KVBITS = V + STAGES_D96 * KV_BYTES;      // uint4[stage]: the tile's 128 key-validity bits
  static constexpr int BAR = KVBITS + STAGES_D96 * 16;          // q, k[stage], v[stage], empty[stage]
  static constexpr int BYTES = BAR + 8 * (1 + 3 * STAGES_D96);
  static constexpr int ALLOC = BYTES + 1024;
};

// This thread's 32 columns of a 128-key tile (key 8 j + 2 t4 + c at bit
// 2 j + c, the order of the S fragment) taken from the tile's 128 bits.
__device__ __forceinline__ uint32_t thread_cols(uint4 w, int t4) {
  const uint32_t ws[4] = {w.x >> (2 * t4), w.y >> (2 * t4), w.z >> (2 * t4), w.w >> (2 * t4)};
  uint32_t r = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) r |= ((ws[j >> 2] >> (8 * (j & 3))) & 3u) << (2 * j);
  return r;
}

// The bits of this thread's columns below tile-local key x: a prefix in
// bit order, since the column grows with the bit.
__device__ __forceinline__ uint32_t cols_below(int x, int t4) {
  const int y = x - 2 * t4;
  const int n = min(16, max(0, (y + 7) >> 3)) + min(16, max(0, (y + 6) >> 3));
  return n >= 32 ? 0xffffffffu : (1u << n) - 1u;
}

// S = Q.K^T of a 64-row warpgroup and a 128-key tile: m64n128k16 over the
// 6 k16 steps of the 96 columns, both operands K-major; one commit group.
__device__ __forceinline__ void issue_s96(float (&sc)[64], uint32_t q_base, uint32_t k_base) {
  fence_regs<64>(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 6; ++kk) {
    const uint32_t off = (kk % 2) * 32;  // 16 columns of the 64-byte row
    wgmma_ss_n128(sc, make_desc64(q_base + (kk / 2) * Smem96::Q_BOX + off, 16, 512),
                  make_desc64(k_base + (kk / 2) * Smem96::KV_BOX + off, 16, 512), kk > 0);
  }
  wgmma_commit();
}

// O += P.V: m64n96k16 over the tile's 8 k16 steps of keys, P from registers,
// V MN-major (its three boxes one leading offset apart); one commit group.
__device__ __forceinline__ void issue_pv96(float (&o)[48], const uint32_t (&pa)[BK_D96 / 16][4], uint32_t v_base) {
  fence_regs<48>(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK_D96 / 16; ++kk)
    wgmma_rs_n96(o, pa[kk], make_desc64(v_base + kk * 16 * 64, Smem96::KV_BOX, 512));
  wgmma_commit();
}

// One 128-key tile of the online softmax for this thread's rows row0 and
// row1, in log2 units: the raw scores sc become p = 2^(s * sl2 - m_new)
// (keys past T exactly 0), m0 / m1 the new maxima, l0 / l1 this thread's
// partial row sums (rescaled), al0 / al1 the factors that rescale O.
// `full`: every pair of the tile is reachable by position and every key
// valid, so no score is tested. Otherwise v0 / v1 are the row's valid
// columns (thread_cols bit order): the others' raw scores become -inf, so
// they weigh 0 beside any valid key, and count as the replaced -1e9 (log2:
// mask2) in the max. A row with no valid key yet (its max is mask2) weighs
// every masked key below T 1, as 2^(mask2 - mask2) does.
__device__ __forceinline__ void softmax96(float (&sc)[64], float& m0, float& m1, float& l0, float& l1, float& al0,
                                          float& al1, bool full, uint32_t v0, uint32_t v1, int kend, float sl2,
                                          int t4) {
  const float mask2 = TRLX_MASK_VAL * LOG2E, ninf = __int_as_float(0xff800000);
  if (!full) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!(((e < 2 ? v0 : v1) >> (2 * j + (e & 1))) & 1u)) sc[j * 4 + e] = ninf;
  }
  float mx0 = ninf, mx1 = ninf;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[j * 4 + 0], sc[j * 4 + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[j * 4 + 2], sc[j * 4 + 3]));
  }
  // The max of the scaled scores (rounding is monotone, sl2 > 0), and of
  // mask2 for the masked ones.
  mx0 = fmaxf(quad_max(mx0) * sl2, mask2);
  mx1 = fmaxf(quad_max(mx1) * sl2, mask2);
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  al0 = exp2_ftz(m0 - mn0);
  al1 = exp2_ftz(m1 - mn1);
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pv = exp2_ftz(fmaf(sc[j * 4 + e], sl2, -(e < 2 ? mn0 : mn1)));
      sc[j * 4 + e] = pv;
      if (e < 2) rs0 += pv; else rs1 += pv;
    }
  if (!full && (mn0 == mask2 || mn1 == mask2)) {
    const uint32_t below = cols_below(kend, t4);  // keys past T weigh exactly 0
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if ((e < 2 ? mn0 : mn1) == mask2) sc[j * 4 + e] = (below >> (2 * j + (e & 1))) & 1u ? 1.f : 0.f;
    if (mn0 == mask2) rs0 = (float)__popc(below);
    if (mn1 == mask2) rs1 = (float)__popc(below);
  }
  l0 = al0 * l0 + rs0;
  l1 = al1 * l1 + rs1;
  m0 = mn0;
  m1 = mn1;
}

__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd_d96_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, FlashParams p) {
  using L = Smem96;
  constexpr int BKH = BK_D96, ST = STAGES_D96, CH = L::CH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  const uint32_t sbase = smem_u32(sm);
  uint4* kvbits = reinterpret_cast<uint4*>(sm + L::KVBITS);
  const uint32_t bar_q = sbase + L::BAR;
  auto bar_k = [&](int s) { return sbase + L::BAR + 8 * (1 + s); };
  auto bar_v = [&](int s) { return sbase + L::BAR + 8 * (1 + ST + s); };
  auto bar_e = [&](int s) { return sbase + L::BAR + 8 * (1 + 2 * ST + s); };

  // The query tiles of a head are neighbouring CTAs, longest causal walk first.
  const int bh = (int)blockIdx.x / p.n_qt, hi = bh % p.h, bi = bh / p.h;
  const int qt = p.n_qt - 1 - (int)(blockIdx.x % p.n_qt);
  const int q0 = qt * BQ, T = p.T;
  const int n_kt = (T + BKH - 1) / BKH;
  const int kt_hi = p.causal ? min(n_kt - 1, floor_div(min(q0 + BQ, T) - 1 - p.offset, BKH)) : n_kt - 1;
  const int kt_lo = p.window > 0 ? max(0, floor_div(q0 - p.window + 1 - p.offset, BKH)) : 0;
  const int n_kv = max(0, kt_hi - kt_lo + 1);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_k(s), 2);  // the TMA's expect_tx and the staged key-validity bits
      mbar_init(bar_v(s), 1);
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
      mbar_expect_tx(bar_q, L::Q_BYTES);
      for (int c = 0; c < CH; ++c) tma_load(sbase + L::Q + c * L::Q_BOX, &tq, bar_q, c * BOX_D96, q0, hi, bi);
    }
    for (int i = 0; i < n_kv; ++i) {
      const int s = i % ST, k0 = (kt_lo + i) * BKH;
      mbar_wait(bar_e(s), ((i / ST) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(bar_k(s), L::KV_BYTES);
        for (int c = 0; c < CH; ++c)
          tma_load(sbase + L::K + s * L::KV_BYTES + c * L::KV_BOX, &tk, bar_k(s), c * BOX_D96, k0, hi, bi);
        mbar_expect_tx(bar_v(s), L::KV_BYTES);
        for (int c = 0; c < CH; ++c)
          tma_load(sbase + L::V + s * L::KV_BYTES + c * L::KV_BOX, &tv, bar_v(s), c * BOX_D96, k0, hi, bi);
      }
      // The tile's key validity (kv_mask > 0.5, below T) as 128 bits, staged
      // while the tiles are in flight; its arrival is the K barrier's second.
      uint32_t bits[BKH / 32];
#pragma unroll
      for (int w = 0; w < BKH / 32; ++w) {
        const int key = k0 + w * 32 + lane;
        bits[w] = __ballot_sync(0xffffffffu, key < T && p.kmask[(size_t)bi * T + key] > 0.5f);
      }
      if (lane == 0) kvbits[s] = make_uint4(bits[0], bits[1], bits[2], bits[3]);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_k(s));
    }
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wg - 1;                   // 64-row half of the tile
  const int warp = (threadIdx.x / 32) & 3; // warp within the warpgroup: 16 rows
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int rlo = q0 + cw * 64;            // first row of this warpgroup
  const int row0 = rlo + warp * 16 + g, row1 = row0 + 8;
  const float sl2 = p.scale * LOG2E;       // scores in log2 units
  const int2 sp0 = flash_key_span(row0, T, p.causal, p.window, p.offset);
  const int2 sp1 = flash_key_span(row1, T, p.causal, p.window, p.offset);

  // The tiles whose math this warpgroup runs (the TPU kernel's _run_if_live,
  // rows and keys cut at T) are a contiguous run [a, b] of the walk: the
  // causal test turns false and the window test true as the tile advances.
  int a = n_kv, b = -1;
  for (int i = 0; i < n_kv; ++i) {
    const int k0 = (kt_lo + i) * BKH;
    if (rlo < T && flash_tile_live(rlo, min(rlo + 63, T - 1), k0 + p.offset, min(k0 + BKH, T) - 1 + p.offset,
                                   p.causal, p.window)) {
      a = min(a, i);
      b = i;
    }
  }
  float o[48];
#pragma unroll
  for (int i = 0; i < 48; ++i) o[i] = 0.f;
  float sc[64];
  uint32_t pa[BKH / 16][4];
  float m0 = TRLX_M_INIT, m1 = TRLX_M_INIT, l0 = 0.f, l1 = 0.f, al0, al1;
  // Tile i's softmax: unmasked when every row of the warpgroup reaches every
  // key by position and the producer's bits say every key is valid; else
  // with the valid columns of rows row0 and row1 (the bits and the spans).
  auto softmax = [&](int i) {
    const int k0 = (kt_lo + i) * BKH;
    const uint4 w = kvbits[i % ST];
    const bool full = p.scale > 0.f && (w.x & w.y & w.z & w.w) == 0xffffffffu &&
                      (!p.causal || k0 + BKH - 1 + p.offset <= rlo) &&
                      (p.window <= 0 || k0 + p.offset > rlo + 63 - p.window);
    uint32_t v0 = 0, v1 = 0;
    if (!full) {
      const uint32_t kv = thread_cols(w, t4);
      v0 = kv & cols_below(sp0.y - k0 + 1, t4) & ~cols_below(sp0.x - k0, t4);
      v1 = kv & cols_below(sp1.y - k0 + 1, t4) & ~cols_below(sp1.x - k0, t4);
    }
    softmax96(sc, m0, m1, l0, l1, al0, al1, full, v0, v1, min(BKH, T - k0), sl2, t4);
  };

  const uint32_t q_base = sbase + L::Q + cw * 64 * 64;
  auto k_at = [&](int i) { return sbase + L::K + (i % ST) * L::KV_BYTES; };
  auto v_at = [&](int i) { return sbase + L::V + (i % ST) * L::KV_BYTES; };
  auto par = [&](int i) { return (uint32_t)((i / ST) & 1); };

  // Turns at the tensor core: warpgroup 0 takes the first; each round ends by
  // handing the turn over, but warpgroup 1's last (warpgroup 0 takes none
  // after it), so both take n_kv + 1 turns and every arrival is matched.
  const int my_turn = BAR_TURN + cw, other_turn = BAR_TURN + 1 - cw;
  if (cw == 1) named_arrive(BAR_TURN, 256);
  auto hand_over = [&](int r) {
    if (cw == 0 || r < n_kv) named_arrive(other_turn, 256);
  };
  // A round without math: wait on the tile's phases (both warpgroups observe
  // every phase of the ring), take and hand over the turn, free the stage.
  auto idle_round = [&](int r) {
    if (r < n_kv) {
      mbar_wait(bar_k(r % ST), par(r));
      mbar_wait(bar_v(r % ST), par(r));
    }
    named_sync(my_turn, 256);
    hand_over(r);
    if (r < n_kv) mbar_arrive(bar_e(r % ST));
  };

  mbar_wait(bar_q, 0);
  if (a > b) {
    for (int r = 0; r <= n_kv; ++r) idle_round(r);
  } else {
    for (int r = 0; r < a; ++r) idle_round(r);
    // Prologue: S of tile a.
    mbar_wait(bar_k(a % ST), par(a));
    named_sync(my_turn, 256);
    issue_s96(sc, q_base, k_at(a));
    hand_over(a);
    wgmma_wait0();
    fence_regs<64>(sc);
    softmax(a);
    to_frags<BKH / 16>(pa, sc);
    // Steady state: S(i) and P(i-1).V(i-1) in flight together.
    for (int i = a + 1; i <= b; ++i) {
      mbar_wait(bar_k(i % ST), par(i));
      mbar_wait(bar_v((i - 1) % ST), par(i - 1));
      named_sync(my_turn, 256);
      issue_s96(sc, q_base, k_at(i));
      issue_pv96(o, pa, v_at(i - 1));
      hand_over(i);
      wgmma_wait1();
      fence_regs<64>(sc);
      softmax(i);
      wgmma_wait0();
      fence_regs<48>(o);
      fence_frags<BKH / 4>(&pa[0][0]);
      mbar_arrive(bar_e((i - 1) % ST));
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        o[j * 4 + 0] *= al0; o[j * 4 + 1] *= al0;
        o[j * 4 + 2] *= al1; o[j * 4 + 3] *= al1;
      }
      to_frags<BKH / 16>(pa, sc);
    }
    // Epilogue: P(b).V(b), in the round of tile b + 1 (which no math reaches).
    const int r = b + 1;
    if (r < n_kv) {
      mbar_wait(bar_k(r % ST), par(r));
      mbar_wait(bar_v(r % ST), par(r));
    }
    mbar_wait(bar_v(b % ST), par(b));
    named_sync(my_turn, 256);
    issue_pv96(o, pa, v_at(b));
    hand_over(r);
    wgmma_wait0();
    fence_regs<48>(o);
    fence_frags<BKH / 4>(&pa[0][0]);
    mbar_arrive(bar_e(b % ST));
    if (r < n_kv) mbar_arrive(bar_e(r % ST));
    for (int rr = b + 2; rr <= n_kv; ++rr) idle_round(rr);
  }

  // Finalize as the template does: o = acc / l, lse = m + log l (natural
  // units); a row that reaches no key gets o = 0 and lse = M_INIT.
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const bool live0 = l0 > 0.f && sp0.x <= sp0.y;
  const bool live1 = l1 > 0.f && sp1.x <= sp1.y;
  const float ls0 = fmaxf(l0, 1e-30f), ls1 = fmaxf(l1, 1e-30f);
  const float inv0 = live0 ? 1.f / ls0 : 0.f, inv1 = live1 ? 1.f / ls1 : 0.f;
  const size_t orow = (size_t)p.h * 96;
  __nv_bfloat16* ob = p.o + (size_t)bi * T * orow + (size_t)hi * 96;
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const int col = j * 8 + 2 * t4;
    if (row0 < T)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row0 * orow + col) = pack_bf16(o[j * 4 + 0] * inv0, o[j * 4 + 1] * inv0);
    if (row1 < T)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row1 * orow + col) = pack_bf16(o[j * 4 + 2] * inv1, o[j * 4 + 3] * inv1);
  }
  if (t4 == 0) {
    float* lb = p.lse + ((size_t)bi * p.h + hi) * T;
    if (row0 < T) lb[row0] = live0 ? m0 * LN2 + logf(ls0) : TRLX_M_INIT;
    if (row1 < T) lb[row1] = live1 ? m1 * LN2 + logf(ls1) : TRLX_M_INIT;
  }
}

// ---- host side ----------------------------------------------------------------
template <int D>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const FlashParams& p,
                   cudaStream_t stream) {
  const int smem = Smem<D>::ALLOC;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<D><<<dim3(p.b * p.h, p.n_qt), NTHREADS, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// d = 96 launches its own kernel.
template <>
cudaError_t launch<96>(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const FlashParams& p,
                       cudaStream_t stream) {
  const int smem = Smem96::ALLOC;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_d96_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_d96_kernel<<<p.b * p.h * p.n_qt, NTHREADS, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, const void* kmask, void* o, void* lse,
                              int b, int T, int h, int d, int qsb, int qst, int qsh, int ksb, int kst, int ksh,
                              int vsb, int vst, int vsh, float scale, int window, int causal, int offset,
                              void* stream) {
  if (!flash_head_dim_ok(d)) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  const bool maps = d == 96 ? make_map<BOX_D96>(&tq, q, d, T, h, b, qst, qsh, qsb, BQ) &&
                                  make_map<BOX_D96>(&tk, k, d, T, h, b, kst, ksh, ksb, BK_D96) &&
                                  make_map<BOX_D96>(&tv, v, d, T, h, b, vst, vsh, vsb, BK_D96)
                            : make_map(&tq, q, d, T, h, b, qst, qsh, qsb, BQ) &&
                                  make_map(&tk, k, d, T, h, b, kst, ksh, ksb, BK) &&
                                  make_map(&tv, v, d, T, h, b, vst, vsh, vsb, BK);
  if (!maps) return (int)cudaErrorInvalidValue;
  FlashParams p;
  p.kmask = static_cast<const float*>(kmask);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.b = b; p.T = T; p.h = h;
  p.n_qt = (T + BQ - 1) / BQ;
  p.scale = scale; p.window = window;
  p.causal = causal; p.offset = offset;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return (int)launch<64>(tq, tk, tv, p, s);
    case 96: return (int)launch<96>(tq, tk, tv, p, s);
    case 128: return (int)launch<128>(tq, tk, tv, p, s);
    case 256: return (int)launch<256>(tq, tk, tv, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
