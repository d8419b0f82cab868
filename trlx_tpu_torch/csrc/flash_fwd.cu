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
// The same template serves d = 64 (GPT-2), 96 (GPT-NeoX-20B: 6144 / 64
// heads) and 128 (GPT-Neo 1.3B / 2.7B). A row of 96 bf16 is 192 bytes, one
// and a half 128-byte boxes: its tile is stored as two 64-column boxes (the
// layout, swizzle and descriptors of d = 128), the second box's columns
// 96-127 zero-filled by TMA's out-of-bounds fill (the tensor map's inner
// dimension is d, so nothing past column 96 is read from memory). Q.K^T
// reduces over the 6 k16 steps of the 96 columns only; P.V runs m64n64 on
// both boxes, and the accumulator's columns 96-127 (zeros) are not stored:
// a third of the second box's P.V products, 1/7 of the kernel's tensor-core
// work, is spent on the padding. Shared memory is d = 128's (128 KB).
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
      if (c * 64 + j * 8 >= D) continue;  // the zero-filled columns past d (d = 96)
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

}  // namespace

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, const void* kmask, void* o, void* lse,
                              int b, int T, int h, int d, int qsb, int qst, int qsh, int ksb, int kst, int ksh,
                              int vsb, int vst, int vsh, float scale, int window, int causal, int offset,
                              void* stream) {
  if (!flash_head_dim_ok(d)) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, d, T, h, b, qst, qsh, qsb, BQ) || !make_map(&tk, k, d, T, h, b, kst, ksh, ksb, BK) ||
      !make_map(&tv, v, d, T, h, b, vst, vsh, vsb, BK))
    return (int)cudaErrorInvalidValue;
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
