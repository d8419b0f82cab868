// The f32 GEMM mainloop of the fused-logprob kernels' f32-activation mode
// (rows 4f, 5f and 6f: the forward, ds, dx and dW products of ILQL's Q
// heads) for Hopper (sm_90a): f32-accurate products of f32 operands as three
// TF32 tensor-core passes (3xTF32), fed by TMA, computing 128 x 128 f32
// tiles of A . B and handing each finished tile to the caller's epilogue.
//
// The split: each f32 operand value v is cut into hi = rna_tf32(v) and
// lo = rna_tf32(v - hi) (v - hi is exact in f32), and
//   part += a_hi . b_hi + a_lo . b_hi + a_hi . b_lo
// in TF32 wgmma; the dropped a_lo . b_lo and the rounding of lo are ~2^-21
// of each product, against ~2^-11 for one TF32 pass, which the f32 mode's
// 1e-4 tolerance does not admit. The tensor core reads only the top 19 bits
// of an operand word, so both parts are formed explicitly.
//
// Promotion: the tensor core adds each k-step's products into its f32
// accumulator rounding toward zero, a bias that grows with the number of
// additions: summed over the Q heads' K = 8192 in one accumulator it breaks
// the 1e-4 tolerance (probe_f32_head.py builds the kernels with larger
// groups and measures it). So `part` sums one promotion group (TG_GROUP
// chunks, 24 wgmma a warpgroup) from zero, and is then added into the
// register accumulator `acc` by f32 adds that round to nearest.
//
// Layout (384 threads, one CTA per SM):
// - warpgroup 0 is the producer (setmaxnreg 24): one thread issues the TMA
//   boxes of every 32-wide reduction chunk into a TG_STAGES-deep ring of raw
//   f32 stages (an A box of 128 rows x 32 reduction columns, and the B tile:
//   one box of 128 rows when B is K-major, four boxes of 32 columns x 32
//   reduction rows when it is MN-major; 128-byte swizzle, 32 KB a stage),
//   guarded by a full and an empty mbarrier per stage, across tile
//   boundaries too.
// - warpgroups 1 and 2 consume (setmaxnreg 240), each accumulating 64 rows
//   of the tile (64 f32 registers a thread in `acc`, 64 more in the
//   promotion group's `part`: why the tile is 128 wide). Per chunk the 256 consumer
//   threads split the raw B tile into B_hi and B_lo, K-major (transposing an
//   MN-major tile on the way: TF32 wgmma has no transposed B), in one of
//   TG_SPLITS swizzled split buffers; each thread reads its A fragments from
//   the raw A box and splits them in registers; the raw stage is then freed
//   at once. After a proxy fence and a named barrier the warpgroup issues
//   wgmma m64n128k8 with A from registers: 4 k-steps x 3 passes, committed
//   as one batch and left in flight while the next chunk is split (wait_group
//   1). Two sets of A registers alternate by chunk, so the next chunk's
//   fragments never overwrite the ones a batch in flight still reads. A
//   promotion group is one chunk of each set: its first chunk, once split,
//   waits for the batches in flight and adds `part` into `acc` before
//   issuing its products, so only those 64 adds stall the tensor core.
//
// Why three split buffers and one barrier a chunk: chunk i's split writes
// buffer i % 3, which chunk i - 3 read. A warpgroup that passes chunk i - 1's
// barrier knows the other one finished chunk i - 2's wait_group 1, so chunk
// i - 3 is done in both.
//
// Shared memory: 3 raw stages of 32 KB, 3 split buffers of 32 KB (B_hi,
// B_lo: 128 rows x 128 bytes each), 48 bytes of mbarriers; the ds kernel
// adds 8 KB of column sums: 200 KB of the 227 KB a CTA may hold. Its
// traffic is what bounds the mainloop on an H100 (probe_f32_head.py: the
// split and the products take as long as their sum, not their maximum):
// per chunk wgmma reads 96 KB of B_hi and B_lo, TMA writes 32 KB, the A
// fragments read 16 KB, the split reads 16 and writes 32 KB.
//
// Past the matrices' edges TMA fills zeros, whose split is zero, so ragged
// rows, columns and reductions add nothing.

#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int TG_BM = 128;  // output rows per CTA: two consumer warpgroups of 64
constexpr int TG_BN = 128;  // output columns per tile: one wgmma N
constexpr int TG_BK = 32;   // reduction chunk: one 128-byte swizzle row of f32
constexpr int TG_STAGES = 3;
constexpr int TG_SPLITS = 3;
constexpr int TG_GROUP = 2;  // chunks a promotion group: 64 reductions, 24 wgmma
constexpr int TG_THREADS = 384;
constexpr int TG_NACC = TG_BN / 2;                 // f32 accumulators a consumer thread
constexpr int TG_A_BYTES = TG_BM * TG_BK * 4;      // 16 KB
constexpr int TG_B_BYTES = TG_BN * TG_BK * 4;      // 16 KB
constexpr int TG_MN_BOX = 32 * TG_BK * 4;          // one MN-major box of B, 4 KB
constexpr int TG_STAGE_BYTES = TG_A_BYTES + TG_B_BYTES;
constexpr int TG_RING_BYTES = TG_STAGES * TG_STAGE_BYTES;
constexpr int TG_SPLIT_BYTES = 2 * TG_B_BYTES;     // B_hi, then B_lo
constexpr int TG_BAR_OFFSET = TG_RING_BYTES + TG_SPLITS * TG_SPLIT_BYTES;
constexpr int TG_SMEM_BYTES = TG_BAR_OFFSET + 16 * TG_STAGES;  // stages, split buffers, full[] and empty[]
constexpr int TG_BAR_SPLIT = 2;  // named barrier of the split (id 1 is the ds kernel's column sums)

// Byte offset of element (r, c) of a [rows][32] f32 tile under the 128-byte
// swizzle TMA writes and the wgmma descriptor reads: the 16-byte chunk
// c / 4 of row r moves to c / 4 ^ (r % 8). The tile's base is 1024-aligned.
__device__ __forceinline__ int tg_swz(int r, int c) { return r * 128 + ((((c >> 2) ^ r) & 7) << 4) + ((c & 3) << 2); }

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// hi = rna_tf32(v), lo = rna_tf32(v - hi).
__device__ __forceinline__ void tf32_split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

__device__ __forceinline__ float4 tf32_hi4(const float4& v, float4& lo) {
  uint32_t h[4], l[4];
  tf32_split(v.x, h[0], l[0]);
  tf32_split(v.y, h[1], l[1]);
  tf32_split(v.z, h[2], l[2]);
  tf32_split(v.w, h[3], l[3]);
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]), __uint_as_float(l[3]));
  return make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]), __uint_as_float(h[3]));
}

struct TgRing {
  unsigned char* sm;  // generic pointer to stage 0, 1024-aligned
  uint32_t base;      // its shared address

  __device__ __forceinline__ int a_off(int s) const { return s * TG_STAGE_BYTES; }
  __device__ __forceinline__ int b_off(int s) const { return a_off(s) + TG_A_BYTES; }
  __device__ __forceinline__ int hi_off(int i) const { return TG_RING_BYTES + i * TG_SPLIT_BYTES; }
  __device__ __forceinline__ int lo_off(int i) const { return hi_off(i) + TG_B_BYTES; }
  __device__ __forceinline__ uint32_t full(int s) const { return base + TG_BAR_OFFSET + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return base + TG_BAR_OFFSET + 8 * (TG_STAGES + s); }

  // By one thread, before the CTA's first __syncthreads.
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < TG_STAGES; ++s) {
      mbar_init(full(s), 1);         // the producer's expect_tx
      mbar_init(empty(s), 2 * 128);  // every consumer thread
    }
    mbar_init_fence();
  }
};

// Reduction chunks of a reduction of length K, rounded up to whole
// promotion groups (a chunk past K is all zeros).
__host__ __device__ __forceinline__ int tg_chunks(int K) {
  return ((K + TG_BK * TG_GROUP - 1) / (TG_BK * TG_GROUP)) * TG_GROUP;
}

// Producer (one thread): every reduction chunk's A and B boxes of the
// output tile at (m0, n0). `ta` maps A as (reduction, row); `tb` maps B as
// (reduction, column) when B_KMAJOR, else as (column, reduction). `it`
// counts the chunks issued.
template <bool B_KMAJOR>
__device__ __forceinline__ void tg_produce_tile(const TgRing& r, const CUtensorMap* ta, const CUtensorMap* tb, int m0,
                                                int n0, int nk, uint32_t& it) {
  for (int kc = 0; kc < nk; ++kc, ++it) {
    const int s = it % TG_STAGES, k0 = kc * TG_BK;
    mbar_wait(r.empty(s), ((it / TG_STAGES) & 1) ^ 1);
    // Boxes that reach past an edge still count their full bytes.
    mbar_expect_tx(r.full(s), TG_STAGE_BYTES);
    tma_load_2d(r.base + r.a_off(s), ta, r.full(s), k0, m0);
    if (B_KMAJOR) {
      tma_load_2d(r.base + r.b_off(s), tb, r.full(s), k0, n0);
    } else {
#pragma unroll
      for (int j = 0; j < TG_BN / 32; ++j)
        tma_load_2d(r.base + r.b_off(s) + j * TG_MN_BOX, tb, r.full(s), n0 + 32 * j, k0);
    }
  }
}

// Producer (one thread): the output tiles n_lo .. n_hi - 1 of row block m0.
template <bool B_KMAJOR>
__device__ __forceinline__ void tg_produce(const TgRing& r, const CUtensorMap* ta, const CUtensorMap* tb, int m0,
                                           int n_lo, int n_hi, int nk) {
  uint32_t it = 0;
  for (int nt = n_lo; nt < n_hi; ++nt) tg_produce_tile<B_KMAJOR>(r, ta, tb, m0, nt * TG_BN, nk, it);
}

// Consumer thread ct (0..255): its share of the split of a raw B tile into
// B_hi and B_lo, both [128 output columns][32 reductions] swizzled (K-major).
// K-major raw tile: the same layout, float4 f = 256 i + ct, split in place
// of its offset. MN-major raw tile (four boxes [32 reductions][32 columns]):
// pair p = 256 i + ct is column n = p % 128 and reductions 4 (p / 128) .. +3,
// four scalar reads down one box (the 32 lanes of a warp read 32 columns of
// one row: distinct banks) and one float4 write of each part (the 8 lanes of
// a store phase write 8 rows: distinct 16-byte chunks).
template <bool B_KMAJOR>
__device__ __forceinline__ void tg_split_b(const unsigned char* raw, unsigned char* hi, unsigned char* lo, int ct) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = i * 256 + ct;
    float4 v;
    int dst;
    if (B_KMAJOR) {
      dst = p * 16;
      v = *reinterpret_cast<const float4*>(raw + dst);
    } else {
      const int n = p & (TG_BN - 1), kg = p / TG_BN;
      const unsigned char* box = raw + (n >> 5) * TG_MN_BOX;
      const float* e0 = reinterpret_cast<const float*>(box + tg_swz(4 * kg + 0, n & 31));
      const float* e1 = reinterpret_cast<const float*>(box + tg_swz(4 * kg + 1, n & 31));
      const float* e2 = reinterpret_cast<const float*>(box + tg_swz(4 * kg + 2, n & 31));
      const float* e3 = reinterpret_cast<const float*>(box + tg_swz(4 * kg + 3, n & 31));
      v = make_float4(*e0, *e1, *e2, *e3);
      dst = tg_swz(n, 4 * kg);
    }
    float4 l;
    const float4 h = tf32_hi4(v, l);
    *reinterpret_cast<float4*>(hi + dst) = h;
    *reinterpret_cast<float4*>(lo + dst) = l;
  }
}

// The thread's A fragments of one chunk, split: for k-step kk, ah[4 kk + e]
// and al[4 kk + e] hold A[r][c] with r = r0 + 8 (e & 1), c = 8 kk + t + 4
// (e >> 1) of the raw A box ([128 rows][32 reductions], swizzled); r0 = 64
// cw + 16 warp + g, so r % 8 = g (the 32 lanes of a read hit 32 banks).
__device__ __forceinline__ void tg_load_a(const unsigned char* a_box, int r0, int t, uint32_t (&ah)[16],
                                          uint32_t (&al)[16]) {
#pragma unroll
  for (int kk = 0; kk < TG_BK / 8; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = *reinterpret_cast<const float*>(a_box + tg_swz(r0 + 8 * (e & 1), 8 * kk + t + 4 * (e >> 1)));
      tf32_split(v, ah[4 * kk + e], al[4 * kk + e]);
    }
  }
}

// Consumer warpgroup cw, the it-th chunk it takes from the ring (the
// producer's order): split, free the raw stage, barrier, issue the 12
// products into `part` and leave them in flight, then wait until only this
// batch is. FIRST (the first chunk of a promotion group): before the
// products, wait for every batch in flight, add `part` into `acc` (f32,
// round to nearest) and restart `part` at zero.
template <bool B_KMAJOR, bool FIRST>
__device__ __forceinline__ void tg_chunk(const TgRing& r, float (&acc)[TG_NACC], float (&part)[TG_NACC],
                                         uint32_t (&ah)[16], uint32_t (&al)[16], int ct, int r0, int t,
                                         uint32_t it) {
  const int s = it % TG_STAGES, b = it % TG_SPLITS;
  mbar_wait(r.full(s), (it / TG_STAGES) & 1);
  tg_split_b<B_KMAJOR>(r.sm + r.b_off(s), r.sm + r.hi_off(b), r.sm + r.lo_off(b), ct);
  tg_load_a(r.sm + r.a_off(s), r0, t, ah, al);
  mbar_arrive(r.empty(s));
  fence_proxy_async();
  named_sync(TG_BAR_SPLIT, 256);
  if (FIRST) {
    wgmma_wait0();
    fence_regs<TG_NACC>(part);
#pragma unroll
    for (int i = 0; i < TG_NACC; ++i) acc[i] += part[i];
  }
  fence_regs<TG_NACC>(part);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < TG_BK / 8; ++kk) {
    // 8 reductions = 32 bytes along the 128-byte rows of B_hi and B_lo.
    const uint64_t dh = make_desc(r.base + r.hi_off(b) + kk * 32, 16, 1024);
    const uint64_t dl = make_desc(r.base + r.lo_off(b) + kk * 32, 16, 1024);
    wgmma_tf32_rs_n128(part, ah + 4 * kk, dh, !FIRST || kk > 0);
    wgmma_tf32_rs_n128(part, al + 4 * kk, dh, 1);
    wgmma_tf32_rs_n128(part, ah + 4 * kk, dl, 1);
  }
  wgmma_commit();
  wgmma_wait1();  // the previous chunk's batch is done: its A registers are free
  fence_regs<TG_NACC>(part);
}

// Consumer warpgroup cw (0 or 1), thread ct (0..255) of the consumers:
// acc = rows 64 cw .. 64 cw + 63 of the next tile, summed over its nk
// chunks (a multiple of TG_GROUP). `it` counts the chunks taken from the
// ring.
template <bool B_KMAJOR>
__device__ __forceinline__ void tg_tile(const TgRing& r, float (&acc)[TG_NACC], int cw, int ct, int nk,
                                        uint32_t& it) {
  const int warp = (ct / 32) & 3, lane = ct & 31;
  const int r0 = cw * 64 + warp * 16 + (lane >> 2), t = lane & 3;
  uint32_t ah0[16], al0[16], ah1[16], al1[16];
  float part[TG_NACC];
#pragma unroll
  for (int i = 0; i < TG_NACC; ++i) acc[i] = part[i] = 0.f;
  static_assert(TG_GROUP % 2 == 0, "a promotion group takes the two A register sets in turn");
  for (int kg = 0; kg < nk; kg += TG_GROUP) {
    tg_chunk<B_KMAJOR, true>(r, acc, part, ah0, al0, ct, r0, t, it++);
    tg_chunk<B_KMAJOR, false>(r, acc, part, ah1, al1, ct, r0, t, it++);
#pragma unroll 1
    for (int kc = 2; kc < TG_GROUP; kc += 2) {
      tg_chunk<B_KMAJOR, false>(r, acc, part, ah0, al0, ct, r0, t, it++);
      tg_chunk<B_KMAJOR, false>(r, acc, part, ah1, al1, ct, r0, t, it++);
    }
  }
  wgmma_wait0();
  fence_regs<TG_NACC>(part);
#pragma unroll
  for (int i = 0; i < TG_NACC; ++i) acc[i] += part[i];
}

}  // namespace
