// W8A16 product for Hopper: y = round_bf16(x . kq) * scale (+ bias), x bf16
// [M, K] (row-major), kq int8 [K, N] (row-major: the QDense kernel layout,
// per-output-channel symmetric codes), scale f32 [N], bias f32 [N] or none,
// y bf16 [M, N].
//
// Replaces no Pallas kernel: it is the port's counterpart of what XLA does to
// trlx_tpu/models/lm.py QDense with the `qw` collection, where the
// int8 -> bf16 convert is fused into the dot's operand load. Eager PyTorch
// has no such fusion: x @ kq.to(bf16) would write and read a bf16 copy of the
// weight on every call, three times the weight bytes of reading int8 once.
//
// What bounds it on an H100: decode (M = the live rows, 8-16) reads K * N
// int8 bytes for 2 * M * K * N flops, 2M flops a byte, far under the ~295 of
// the bf16 ridge: HBM bytes of the weight. Prefill (M = B * P, thousands) is
// above the ridge: tensor-core operations.
//
// Design: warp-specialised TMA + wgmma with the operands swapped. The kernels
// compute y^T = kq^T . x^T: the few or many x rows are wgmma's N (BX = 8,
// 32, 64, 128 or 256 a tile), and the weight is its A operand, converted
// into registers, so it is never written back to shared memory as bf16.
// - One thread of a producer warpgroup issues the TMA boxes of every 64-K
//   chunk into a ring of shared-memory stages (a full and an empty mbarrier
//   a stage): x, BX rows x 64 K of bf16, 128-byte swizzled, and an int8 box
//   of the tile's weight columns x 64 K rows (128 columns, 128-byte swizzle;
//   64 columns, 64-byte swizzle); loads run ahead across tile boundaries.
// - A swap-kernel consumer warpgroup owns a tile's 128 weight columns: two
//   m64 A tiles. Per 16-K step a thread reads four neighbouring columns of four K rows
//   (32-bit shared loads; row r's 16-byte chunk j sits at j ^ (r % 8), so
//   the 32 lanes of a load hit 32 banks) and builds its eight A registers
//   from them: fragment row g (g + 8) of warp w's A tile u is column 32 w +
//   4 g + 2 u (+ 1), so one load feeds both tiles and a thread's four sums
//   of an x row are neighbouring columns, stored 8 bytes at once. Of a
//   narrow tile of 64 columns (and of each of the wide kernel's warpgroups)
//   a warpgroup owns one A tile, a thread two columns, 16-bit loads (64-byte
//   rows: chunk j at j ^ (r / 2 % 4), again 32 banks a load).
//   Each weight byte of a stage is converted by one thread of the CTA, once. The
//   convert is exact and takes four operations for two codes: a byte
//   permutation puts them in the low bytes of the two halves of a word c;
//   with b = c & 0x7f | 0x4300 (the bf16 128 + low 7 bits) and s = c & 0x80
//   | 0x4300 (128, or 256 for a negative code), b - s in bf16x2 is their
//   value.
// - A register-A wgmma holds the issuing warps until the tensor core reads
//   their registers, so a convert overlaps only products already issued:
//   another warpgroup's, or the warpgroup's own batch before.
//
// - w8a16_wide_kernel, M > 64 with a tile for every SM (prefill, the
//   engine's prefill batches): tiles of 256 x rows x 128 columns on a
//   persistent grid of one CTA an SM, walked GROUP_ROWS row tiles at a time
//   so a wave shares a panel of x and a few weight panels in L2. Each of two
//   consumer warpgroups owns 64 columns, one m64 A tile whose products run
//   over all 256 x rows (wgmma N = 256), so a converted register feeds twice
//   the products it would at N = 128. The two warpgroups take turns at the
//   tensor core (two named barriers): one converts its next chunk while the
//   other's four products run, then issues its own and hands the turn over
//   (the other's queue behind them), and waits for them before it converts
//   again. (On an H100, 128 x 256 tiles with two A tiles a
//   warpgroup, a bf16 B tile in shared memory for wgmma with both operands
//   there, and warpgroups converting and issuing without turns were all
//   slower at the prefill shape.)
// - w8a16_swap_kernel, the rest (decode, verify windows, M > 64 with few
//   tiles): one column warpgroup. A warpgroup converts a chunk into one of
//   two register sets, issues its products (eight; four in a narrow tile) as
//   one batch and leaves it in flight while it converts the next chunk. For M <= 64
//   two consumer warpgroups take a tile's chunks in turn (K lanes; the
//   second adds its sums into the first's through shared memory, in that
//   order), and K is split over the `splits` CTAs of one thread-block
//   cluster. The tile width (128 or 64 columns) and the split are chosen so
//   that every cluster runs at once and the busiest SM streams the fewest
//   weight bytes (a shared-memory ring of ~128 KB keeps a second CTA off the
//   SM; an H100's GPCs hold 66 clusters of 2 but only 30 of 4, so 4096
//   columns take 64 narrow tiles split 2 ways, not 32 split 4). Each CTA
//   keeps its f32 partial tile in its shared memory; after a cluster
//   barrier, rank r sums its share of the tile's outputs over every rank's
//   partial in rank order, through distributed shared memory, and runs the
//   epilogue; a second barrier keeps every CTA alive until its partial has
//   been read. One launch, no global workspace,
//   nothing a replayed graph must reset.
//
// Rounding: the epilogue rounds the f32 sum to bf16, multiplies by the bf16
// scale and rounds, adds the bf16 bias and rounds, the order of QDense's
// dot(x, kq.astype(bf16)) * scale.astype(bf16) + bias.astype(bf16) and of
// w8a16_plain. Where it departs from it: the f32 sum runs in the tensor
// core's order (K lane by K lane, split by split, the parts added in a fixed
// order), not XLA's or the CPU's, so y may differ by an ulp where the sum
// rounds differently. Two calls give the same bits.
//
// Edges: TMA fills zeros past M, N and K (a zero code converts to 0.0), and
// rows past M and columns past N are not stored. The wrapper takes K % 8 ==
// 0 and N % 16 == 0 (16-byte rows, what TMA takes) and raises on other
// shapes.

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BK = 64;                // K a chunk: one 128-byte swizzle row of x
constexpr int WG_COLS = 128;          // weight columns of a wide tile (and of a swap-kernel warpgroup's two m64 tiles)
constexpr int NARROW_COLS = 64;       // weight columns of a narrow swap tile (one m64 tile a warpgroup)
constexpr int GROUP_ROWS = 12;        // row tiles a group of the tile walk
constexpr int MAX_SPLITS = 8;         // the portable cluster size
constexpr int PART_LD = WG_COLS + 4;  // f32 a row of a partial tile (padded by 16 bytes)
constexpr int BAR_LANE_SUMS = 1;      // named barriers: the K lanes' sum
constexpr int BAR_LANE_READ = 2;

struct Params {
  const float* scale;  // [N]
  const float* bias;   // [N] or null
  __nv_bfloat16* y;    // [M, N]
  int M, N, K, splits, row_tiles, col_tiles;
};

// Two codes in the low bytes of c's halves as two exact bf16.
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t c) {
  const uint32_t b = (c & 0x007F007Fu) | 0x43004300u, s = (c & 0x00800080u) | 0x43004300u;
  uint32_t v;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(v) : "r"(b), "r"(s));
  return v;
}

// Byte U of lo (low half) and of hi (high half) as two bf16.
template <int U>
__device__ __forceinline__ uint32_t i8_pair_bf16(uint32_t lo, uint32_t hi) {
  return codes_bf16x2(__byte_perm(lo, hi, U | (U << 4) | ((4 + U) << 8) | ((4 + U) << 12)));
}

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// QDense's epilogue on the f32 sums of C = 2 or 4 neighbouring columns n ..
// n + C - 1: bf16, times the bf16 scale, plus the bf16 bias.
template <int C>
__device__ __forceinline__ void finish(const float (&acc)[C], const Params& p, int n, __nv_bfloat16* dst) {
  __align__(8) __nv_bfloat16 y[C];
#pragma unroll
  for (int u = 0; u < C; ++u) {
    float v = round_bf16(round_bf16(acc[u]) * round_bf16(p.scale[n + u]));
    if (p.bias != nullptr) v = v + round_bf16(p.bias[n + u]);
    y[u] = __float2bfloat16_rn(v);
  }
  if constexpr (C == 4) {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(y);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(y);
  }
}

// C = 2 or 4 f32 at `dst` (8- or 16-byte aligned shared memory), and back.
template <int C>
__device__ __forceinline__ void store_cols(float* dst, const float (&v)[C]) {
  if constexpr (C == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  }
}

template <int C>
__device__ __forceinline__ void load_cols(const float* src, float (&v)[C]) {
  if constexpr (C == 4) {
    const float4 f = *reinterpret_cast<const float4*>(src);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
    const float2 f = *reinterpret_cast<const float2*>(src);
    v[0] = f.x, v[1] = f.y;
  }
}

// The dynamic shared-memory base rounded up to 1024 bytes by pointer
// arithmetic on `raw`, so the compiler keeps it a shared-space pointer and
// the accesses through it compile to shared loads and stores (a pointer
// rebuilt from an integer would be a generic one).
__device__ __forceinline__ unsigned char* shared_1024(unsigned char* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

// Tile `tile` of the walk: GROUP_ROWS row tiles at a time, row tiles fastest
// within a group, so the CTAs of a wave share a panel of x rows and a few
// weight panels in L2.
__device__ __forceinline__ void tile_at(int tile, int row_tiles, int col_tiles, int& rt, int& ct) {
  const int per_group = GROUP_ROWS * col_tiles;
  const int grp = tile / per_group, r = tile - grp * per_group;
  const int rows = min(GROUP_ROWS, row_tiles - grp * GROUP_ROWS);
  rt = grp * GROUP_ROWS + r % rows;
  ct = r / rows;
}

// The ring: STAGES stages of an x box (BX rows, its slot rounded up to 1024
// bytes) and an int8 box of WC weight columns x BK K rows (128-byte swizzle
// at WC = 128, 64-byte at WC = 64), then full[STAGES] and empty[STAGES].
template <int BX, int WC, int STAGES_>
struct Ring {
  static constexpr int STAGES = STAGES_;
  static constexpr int X_BOX = BX * BK * 2;
  static constexpr int X_SLOT = (X_BOX + 1023) / 1024 * 1024;
  static constexpr int W_BOX = WC * BK;
  static constexpr int STAGE = X_SLOT + W_BOX;
  static constexpr int TX = X_BOX + W_BOX;  // bytes a stage's boxes bring
  static constexpr int BYTES = STAGES * STAGE;
  static constexpr int BAR_BYTES = 16 * STAGES;
  static_assert(STAGE % 1024 == 0, "stages keep the boxes 1024-byte aligned");

  uint32_t base;  // shared address of stage 0, 1024-aligned
  __device__ __forceinline__ uint32_t x(int s) const { return base + s * STAGE; }
  __device__ __forceinline__ uint32_t w(int s) const { return x(s) + X_SLOT; }
  __device__ __forceinline__ uint32_t full(int s) const { return base + BYTES + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return base + BYTES + 8 * (STAGES + s); }

  // By one thread, before the CTA's first __syncthreads.
  __device__ __forceinline__ void init(int consumers) const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);  // the producer's expect_tx
      mbar_init(empty(s), consumers);
    }
    mbar_init_fence();
  }

  // Producer (one thread): the chunks [kc0, kc1) of each tile of the walk
  // blockIdx.x, + gridDim.x, ...; column tile ct's int8 box starts at
  // column ct * WC.
  __device__ __forceinline__ void produce(const CUtensorMap* tx, const CUtensorMap* tw, const Params& p, int kc0,
                                          int kc1) const {
    uint32_t it = 0;
    for (int tile = blockIdx.x; tile < p.row_tiles * p.col_tiles; tile += gridDim.x) {
      int rt, ct;
      tile_at(tile, p.row_tiles, p.col_tiles, rt, ct);
      for (int kc = kc0; kc < kc1; ++kc, ++it) {
        const int s = it % STAGES;
        mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
        // Boxes that reach past an edge still count their full bytes.
        mbar_expect_tx(full(s), TX);
        tma_load_2d(x(s), tx, full(s), kc * BK, rt * BX);
        tma_load_2d(w(s), tw, full(s), ct * WC, kc * BK);
      }
    }
  }
};

// The thread's A registers of k-step kk from an int8 box of PITCH-byte rows
// ([64 K rows][PITCH columns], swizzled: row r's 16-byte chunk j sits at j ^
// (r % 8) in 128-byte rows, at j ^ (r / 2 % 4) in 64-byte rows): a[u] holds
// fragment rows g and g + 8 of A tile u (columns c0 + 2u and c0 + 2u + 1) at
// K 16 kk + 2t, + 1 (registers 0, 1) and + 8, + 9 (registers 2, 3). One load
// of 2 NA neighbouring columns a K row.
template <int NA, int PITCH>
__device__ __forceinline__ void load_a(const unsigned char* box, int kk, int c0, int t, uint32_t (&a)[NA][4]) {
  static_assert((NA == 1 || NA == 2) && (PITCH == 64 || PITCH == 128), "load_a: one or two A tiles");
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 16 * kk + 2 * t + (i & 1) + 8 * (i >> 1);
    const int sw = PITCH == 128 ? r : r >> 1;
    const unsigned char* src = box + r * PITCH + ((((c0 >> 4) ^ sw) & (PITCH / 16 - 1)) << 4) + (c0 & 15);
    w[i] = NA == 2 ? *reinterpret_cast<const uint32_t*>(src) : *reinterpret_cast<const uint16_t*>(src);
  }
  a[0][0] = i8_pair_bf16<0>(w[0], w[1]);
  a[0][1] = i8_pair_bf16<1>(w[0], w[1]);
  a[0][2] = i8_pair_bf16<0>(w[2], w[3]);
  a[0][3] = i8_pair_bf16<1>(w[2], w[3]);
  if constexpr (NA == 2) {
    a[1][0] = i8_pair_bf16<2>(w[0], w[1]);
    a[1][1] = i8_pair_bf16<3>(w[0], w[1]);
    a[1][2] = i8_pair_bf16<2>(w[2], w[3]);
    a[1][3] = i8_pair_bf16<3>(w[2], w[3]);
  }
}

// The 2 NA sums of x row 8 j + 2 t + q, columns c0 .. c0 + 2 NA - 1:
// accumulator 4 j + e of A tile u is x row 8 j + 2 t + (e & 1), column c0 +
// 2 u + (e >> 1).
template <int NA, int NACC>
__device__ __forceinline__ void row_sums(const float (&acc)[NA][NACC], int j, int q, float (&v)[2 * NA]) {
#pragma unroll
  for (int u = 0; u < NA; ++u) {
    v[2 * u] = acc[u][4 * j + q];
    v[2 * u + 1] = acc[u][4 * j + 2 + q];
  }
}

// ---------------------------------------------------------------------------
// w8a16_swap_kernel: y^T = kq^T . x^T, the weight in registers.
// ---------------------------------------------------------------------------

// BX x rows a tile; KWG K lanes (consumer warpgroups that take the tile's
// chunks in turn); WC weight columns a tile, NA = WC / 64 m64 A tiles a
// warpgroup.
template <int BX, int KWG, int WC>
struct Swap {
  static constexpr int THREADS = 128 * KWG + 128;  // then the producer warpgroup
  static constexpr int NA = WC / 64;
  // BX = 128: 6 stages. Smaller: a ring of ~128 KB, which also keeps a
  // second CTA off the SM.
  using R = Ring<BX, WC, BX == 128 ? 6 : 131072 / (BX * BK * 2 + WC * BK)>;
  static constexpr int PART = R::BYTES + R::BAR_BYTES;  // a partial tile [BX][PART_LD] f32 (K lanes, splits)
  static constexpr int SMEM = PART + BX * PART_LD * 4 + 1024;  // room to align the base to 1024
  static constexpr int NACC = BX / 2;                   // f32 accumulators a thread, per A tile
  static_assert(SMEM <= 232448, "swap kernel shared memory");
};

// A consumer warpgroup's chunk at ring position `it`: convert its A
// registers (set a), issue its products as one batch and leave it in flight
// while the next chunk converts into the other set; once the batch before is
// done, free the previous chunk's stage (`prev`).
template <int BX, int KWG, int WC>
__device__ __forceinline__ void swap_chunk(const unsigned char* sm, const typename Swap<BX, KWG, WC>::R& ring,
                                           float (&acc)[WC / 64][BX / 2], uint32_t (&a)[BK / 16][WC / 64][4],
                                           uint32_t it, int c0, int t, int& prev) {
  using C = Swap<BX, KWG, WC>;
  const int s = it % C::R::STAGES;
  mbar_wait(ring.full(s), (it / C::R::STAGES) & 1);
  const unsigned char* box = sm + (ring.w(s) - ring.base);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) load_a<C::NA, WC>(box, kk, c0, t, a[kk]);
#pragma unroll
  for (int u = 0; u < C::NA; ++u) fence_regs<C::NACC>(acc[u]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    // 16 K = 32 bytes along the 128-byte rows of the x box.
    const uint64_t db = make_desc(ring.x(s) + kk * 32, 16, 1024);
#pragma unroll
    for (int u = 0; u < C::NA; ++u) wgmma_rs_kb<BX>(acc[u], a[kk][u], db);
  }
  wgmma_commit();
  wgmma_wait1();
#pragma unroll
  for (int u = 0; u < C::NA; ++u) fence_regs<C::NACC>(acc[u]);
  if (prev >= 0) mbar_arrive(ring.empty(prev));
  prev = s;
}

// A consumer warpgroup's sums of one tile over `n` chunks of the ring,
// chunk i at ring position it0 + i * KWG; the two register sets alternate by
// chunk.
template <int BX, int KWG, int WC>
__device__ __forceinline__ void swap_tile(const unsigned char* sm, const typename Swap<BX, KWG, WC>::R& ring,
                                          float (&acc)[WC / 64][BX / 2], int n, uint32_t it0, int c0, int t) {
  using C = Swap<BX, KWG, WC>;
  uint32_t a[2][BK / 16][C::NA][4];
#pragma unroll
  for (int u = 0; u < C::NA; ++u)
#pragma unroll
    for (int i = 0; i < C::NACC; ++i) acc[u][i] = 0.f;
  int prev = -1, i = 0;
  for (; i + 1 < n; i += 2) {
    swap_chunk<BX, KWG, WC>(sm, ring, acc, a[0], it0 + i * KWG, c0, t, prev);
    swap_chunk<BX, KWG, WC>(sm, ring, acc, a[1], it0 + (i + 1) * KWG, c0, t, prev);
  }
  if (i < n) swap_chunk<BX, KWG, WC>(sm, ring, acc, a[0], it0 + i * KWG, c0, t, prev);
  wgmma_wait0();
#pragma unroll
  for (int u = 0; u < C::NA; ++u) fence_regs<C::NACC>(acc[u]);
  if (prev >= 0) mbar_arrive(ring.empty(prev));
}

template <int BX, int KWG, int WC>
__global__ void __launch_bounds__(Swap<BX, KWG, WC>::THREADS, 1)
    w8a16_swap_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw, Params p) {
  using C = Swap<BX, KWG, WC>;
  constexpr int NA = C::NA;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = shared_1024(smem_raw);
  const typename C::R ring{smem_u32(sm)};
  float* part = reinterpret_cast<float*>(sm + C::PART);
  const int tiles = p.row_tiles * p.col_tiles;
  const int kchunks = (p.K + BK - 1) / BK;
  // This CTA's K range: chunks [kc0, kc1) of split blockIdx.y (its cluster rank).
  const int kc0 = blockIdx.y * kchunks / p.splits, kc1 = (blockIdx.y + 1) * kchunks / p.splits;
  const int nk = kc1 - kc0;
  const int wg = threadIdx.x / 128, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) ring.init(128);  // each chunk's K lane
  __syncthreads();

  if (wg == KWG) {
    // ---- producer ----
    if (threadIdx.x == 128 * KWG) ring.produce(&tx, &tw, p, kc0, kc1);
    __syncwarp();
  } else {
    // ---- consumers ----
    const int kw = wg, g = lane >> 2, t = lane & 3;
    const int c0 = WC / 4 * ((threadIdx.x / 32) & 3) + 2 * NA * g;  // the thread's first column of the tile's WC
    float acc[NA][C::NACC];
    float v[2 * NA];
    uint32_t it0 = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, it0 += nk) {
      int rt, ct;
      tile_at(tile, p.row_tiles, p.col_tiles, rt, ct);
      swap_tile<BX, KWG, WC>(sm, ring, acc, (nk - kw + KWG - 1) / KWG, it0 + kw, c0, t);
      if constexpr (KWG == 2) {
        // K lane 1's sums added into lane 0's, in that order.
        if (kw == 1) {
#pragma unroll
          for (int j = 0; j < BX / 8; ++j)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              row_sums(acc, j, q, v);
              store_cols(part + (8 * j + 2 * t + q) * PART_LD + c0, v);
            }
        }
        named_sync(BAR_LANE_SUMS, 256);
        if (kw == 0) {
#pragma unroll
          for (int j = 0; j < BX / 8; ++j)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              load_cols(part + (8 * j + 2 * t + q) * PART_LD + c0, v);
#pragma unroll
              for (int u = 0; u < NA; ++u) {
                acc[u][4 * j + q] += v[2 * u];
                acc[u][4 * j + 2 + q] += v[2 * u + 1];
              }
            }
        }
        named_sync(BAR_LANE_READ, 256);
        if (kw == 1) continue;
      }
      const int n = ct * WC + c0;
      if (p.splits == 1) {
        if (n < p.N) {
#pragma unroll
          for (int j = 0; j < BX / 8; ++j)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int m = rt * BX + 8 * j + 2 * t + q;
              if (m >= p.M) continue;
              row_sums(acc, j, q, v);
              finish(v, p, n, p.y + (size_t)m * p.N + n);
            }
        }
      } else {
#pragma unroll
        for (int j = 0; j < BX / 8; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            row_sums(acc, j, q, v);
            store_cols(part + (8 * j + 2 * t + q) * PART_LD + c0, v);
          }
      }
    }
  }

  if (p.splits > 1) {
    // One tile a CTA (the grid is tiles x splits, one cluster a tile).
    cluster_sync();  // every rank's partial is in its shared memory
    if (wg < KWG) {
      int rt, ct;
      tile_at(blockIdx.x, p.row_tiles, p.col_tiles, rt, ct);
      // Rank r finishes quads [r U / splits, (r + 1) U / splits) of the
      // tile's U = BX x WC / 4 quads of four columns.
      constexpr int QUADS = BX * WC / 4;
      const int q1 = (blockIdx.y + 1) * QUADS / p.splits;
      for (int qd = blockIdx.y * QUADS / p.splits + threadIdx.x; qd < q1; qd += 128 * KWG) {
        const int row = qd / (WC / 4), col = (qd % (WC / 4)) * 4;
        const int m = rt * BX + row, n = ct * WC + col;
        if (m >= p.M || n >= p.N) continue;
        const uint32_t addr = ring.base + C::PART + (row * PART_LD + col) * 4;
        float4 pr[MAX_SPLITS];
#pragma unroll
        for (int r = 0; r < MAX_SPLITS; ++r)
          if (r < p.splits) pr[r] = dsmem_ld4(addr, r);
        float sum[4] = {pr[0].x, pr[0].y, pr[0].z, pr[0].w};
#pragma unroll
        for (int r = 1; r < MAX_SPLITS; ++r)
          if (r < p.splits) {
            sum[0] += pr[r].x;
            sum[1] += pr[r].y;
            sum[2] += pr[r].z;
            sum[3] += pr[r].w;
          }
        finish(sum, p, n, p.y + (size_t)m * p.N + n);
      }
    }
    cluster_sync();  // no CTA leaves while its partial is read
  }
}

// ---------------------------------------------------------------------------
// w8a16_wide_kernel: 256 x rows x 128 columns a tile, two warpgroups of 64
// columns (one m64 A tile each, wgmma N = 256) taking turns at the tensor core.
// ---------------------------------------------------------------------------

constexpr int WIDE_BX = 256, WIDE_STAGES = 5;
constexpr int BAR_TURN = 4;  // named barriers 4 and 5: warpgroup 0's and 1's turn
using WideRing = Ring<WIDE_BX, WG_COLS, WIDE_STAGES>;
constexpr int WIDE_SMEM = WideRing::BYTES + WideRing::BAR_BYTES + 1024;  // room to align the base to 1024
static_assert(WIDE_SMEM <= 232448, "wide kernel shared memory");

__global__ void __launch_bounds__(384, 1)
    w8a16_wide_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw, Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = shared_1024(smem_raw);
  const WideRing ring{smem_u32(sm)};
  const int nk = (p.K + BK - 1) / BK;
  const int wg = threadIdx.x / 128, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) ring.init(256);
  __syncthreads();

  if (wg == 2) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) ring.produce(&tx, &tw, p, 0, nk);
    return;
  }

  // ---- consumers: warpgroup wg, columns 64 wg .. + 63 of the tile ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int g = lane >> 2, t = lane & 3;
  const int c0 = 64 * wg + 16 * ((threadIdx.x / 32) & 3) + 2 * g;
  float acc[WIDE_BX / 2];
  uint32_t a[BK / 16][1][4];  // one A tile: columns c0 and c0 + 1 of rows g and g + 8
  if (wg == 1) named_arrive(BAR_TURN, 256);  // warpgroup 0 takes the first turn
  uint32_t it = 0;
  for (int tile = blockIdx.x; tile < p.row_tiles * p.col_tiles; tile += gridDim.x) {
    int rt, ct;
    tile_at(tile, p.row_tiles, p.col_tiles, rt, ct);
#pragma unroll
    for (int i = 0; i < WIDE_BX / 2; ++i) acc[i] = 0.f;
    for (int kc = 0; kc < nk; ++kc, ++it) {
      const int s = it % WIDE_STAGES;
      mbar_wait(ring.full(s), (it / WIDE_STAGES) & 1);
      // Convert the chunk while the other warpgroup's products run, then
      // take the turn: issue, hand the turn over, wait for them.
      const unsigned char* box = sm + (ring.w(s) - ring.base);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) load_a<1, WG_COLS>(box, kk, c0, t, a[kk]);
      named_sync(BAR_TURN + wg, 256);
      fence_regs<WIDE_BX / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs_kb<WIDE_BX>(acc, a[kk][0], make_desc(ring.x(s) + kk * 32, 16, 1024));
      wgmma_commit();
      named_arrive(BAR_TURN + (wg ^ 1), 256);  // its products queue behind these
      wgmma_wait0();  // before the registers are converted again
      fence_regs<WIDE_BX / 2>(acc);
      mbar_arrive(ring.empty(s));
    }
    // Accumulator 4 j + e: x row 8 j + 2 t + (e & 1), column c0 + (e >> 1).
    const int n = ct * WG_COLS + c0;
    if (n < p.N) {
#pragma unroll
      for (int j = 0; j < WIDE_BX / 8; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int m = rt * WIDE_BX + 8 * j + 2 * t + q;
          const float v[2] = {acc[4 * j + q], acc[4 * j + 2 + q]};
          if (m < p.M) finish(v, p, n, p.y + (size_t)m * p.N + n);
        }
    }
  }
  if (wg == 0) named_sync(BAR_TURN, 256);  // warpgroup 1's last hand-over
}

// ---------------------------------------------------------------------------
// Launches.
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaLaunchConfig_t config(Kernel, const Params& p, int grid, int threads, int smem, cudaStream_t stream,
                          cudaLaunchAttribute* cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, p.splits, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = p.splits;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = p.splits > 1 ? 1 : 0;
  return cfg;
}

template <typename Kernel>
int start(Kernel kernel, const CUtensorMap& tx, const CUtensorMap& tw, const Params& p, int grid, int threads,
          int smem, cudaStream_t stream) {
  cudaLaunchAttribute cluster[1];
  const cudaLaunchConfig_t cfg = config(kernel, p, grid, threads, smem, stream, cluster);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, tx, tw, p);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <int BX, int KWG, int WC>
cudaError_t prepare_swap() {
  static const cudaError_t attr = cudaFuncSetAttribute(w8a16_swap_kernel<BX, KWG, WC>,
                                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                       Swap<BX, KWG, WC>::SMEM);  // once a process
  return attr;
}

template <int BX, int KWG, int WC>
int launch_swap(const CUtensorMap& tx, const CUtensorMap& tw, const Params& p, int grid, cudaStream_t stream) {
  using C = Swap<BX, KWG, WC>;
  const cudaError_t err = prepare_swap<BX, KWG, WC>();
  if (err != cudaSuccess) return (int)err;
  return start(w8a16_swap_kernel<BX, KWG, WC>, tx, tw, p, grid, C::THREADS, C::SMEM, stream);
}

int launch_wide(const CUtensorMap& tx, const CUtensorMap& tw, const Params& p, int grid, cudaStream_t stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(w8a16_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WIDE_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  return start(w8a16_wide_kernel, tx, tw, p, grid, 384, WIDE_SMEM, stream);
}

// Clusters of `splits` CTAs of the tiling that run at once, or -1.
template <int BX, int KWG, int WC>
int max_clusters(int splits) {
  using C = Swap<BX, KWG, WC>;
  if (prepare_swap<BX, KWG, WC>() != cudaSuccess) return -1;
  Params p{};
  p.splits = splits;
  cudaLaunchAttribute cluster[1];
  cudaLaunchConfig_t cfg = config(w8a16_swap_kernel<BX, KWG, WC>, p, 1, C::THREADS, C::SMEM, nullptr, cluster);
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, w8a16_swap_kernel<BX, KWG, WC>, &cfg) == cudaSuccess ? n : -1;
}

}  // namespace

// bx: x rows a tile (8, 32, 64 or 128; 256 for the wide kernel); cols:
// weight columns a tile (128; 64 for the swap kernel at bx <= 64); wgs: 2
// for the wide kernel (unsplit), else 1 for the swap kernel (two K lanes at
// bx <= 64); splits: CTAs of a cluster splitting K (1 to 8); grid: CTAs
// along the tiles (persistent when splits == 1: each walks the tiles
// blockIdx.x, + grid, ...; one tile a cluster otherwise).
extern "C" int w8a16_gemm(const void* x, const void* kq, const void* scale, const void* bias, void* y, int M, int N,
                          int K, int bx, int cols, int wgs, int splits, int grid, void* stream) {
  const bool shape_ok = M >= 1 && N >= 16 && N % 16 == 0 && K >= 8 && K % 8 == 0 && grid >= 1;
  const bool narrow = cols == NARROW_COLS && (bx == 8 || bx == 32 || bx == 64);
  const bool tiling_ok = (wgs == 1 && (bx == 8 || bx == 32 || bx == 64 || bx == 128) && (cols == WG_COLS || narrow)) ||
                         (wgs == 2 && bx == WIDE_BX && cols == WG_COLS && splits == 1);
  if (!shape_ok || !tiling_ok || splits < 1 || splits > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  const bool mapped = make_map_2d<2>(&tx, x, K, M, K, bx) &&
                      (narrow ? make_map_2d<1, NARROW_COLS>(&tw, kq, N, K, N, BK) : make_map_2d<1>(&tw, kq, N, K, N, BK));
  if (!mapped) return (int)cudaErrorInvalidValue;
  Params p{static_cast<const float*>(scale), static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y),
           M, N, K, splits, (M + bx - 1) / bx, (N + cols - 1) / cols};
  const int tiles = p.row_tiles * p.col_tiles;
  if (splits > 1 ? grid != tiles : grid > tiles) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wgs == 2) return launch_wide(tx, tw, p, grid, s);
  if (narrow) {
    switch (bx) {
      case 8: return launch_swap<8, 2, NARROW_COLS>(tx, tw, p, grid, s);
      case 32: return launch_swap<32, 2, NARROW_COLS>(tx, tw, p, grid, s);
      default: return launch_swap<64, 2, NARROW_COLS>(tx, tw, p, grid, s);
    }
  }
  switch (bx) {
    case 8: return launch_swap<8, 2, WG_COLS>(tx, tw, p, grid, s);
    case 32: return launch_swap<32, 2, WG_COLS>(tx, tw, p, grid, s);
    case 64: return launch_swap<64, 2, WG_COLS>(tx, tw, p, grid, s);
    default: return launch_swap<128, 1, WG_COLS>(tx, tw, p, grid, s);
  }
}

// The most clusters of `splits` CTAs of the swap kernel with x tiles of `bx`
// rows and tiles of `cols` weight columns that the device runs at once (what
// plan() may give a K-split launch), or -1.
extern "C" int w8a16_max_clusters(int bx, int cols, int splits) {
  if (splits < 1 || splits > MAX_SPLITS) return -1;
  if (cols == NARROW_COLS) {
    switch (bx) {
      case 8: return max_clusters<8, 2, NARROW_COLS>(splits);
      case 32: return max_clusters<32, 2, NARROW_COLS>(splits);
      case 64: return max_clusters<64, 2, NARROW_COLS>(splits);
      default: return -1;
    }
  }
  if (cols != WG_COLS) return -1;
  switch (bx) {
    case 8: return max_clusters<8, 2, WG_COLS>(splits);
    case 32: return max_clusters<32, 2, WG_COLS>(splits);
    case 64: return max_clusters<64, 2, WG_COLS>(splits);
    case 128: return max_clusters<128, 1, WG_COLS>(splits);
    default: return -1;
  }
}
