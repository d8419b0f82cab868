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
// Design. A CTA computes a BM x BN (BN = 128) tile of y over a K range in
// BK = 64 chunks, staged through a STAGES-deep ring of shared memory filled
// by cp.async, 16 bytes a thread, coalesced (rows of x along K, rows of kq
// along N). Four warps along N take 32 columns each (and WARPS_M warps along
// M take BM / WARPS_M rows); a warp multiplies with mma.sync m16n8k16 (bf16
// in, f32 accumulate), A fragments by ldmatrix, B fragments converted in
// registers from the int8 bytes: ^0x80 puts a byte in the mantissa of 2^23,
// subtracting 2^23 + 128 gives the value in f32 exactly, and the high half
// of that f32 is the value in bf16 exactly (|v| <= 127). The warp's four
// m16n8 tiles interleave their columns (tile u, fragment column j is the
// physical column 4j + u of the warp's 32), so one 32-bit shared load of
// four neighbouring columns feeds all four tiles, and a thread's outputs
// lie in runs of four columns, stored 8 bytes at a time. Shared rows are
// padded by 16 bytes: the ldmatrix rows and the B words of one load hit 32
// distinct banks.
//
// Two tilings, chosen by the wrapper from M (ops/w8a16.py plan()): BM = 16
// with four warps for decode, BM = 128 with eight warps (two along M, 64
// rows a warp) otherwise. For small M, N = 4096 gives only 32 column tiles
// for 132 SMs: the wrapper splits K (grid z) so that enough CTAs stream the
// weight, each split writing its f32 partial tile to a scratch [splits, M,
// N] that a second kernel sums in split order and finishes.
//
// Rounding: the epilogue rounds the f32 sum to bf16, multiplies by the bf16
// scale and rounds, adds the bf16 bias and rounds, the order of QDense's
// dot(x, kq.astype(bf16)) * scale.astype(bf16) + bias.astype(bf16) and of
// w8a16_plain. Where it departs from it: the f32 sum runs in the tensor
// core's order (and split by split when K is split), not XLA's or the CPU's,
// so y may differ by an ulp where the sum rounds differently.
//
// Edges: rows past M and columns past N are zero-filled on load (cp.async
// with a source size of 0) and not stored; K past its end likewise. The
// wrapper takes K % 8 == 0 and N % 16 == 0 (16-byte rows) and raises on
// other shapes.

#include "common.cuh"

namespace {

constexpr int BN = 128;                  // output columns a CTA
constexpr int BK = 64;                   // K a stage
constexpr int STAGES = 4;                // cp.async ring depth
constexpr int WARPS_N = BN / 32;         // warps along N, 32 columns each
constexpr int A_ROW = BK * 2 + 16;       // bytes of a shared x row (padded)
constexpr int B_ROW = BN + 16;           // bytes of a shared kq row (padded)
constexpr int B_STAGE = BK * B_ROW;

template <int BM, int WARPS_M>
struct Tiling {
  static constexpr int THREADS = WARPS_M * WARPS_N * 32;
  static constexpr int MT = BM / WARPS_M / 16;  // m16 tiles a warp
  static constexpr int A_STAGE = BM * A_ROW;
  static constexpr int SMEM = STAGES * (A_STAGE + B_STAGE);
  static_assert(MT >= 1 && MT * 16 * WARPS_M == BM, "warp rows");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int size = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(size));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// Byte U of lo and of hi (each already ^0x80) as two bf16 in one register,
// lo in the low half.
template <int U>
__device__ __forceinline__ uint32_t i8_pair_bf16(uint32_t lo, uint32_t hi) {
  const float a = __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7650u + U)) - 8388736.f;
  const float b = __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7650u + U)) - 8388736.f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632u);
}

// QDense's epilogue on four f32 sums: bf16, * bf16 scale, + bf16 bias.
__device__ __forceinline__ void finish4(const float* acc, const float* scale, const float* bias, int col,
                                        __nv_bfloat16* dst) {
  __align__(8) __nv_bfloat16 y[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    float v = __bfloat162float(__float2bfloat16_rn(acc[u]));
    v = __bfloat162float(__float2bfloat16_rn(v * __bfloat162float(__float2bfloat16_rn(scale[col + u]))));
    if (bias != nullptr) v = v + __bfloat162float(__float2bfloat16_rn(bias[col + u]));
    y[u] = __float2bfloat16_rn(v);
  }
  *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(y);
}

struct Params {
  const __nv_bfloat16* x;  // [M, K]
  const int8_t* kq;        // [K, N]
  const float* scale;      // [N]
  const float* bias;       // [N] or null
  __nv_bfloat16* y;        // [M, N]
  float* ws;               // [splits, M, N] f32 partials when splits > 1
  int M, N, K, splits, per;  // per: BK chunks of K a split
};

template <int BM, int WARPS_M>
__global__ void __launch_bounds__(Tiling<BM, WARPS_M>::THREADS, BM > 16 ? 2 : 1)
    w8a16_gemm_kernel(Params p) {
  using T = Tiling<BM, WARPS_M>;
  constexpr int MT = T::MT;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sa = smem;                          // STAGES x [BM][A_ROW]
  uint8_t* sb = smem + STAGES * T::A_STAGE;    // STAGES x [BK][B_ROW]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int warp_n = warp % WARPS_N, warp_m = warp / WARPS_N;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kchunks = (p.K + BK - 1) / BK;
  const int kc0 = blockIdx.z * p.per;
  const int n_iter = min(kchunks, kc0 + p.per) - kc0;

  auto load = [&](int stage, int kc) {
    const int k0 = kc * BK;
    uint8_t* a = sa + stage * T::A_STAGE;
    for (int c = tid; c < BM * (BK / 8); c += T::THREADS) {
      const int row = c / (BK / 8), col8 = c % (BK / 8);
      const int m = m0 + row, k = k0 + col8 * 8;
      const bool ok = m < p.M && k < p.K;
      cp_async16(a + row * A_ROW + col8 * 16, ok ? p.x + (size_t)m * p.K + k : p.x, ok);
    }
    uint8_t* b = sb + stage * B_STAGE;
    for (int c = tid; c < BK * (BN / 16); c += T::THREADS) {
      const int row = c / (BN / 16), col16 = c % (BN / 16);
      const int k = k0 + row, n = n0 + col16 * 16;
      const bool ok = k < p.K && n < p.N;
      cp_async16(b + row * B_ROW + col16 * 16, ok ? p.kq + (size_t)k * p.N + n : p.kq, ok);
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][u][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_iter) load(s, kc0 + s);
    cp_async_commit();
  }

  const int a_row = warp_m * (MT * 16) + (lane & 15);
  const int a_col = (lane >> 4) * 16;  // bytes: k 0-7 or 8-15 of a k16 step
  const int b_col = warp_n * 32 + 4 * g;
  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = it + STAGES - 1;
    if (nxt < n_iter) load(nxt % STAGES, kc0 + nxt);
    cp_async_commit();

    const uint8_t* a = sa + (it % STAGES) * T::A_STAGE;
    const uint8_t* b = sb + (it % STAGES) * B_STAGE;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) ldmatrix_x4(af[i], a + (a_row + i * 16) * A_ROW + ks * 32 + a_col);
      const uint8_t* brow = b + (ks * 16 + 2 * t) * B_ROW + b_col;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(brow) ^ 0x80808080u;
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(brow + B_ROW) ^ 0x80808080u;
      const uint32_t w8 = *reinterpret_cast<const uint32_t*>(brow + 8 * B_ROW) ^ 0x80808080u;
      const uint32_t w9 = *reinterpret_cast<const uint32_t*>(brow + 9 * B_ROW) ^ 0x80808080u;
      uint32_t bf[4][2];
      bf[0][0] = i8_pair_bf16<0>(w0, w1); bf[0][1] = i8_pair_bf16<0>(w8, w9);
      bf[1][0] = i8_pair_bf16<1>(w0, w1); bf[1][1] = i8_pair_bf16<1>(w8, w9);
      bf[2][0] = i8_pair_bf16<2>(w0, w1); bf[2][1] = i8_pair_bf16<2>(w8, w9);
      bf[3][0] = i8_pair_bf16<3>(w0, w1); bf[3][1] = i8_pair_bf16<3>(w8, w9);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u) mma_bf16_16816(acc[i][u], af[i], bf[u]);
    }
  }
  cp_async_wait<0>();

  // Tile u's fragment column 2t + j is the physical column 4(2t + j) + u:
  // the four tiles' sums at (row, j) are four neighbouring columns.
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + warp_m * (MT * 16) + i * 16 + g + 8 * h;
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = n0 + warp_n * 32 + 4 * (2 * t + j);
        if (n >= p.N) continue;
        const float v[4] = {acc[i][0][2 * h + j], acc[i][1][2 * h + j], acc[i][2][2 * h + j], acc[i][3][2 * h + j]};
        if (p.splits == 1) {
          finish4(v, p.scale, p.bias, n, p.y + (size_t)m * p.N + n);
        } else {
          float* dst = p.ws + ((size_t)blockIdx.z * p.M + m) * p.N + n;
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
}

// Split-K finish: sum the partials in split order, then QDense's epilogue.
// One thread per four columns.
__global__ void w8a16_reduce_kernel(Params p) {
  const size_t quads = (size_t)p.M * (p.N / 4);
  const size_t q = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= quads) return;
  const int m = (int)(q / (p.N / 4)), n = (int)(q % (p.N / 4)) * 4;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < p.splits; ++s) {
    const float4 part = *reinterpret_cast<const float4*>(p.ws + ((size_t)s * p.M + m) * p.N + n);
    v[0] += part.x; v[1] += part.y; v[2] += part.z; v[3] += part.w;
  }
  finish4(v, p.scale, p.bias, n, p.y + (size_t)m * p.N + n);
}

template <int BM, int WARPS_M>
int launch(const Params& p, cudaStream_t stream) {
  using T = Tiling<BM, WARPS_M>;
  auto kernel = w8a16_gemm_kernel<BM, WARPS_M>;
  static const cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                       T::SMEM);  // once a process
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, p.splits);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// bm: 16 (four warps) or 128 (eight warps); splits * per BK chunks cover K.
extern "C" int w8a16_gemm(const void* x, const void* kq, const void* scale, const void* bias, void* y, void* ws,
                          int M, int N, int K, int bm, int splits, int per, void* stream) {
  if (M < 1 || N % 16 != 0 || K % 8 != 0 || splits < 1 || per < 1 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(kq), static_cast<const float*>(scale),
           static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), static_cast<float*>(ws),
           M, N, K, splits, per};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (bm == 16) {
    err = launch<16, 1>(p, s);
  } else if (bm == 128) {
    err = launch<128, 2>(p, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != 0 || splits == 1) return err;
  const size_t quads = (size_t)M * (N / 4);
  w8a16_reduce_kernel<<<(unsigned)((quads + 255) / 256), 256, 0, s>>>(p);
  return (int)cudaGetLastError();
}
