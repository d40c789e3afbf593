// The phase-1 hit kernel's TPU ablations on the tensor cores, for NVIDIA
// Hopper (sm_90a): one bf16 wgmma kernel, templated on where G comes from
// and on the epilogue.
//
// Replaces two TPU microbenchmarks of barcoder_tpu/ops/pallas_scan.py's
// _scan_hits_kernel (scores = Q.G with the site bias folded into G rows 4L
// and 4L + 1, the max over each spacer block's rows, the hit test
// max >= thresh, a count of hit columns per subtile of P / SUB columns):
//
//   experiments/phase1_ablate.py::make_kern -> kern, variants
//     A  G built in the kernel, counts written per spacer block (BUILT, COUNT)
//     B  G streamed from a prebuilt (T, K, P) array, per block  (STREAM, COUNT)
//     C  G built, counts batched over 8 spacer blocks           (BUILT, COUNT8)
//     D  G streamed, batched                                    (STREAM, COUNT8)
//   experiments/phase1_bench.py::make_variant -> kern, with G built:
//     a  the column maxima (the TPU stored lanes 0..SUB-1)       (BUILT, COLMAX)
//     b  the hit bits (the TPU stored lanes 0..SUB-1)            (BUILT, HIT)
//     c  counts batched over 8 blocks                             (BUILT, COUNT8)
//     d  counts per block                                         (BUILT, COUNT)
//
// COLMAX and HIT write every column, (T, n_sblocks, P) f32 and uint8, so the
// kernel does the whole product the TPU kernel did; the wrapper
// (ops/phase1_variants.py) takes the TPU's lanes.
//
// The main loop is colmax_mma.cu's in bf16 (wgmma_tile.cuh): a thread block
// of three warpgroups owns 512 columns of one tile for its life and walks
// every spacer block. Consumer warpgroups 0 and 1 own 256 columns each and
// run wgmma.mma_async m64n256k16 f32.bf16.bf16, KS k-steps of 16 for a
// depth of 16 KS, A = a 64-row chunk of Q, B = the warpgroup's G columns,
// both K-major core matrices in shared memory; the producer warpgroup keeps
// a 4-stage ring of 2 KS KB Q chunks full with one cp.async.bulk each (the
// wrapper lays Q out as those chunks, cut to the depth, a spacer block
// padded to 64 rows by repeating its last row, which leaves its max as it
// is). Shared memory at KS = 8: G 128 KB, ring 64 KB, reduction 8 KB. G is
// staged once per (tile, 512 columns), as the TPU built it once per tile
// at s == 0:
//
//   * BUILT writes G's K-major pieces straight from the tile's codes and
//     bias: column n's 16-byte piece c holds k = 8c..8c+7, that is bases
//     j = 2c and 2c + 1, four bf16 rows each. G[4j + b, p] = 1.0 (0x3F80)
//     where code[p + j] == b; G[4L + i, p] = bf16(bias[i, p]) (round to
//     nearest even, as torch's cast); every other row 0. A code at or past
//     tile_w reads as N = 4 and sets no row; columns >= P are zero. Rows
//     past 4L + 1 are zero, so BUILT issues only the depth its rows need,
//     K_eff = 4L + 2 rounded up to 32 (KS = 2, 4, 6 or 8; 96 at L = 20, the
//     scan_hits kernel's depth there too), and reads only Q's first K_eff
//     columns. ops/phase1_variants.py::g_pieces states the same layout for
//     the tests;
//   * STREAM transposes the block's K x 512 slab of the prebuilt G into the
//     same pieces (stage_g). Any row of g_all may be nonzero: KS = 8.
//
// The epilogue runs as a spacer block ends, once the warpgroup's column
// maxima are reduced over its 64 rows; each thread then holds 2 columns:
//
//   COUNT   adds each hit column to out[t, s, p / (P / SUB)];
//   COUNT8  keeps the hit bits of 8 blocks in a register and, when s % 8 ==
//           7, adds them into rows s - 7 .. s and clears them. As on the TPU
//           (the output block was zeroed at s % 8 == 0 and written at s % 8
//           == 7), a last group of fewer than 8 blocks is never written: its
//           rows stay zero (the wrapper zeroes out);
//   COLMAX  stores the f32 maxima;
//   HIT     stores the hit bits, one byte a column.
//
// Every store and add is a predicated instruction: the code between two
// products stays branch-free, so the next chunk's product runs while the
// epilogue does (wgmma_tile.cuh). Counts are small integers, so the order of
// the adds cannot change them.
//
// Exactness: the products of bf16 values are exact in f32, and so is their
// sum in any order while every partial sum is a representable f32 (one-hot
// scores are integers up to L + 2; the bias values are 0, -16384 and values
// of a few significant bits), so the kernel and the plain version agree bit
// for bit. Q must be finite, as for the plain version's max (the kernel's
// fmaxf drops a NaN that torch's amax keeps); then a column of Q past
// K_eff meets zero G rows and adds 0 to every score, so BUILT leaves it out.
//
// What bounds it on the H100: the bf16 tensor rate, 2 operations a (row,
// column) pair for each row of G the function needs: 4L + 2 built (82 at
// L = 20: 1.76e13 at the scripts' 320 tiles x 20,480 rows x 16,384 columns,
// 16.4 ms at 132 SMs x 4,096 a clock x 1,980 MHz; it issues 96: 19.3 ms),
// 128 streamed (25.7 ms). The bytes are small beside that, but for COLMAX's
// f32 output (839 MB there, ~0.25 ms at 3.35 TB/s).

#include <cuda_bf16.h>

#include "wgmma_tile.cuh"

namespace {

using namespace wgmma_tile;

enum { COUNT = 0, COUNT8 = 1, COLMAX = 2, HIT = 3 };

constexpr int K = 128;              // rows of g_all (bf16 elements)
constexpr int KS_FULL = K * 2 / 32;  // k-steps of 32 bytes at depth K
constexpr int STAGES = 4;           // Q chunks in the ring

// shared memory for KS k-steps of 32 bytes: G, the Q ring, the per-warp
// column maxima, the ring's barriers
template <int KS> constexpr int G_BYTES = BN * KS * 32;         // 128 KB at KS = 8
template <int KS> constexpr int CHUNK_BYTES = CHUNK * KS * 32;  // 16 KB at KS = 8
template <int KS> constexpr int RED_OFF = G_BYTES<KS> + STAGES * CHUNK_BYTES<KS>;
template <int KS> constexpr int BAR_OFF = RED_OFF<KS> + 2 * 4 * N * 4;
template <int KS> constexpr int SMEM = BAR_OFF<KS> + 2 * STAGES * 8;

// What the kernel reads besides Q.
struct Args {
  const float* thresh;   // (1,)
  const int32_t* tiles;  // (n_tiles, 1, tile_w) codes (BUILT)
  const float* bias;     // (n_tiles, 2, P) (BUILT)
  const uint8_t* g_all;  // (n_tiles, K, P) bf16 (STREAM)
  void* out;             // see phase1_mma_launch
  int n_sblocks, n_sb_pad8, L, P, SUB, tile_w, n_chunks;
};

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// Rows 4j..4j+3 of G at column p, as two words of two bf16 each (row 4j in
// the low half of the first): the one-hot of base j, the 2 bias rows at
// j == L, or zero.
__device__ __forceinline__ uint2 g_base(const int32_t* __restrict__ codes,
                                        const float* __restrict__ bias, const Args& a, int p,
                                        int j) {
  if (p >= a.P || j > a.L) return make_uint2(0u, 0u);
  if (j == a.L)
    return make_uint2(bf16_bits(__ldg(bias + p)) | bf16_bits(__ldg(bias + a.P + p)) << 16, 0u);
  const int x = p + j < a.tile_w ? __ldg(codes + p + j) : 4;  // 4 = N: no row
  const uint32_t one = (unsigned)x < 4u ? 0x3F80u << (16 * (x & 1)) : 0u;  // bf16 1.0
  return x < 2 ? make_uint2(one, 0u) : make_uint2(0u, one);
}

// G for the block's BN columns, from the tile's codes and bias: column n's
// 16-byte K piece c (bases 2c and 2c + 1) at c * BN * 16 + n * 16, for the
// KS k-steps' 2 KS pieces.
template <int KS>
__device__ __forceinline__ void build_g(const int32_t* __restrict__ codes,
                                        const float* __restrict__ bias, const Args& a, int p0,
                                        uint8_t* smem) {
  for (int idx = threadIdx.x; idx < BN * 2 * KS; idx += WG_THREADS) {
    const int c = idx / BN, n = idx % BN;
    const uint2 lo = g_base(codes, bias, a, p0 + n, 2 * c);
    const uint2 hi = g_base(codes, bias, a, p0 + n, 2 * c + 1);
    *reinterpret_cast<uint4*>(smem + c * BN * 16 + n * 16) = make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
}

// qc: Q (n_sblocks * BS_M, 16 KS) bf16 with its spacer blocks padded to BS64
// rows (a multiple of 64), laid out as chunks of 64 rows (wgmma_tile.cuh).
template <bool STREAM, int EPI, int KS>
__global__ void __launch_bounds__(WG_THREADS, 1)
    phase1_mma_kernel(const uint8_t* __restrict__ qc, const __grid_constant__ Args a, int BS64) {
  static_assert(!STREAM || KS == KS_FULL, "g_all's rows are all read");
  extern __shared__ __align__(1024) uint8_t smem[];
  const int t = blockIdx.x / a.n_chunks;
  const int p0 = (blockIdx.x % a.n_chunks) * BN;
  const uint32_t g_s = smem_u32(smem);
  const uint32_t q_s = g_s + G_BYTES<KS>;
  float* red = reinterpret_cast<float*>(smem + RED_OFF<KS>);
  const uint32_t full = g_s + BAR_OFF<KS>, empty = full + STAGES * 8;

  if constexpr (STREAM)
    stage_g<2, KS>(a.g_all + (size_t)t * K * a.P * 2, a.P, p0, smem);
  else
    build_g<KS>(a.tiles + (size_t)t * a.tile_w, a.bias + (size_t)t * 2 * a.P, a, p0, smem);
  ring_init(full, STAGES);  // and G visible to wgmma
  __syncthreads();

  const int cpb = BS64 / CHUNK;
  const int n = a.n_sblocks * cpb;
  // the warp index read through a shuffle: the compiler then knows it is the
  // same across the warp, so the role branches below are not divergent ones
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), lane = threadIdx.x % 32;

  if (warp >= 8) {  // producer: one thread keeps the ring of Q chunks full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0)
      for (int i = 0; i < n; ++i) {
        const int slot = i % STAGES;
        mbar_wait(empty + 8 * slot, ((i / STAGES) & 1) ^ 1);
        bulk_load(q_s + slot * CHUNK_BYTES<KS>, qc + (size_t)i * CHUNK_BYTES<KS>,
                  CHUNK_BYTES<KS>, full + 8 * slot);
      }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp / 4, w4 = warp % 4;
    const float th = __ldg(a.thresh);
    float* red_wg = red + wg * 4 * N;
    const uint32_t g_wg = g_s + wg * (N / 8) * 128;
    float* counts = static_cast<float*>(a.out) + (size_t)t * a.n_sb_pad8 * a.SUB;

    // this thread's epilogue columns c = h * 128 + (thread in warpgroup):
    // column p of the tile, whether it exists (the last block's ragged edge
    // does not), its subtile
    int col[N / 128], sub[N / 128];
    bool live[N / 128];
#pragma unroll
    for (int h = 0; h < N / 128; ++h) {
      col[h] = p0 + wg * N + h * 128 + threadIdx.x % 128;
      live[h] = col[h] < a.P;
      sub[h] = live[h] ? col[h] / (a.P / a.SUB) : 0;
    }
    uint32_t bits = 0u;  // COUNT8: bit 2k + h = column h hit in block 8m + k

    float run[RV];
#pragma unroll
    for (int i = 0; i < RV; ++i) run[i] = -INFINITY;
    float acc[N / 2];
    // chunk i's product, asynchronous: wgmma reads the chunk's Q and the
    // warpgroup's G from shared memory and writes acc
    auto issue = [&](int i) {
      const int slot = i % STAGES;
      mbar_wait(full + 8 * slot, (i / STAGES) & 1);
      const uint32_t qa = q_s + slot * CHUNK_BYTES<KS>;
      wgmma_fence();  // after the row max's reads of acc
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma_step(acc, smem_desc(qa + ks * 2048, 1024, 128),
                   smem_desc(g_wg + ks * 2 * BN * 16, BN * 16, 128), ks > 0);
      wgmma_commit();
    };
    issue(0);
    for (int i = 0; i < n; ++i) {
      wgmma_wait_all();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + 8 * (i % STAGES));
      fold_rows(run, acc);
      // the next product runs while this warpgroup ends a finished block
      if (i + 1 < n) issue(i + 1);
      if ((i + 1) % cpb) continue;
      reduce_rows(run, red_wg, w4, lane);
      wg_bar(1 + wg);
      const int s = i / cpb;
#pragma unroll
      for (int h = 0; h < N / 128; ++h) {
        const float m = column_max(red_wg, h * 128 + threadIdx.x % 128);
        const bool hit = live[h] & (m >= th);
        const size_t at = ((size_t)t * a.n_sblocks + s) * a.P + col[h];
        if constexpr (EPI == COUNT)
          add_one_if(counts + (size_t)s * a.SUB + sub[h], hit);
        else if constexpr (EPI == COUNT8)
          bits |= uint32_t(hit) << (2 * (s % 8) + h);
        else if constexpr (EPI == COLMAX)
          store_if(static_cast<float*>(a.out) + at, __float_as_uint(m), live[h]);
        else
          store_u8_if(static_cast<uint8_t*>(a.out) + at, uint32_t(hit), live[h]);
      }
      if constexpr (EPI == COUNT8) {
        const bool flush = s % 8 == 7;
        float* group = counts + (size_t)(s - s % 8) * a.SUB;
#pragma unroll
        for (int k = 0; k < 8; ++k)
#pragma unroll
          for (int h = 0; h < N / 128; ++h)
            add_one_if(group + k * a.SUB + sub[h], flush & bool((bits >> (2 * k + h)) & 1u));
        bits = flush ? 0u : bits;
      }
      wg_bar(1 + wg);
    }
  }
}

template <bool STREAM, int EPI, int KS>
int launch(const void* qc, const Args& a, int n_tiles, int BS64, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(phase1_mma_kernel<STREAM, EPI, KS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM<KS>);
  if (err != cudaSuccess) return (int)err;
  phase1_mma_kernel<STREAM, EPI, KS><<<n_tiles * a.n_chunks, WG_THREADS, SMEM<KS>, stream>>>(
      static_cast<const uint8_t*>(qc), a, BS64);
  return (int)cudaGetLastError();
}

// BUILT: the four epilogues at the depth G's rows need
template <int KS>
int launch_built(int epilogue, const void* qc, const Args& a, int n_tiles, int BS64,
                 cudaStream_t stream) {
  switch (epilogue) {
    case COUNT: return launch<false, COUNT, KS>(qc, a, n_tiles, BS64, stream);
    case COUNT8: return launch<false, COUNT8, KS>(qc, a, n_tiles, BS64, stream);
    case COLMAX: return launch<false, COLMAX, KS>(qc, a, n_tiles, BS64, stream);
    case HIT: return launch<false, HIT, KS>(qc, a, n_tiles, BS64, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_any(int stream_g, int epilogue, int KS, const void* qc, const Args& a, int n_tiles,
               int BS64, cudaStream_t stream) {
  if (4 * a.L + 2 > 16 * KS) return (int)cudaErrorInvalidValue;  // G's rows past the depth
  if (stream_g) {  // ablations B and D: the counts, at depth K
    if (KS != KS_FULL) return (int)cudaErrorInvalidValue;
    switch (epilogue) {
      case COUNT: return launch<true, COUNT, KS_FULL>(qc, a, n_tiles, BS64, stream);
      case COUNT8: return launch<true, COUNT8, KS_FULL>(qc, a, n_tiles, BS64, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (KS) {
    case 2: return launch_built<2>(epilogue, qc, a, n_tiles, BS64, stream);
    case 4: return launch_built<4>(epilogue, qc, a, n_tiles, BS64, stream);
    case 6: return launch_built<6>(epilogue, qc, a, n_tiles, BS64, stream);
    case 8: return launch_built<8>(epilogue, qc, a, n_tiles, BS64, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch on `stream` and return cudaGetLastError(). qc is Q as the wrapper
// lays it out, cut to KS k-steps of 16 columns (see phase1_mma_kernel);
// stream_g: 0 = G built from tiles and bias (KS = 2, 4, 6 or 8, at least
// 4L + 2 rows), 1 = G read from g_all (16-byte aligned; KS = 8, counts
// only); epilogue: 0 = counts per block, 1 = counts batched over 8 blocks
// (both into a zeroed (n_tiles, n_sb_pad8, SUB) f32 out), 2 = column maxima
// ((n_tiles, n_sblocks, P) f32), 3 = hit bits ((n_tiles, n_sblocks, P)
// uint8). The Python wrapper checks the shapes, types and limits first
// (K = 128, 4L + 2 <= K, P % 16 == 0, P % SUB == 0, tile_w >= P + L - 1,
// n_tiles * ceil(P / 512) < 2^31).
extern "C" int phase1_mma_launch(int stream_g, int epilogue, int KS, const void* thresh,
                                 const void* qc, const void* tiles, const void* bias,
                                 const void* g_all, void* out, int n_tiles, int n_sblocks,
                                 int n_sb_pad8, int BS_M, int L, int P, int SUB, int tile_w,
                                 void* stream) {
  if (n_tiles == 0 || n_sblocks == 0) return 0;
  const Args a{static_cast<const float*>(thresh), static_cast<const int32_t*>(tiles),
               static_cast<const float*>(bias), static_cast<const uint8_t*>(g_all), out,
               n_sblocks, n_sb_pad8, L, P, SUB, tile_w, (P + BN - 1) / BN};
  const int BS64 = (BS_M + CHUNK - 1) / CHUNK * CHUNK;
  return launch_any(stream_g, epilogue, KS, qc, a, n_tiles, BS64,
                    static_cast<cudaStream_t>(stream));
}
