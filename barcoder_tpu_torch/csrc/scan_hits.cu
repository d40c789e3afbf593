// Phase-1 Hamming-scan hit indicator for NVIDIA Hopper (sm_90a): an int8
// product on the tensor cores with wgmma.
//
// Replaces barcoder_tpu/ops/pallas_scan.py::_scan_hits_kernel (wrapper
// scan_block_hits). For one genome tile t of P positions and one spacer
// block s of BS_M rows it computes
//
//     score[r, p] = sum_k Q[r, k] G[k, p]     (G[4j + b, p] = [code[p + j] == b])
//                   + the PAM/site bias of column p
//     hit[p]      = max_r score[r, p] >= thresh             (thresh = L - v)
//     out[t, s, u] = number of hit columns in subtile u     (P / SUB columns each)
//
// exactly as the TPU's one-hot bf16 matmul does, in int8 with int32 sums:
//
//   * Q is the engine's one-hot rows cut to K = 4L + the folded bias rows,
//     rounded up to 32 (96 at L = 20 with two folded rows); the wrapper casts
//     it to int8 once per call. G is built in shared memory from the tile's
//     codes (N = 4 and the out-of-bounds 5 set no row) and stays there for
//     the block's life.
//   * Folded bias: G row 4L + i is -128 where bias row i is nonzero (the
//     contract's MASK_BIAS), else 0. A masked row then scores at most
//     32 - 128 here and 32 - 16384 on the TPU; both are below any thresh >
//     -96, and the unmasked rows score the same, so the hit counts are equal.
//   * Additive bias (no spare G row): added in f32 to the int32 column max,
//     exact for any bias, since max_r(s_r + b) = max_r(s_r) + b.
//
// What bounds it on the H100: the int8 tensor rate. At the 20-nt request's
// shape (288 tiles x 20,480 rows x 16,384 columns, K = 96) the product is
// 2 * 96 * 9.66e10 = 1.85e13 operations, 8.66 ms at the card's 2.14e15 int8
// operations a second (132 SMs x 8,192 per clock x 1,980 MHz); the bytes
// (Q, codes, bias, counts: ~63 MB) take ~19 us.
//
// The design, to run the tensor cores and hide the rest behind them (its
// helpers and the loop's shape are wgmma_tile.cuh's, which scan_max.cu,
// colmax_mma.cu and phase1_mma.cu share):
//
//   * a thread block owns 512 columns of one tile and walks every spacer
//     block; consumer warpgroups 0 and 1 own 256 columns each and run
//     wgmma.mma_async m64n256k32 s8: A = 64 Q rows, B = the warpgroup's G
//     columns, both K-major core matrices in shared memory (no swizzle);
//   * a producer thread (warpgroup 2, its registers handed to the consumers
//     with setmaxnreg) keeps an 8-stage ring of 64-row Q chunks full with
//     one cp.async.bulk each, on mbarriers; the wrapper lays Q out as those
//     chunks (spacer blocks padded to 64 rows by repeating their last row,
//     which leaves a block's max unchanged);
//   * the row max comes straight from the accumulator registers: a 3-input
//     integer max folds rows g and g + 8 into a running column max per
//     thread, and when a spacer block ends, a halving shuffle butterfly and
//     shared memory reduce it over the warpgroup's 64 rows; the threshold
//     test adds each hit column to out[t, s, p / (P / SUB)] with a
//     predicated atomic. The wrapper zeroes out, so its pad rows
//     n_sblocks..n_sb_pad8 stay zero;
//   * what is not product hides behind one: the two warpgroups take turns
//     on the tensor cores (one's row max overlaps the other's product), and
//     a warpgroup starts its next chunk's product before it reduces a
//     finished spacer block. That overlap holds only while no divergent
//     branch runs with a wgmma in flight (ptxas would serialize them), so
//     the block-end code is branch-free.

#include "wgmma_tile.cuh"

namespace {

using namespace wgmma_tile;

// What the kernel reads besides Q.
struct Args {
  const float* thresh;   // (1,)
  const int32_t* tiles;  // tile t at t * tile_stride; base j of column p at j * code_stride + p
  const float* bias;     // (n_tiles, bias_rows, P)
  float* out;            // (n_tiles, n_sb_pad8, SUB), zeroed
  long long tile_stride, code_stride;
  int n_sblocks, n_sb_pad8, L, P, SUB, bias_rows, fold, n_chunks;
};

// Four int8 rows k = 4j..4j+3 of G at column p, as one little-endian word:
// the one-hot of base j (codes 4 = N and 5 = out of bounds set nothing), the
// folded bias rows 4L + i (-128 where bias row i is nonzero), or zero.
__device__ __forceinline__ uint32_t g_word(const int32_t* __restrict__ tb,
                                           const float* __restrict__ bb, const Args& a, int p,
                                           int j) {
  if (p >= a.P) return 0u;
  if (j < a.L) {
    const int c = __ldg(tb + (long long)j * a.code_stride + p);
    return (unsigned)c < 4u ? 1u << (8 * c) : 0u;
  }
  if (j == a.L && a.fold) {
    uint32_t w = __ldg(bb + p) != 0.f ? 0x80u : 0u;
    if (a.bias_rows > 1 && __ldg(bb + a.P + p) != 0.f) w |= 0x8000u;
    return w;
  }
  return 0u;
}

constexpr int QSTAGES = 8;

// shared memory for KS k-steps of 32: G, the Q ring, the per-warp column
// maxima of both consumer warpgroups, the full and empty barriers
template <int KS> constexpr int G_BYTES = BN * KS * 32;
template <int KS> constexpr int CHUNK_BYTES = CHUNK * KS * 32;
template <int KS> constexpr int RED_OFF = G_BYTES<KS> + QSTAGES * CHUNK_BYTES<KS>;
template <int KS> constexpr int BAR_OFF = RED_OFF<KS> + 2 * 4 * N * 4;
template <int KS> constexpr int SMEM = BAR_OFF<KS> + 2 * QSTAGES * 8;

// qc: Q cut to K = 32 KS int8 columns, its spacer blocks padded to BS64 rows
// (a multiple of 64, by repeating a block's last row), and laid out by the
// wrapper as chunks of 64 rows, each chunk (2 KS, 8, 8, 16): core matrix
// (8-row group g, 16-byte K piece c) at c * 1024 + g * 128. A thread block
// owns BN columns of one tile; consumer warpgroup wg owns N of them.
template <int KS>
__global__ void __launch_bounds__(WG_THREADS, 1)
    scan_hits_kernel(const uint8_t* __restrict__ qc, const __grid_constant__ Args a, int BS64) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int t = blockIdx.x / a.n_chunks;
  const int p0 = (blockIdx.x % a.n_chunks) * BN;
  const int32_t* tb = a.tiles + t * a.tile_stride;
  const float* bb = a.bias + (long long)t * a.bias_rows * a.P;
  const uint32_t g_s = smem_u32(smem);
  const uint32_t q_s = g_s + G_BYTES<KS>;
  int* red = reinterpret_cast<int*>(smem + RED_OFF<KS>);
  const uint32_t full = g_s + BAR_OFF<KS>, empty = full + QSTAGES * 8;

  // G for the block's BN columns, K-major core matrices: column n's 16-byte
  // K piece c at c * BN * 16 + n * 16
  for (int idx = threadIdx.x; idx < BN * 2 * KS; idx += WG_THREADS) {
    const int c = idx / BN, n = idx % BN;
    uint4 v;
    v.x = g_word(tb, bb, a, p0 + n, 4 * c);
    v.y = g_word(tb, bb, a, p0 + n, 4 * c + 1);
    v.z = g_word(tb, bb, a, p0 + n, 4 * c + 2);
    v.w = g_word(tb, bb, a, p0 + n, 4 * c + 3);
    *reinterpret_cast<uint4*>(smem + c * BN * 16 + n * 16) = v;
  }
  ring_init(full, QSTAGES);  // and G visible to wgmma
  __syncthreads();

  const int cpb = BS64 / CHUNK;
  const int n = a.n_sblocks * cpb;
  // the warp index read through a shuffle: the compiler then knows it is the
  // same across the warp, so the role branches below are not divergent ones
  // (a wgmma in flight across a divergent branch is serialized by ptxas)
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), lane = threadIdx.x % 32;

  if (warp >= 8) {  // producer: one thread keeps the ring of Q chunks full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0)
      for (int i = 0; i < n; ++i) {
        const int slot = i % QSTAGES;
        mbar_wait(empty + 8 * slot, ((i / QSTAGES) & 1) ^ 1);
        bulk_load(q_s + slot * CHUNK_BYTES<KS>, qc + (size_t)i * CHUNK_BYTES<KS>,
                  CHUNK_BYTES<KS>, full + 8 * slot);
      }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp / 4, w4 = warp % 4;
    const float th = __ldg(a.thresh);
    int* red_wg = red + wg * 4 * N;
    const uint32_t g_wg = g_s + wg * (N / 8) * 128;

    // this thread's epilogue columns c = h * 128 + (thread in warpgroup):
    // column p of the tile, its subtile and its additive bias; dead columns
    // (p >= P, the last block's ragged edge) never count
    int sub[N / 128];
    float badd[N / 128];
    bool live[N / 128];
#pragma unroll
    for (int h = 0; h < N / 128; ++h) {
      const int p = p0 + wg * N + h * 128 + threadIdx.x % 128;
      live[h] = p < a.P;
      sub[h] = live[h] ? p / (a.P / a.SUB) : 0;
      badd[h] = live[h] && !a.fold ? __ldg(bb + p) : 0.f;
    }

    int run[RV];
#pragma unroll
    for (int i = 0; i < RV; ++i) run[i] = INT_MIN;
    int acc[N / 2];
    // chunk i's product, asynchronous: wgmma reads the chunk's Q and the
    // warpgroup's G from shared memory and writes acc
    auto issue = [&](int i) {
      const int slot = i % QSTAGES;
      mbar_wait(full + 8 * slot, (i / QSTAGES) & 1);
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
      if (lane == 0) mbar_arrive(empty + 8 * (i % QSTAGES));
      fold_rows(run, acc);
      // the next product runs while this warpgroup reduces a finished block
      if (i + 1 < n) issue(i + 1);
      if ((i + 1) % cpb) continue;
      // spacer block i / cpb ends: its column maxima over the warp's rows,
      // then over the 4 warps through shared memory
      reduce_rows(run, red_wg, w4, lane);
      wg_bar(1 + wg);
      // the threshold: a hit column adds one to out[t, s, its subtile]; the
      // additive bias (0 when folded) goes on after the max, exactly
      float* out_row = a.out + ((long long)t * a.n_sb_pad8 + i / cpb) * a.SUB;
#pragma unroll
      for (int h = 0; h < N / 128; ++h) {
        const int m = column_max(red_wg, h * 128 + threadIdx.x % 128);
        add_one_if(out_row + sub[h], live[h] & ((float)m + badd[h] >= th));
      }
      wg_bar(1 + wg);
    }
  }
}

template <int KS>
int launch(const void* qc, const Args& a, int n_tiles, int BS64, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(scan_hits_kernel<KS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM<KS>);
  if (err != cudaSuccess) return (int)err;
  scan_hits_kernel<KS><<<n_tiles * a.n_chunks, WG_THREADS, SMEM<KS>, stream>>>(
      static_cast<const uint8_t*>(qc), a, BS64);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(). qc is Q
// as the wrapper lays it out (see scan_hits_kernel) with KS k-steps of 32
// int8 columns and spacer blocks of BS_M rows padded to a multiple of 64. The
// Python wrapper checks shapes, types and limits (KS <= 4, bias_rows <= 2)
// before calling.
extern "C" int scan_block_hits_launch(const void* thresh, const void* qc, const void* tiles,
                                      const void* bias, void* out, int n_tiles, int n_sblocks,
                                      int n_sb_pad8, int KS, int L, int P, int SUB, int BS_M,
                                      long long tile_stride, long long code_stride,
                                      int bias_rows, int fold, void* stream) {
  if (n_tiles == 0 || n_sblocks == 0) return 0;
  const Args a{static_cast<const float*>(thresh), static_cast<const int32_t*>(tiles),
               static_cast<const float*>(bias), static_cast<float*>(out), tile_stride,
               code_stride, n_sblocks, n_sb_pad8, L, P, SUB, bias_rows, fold,
               (P + BN - 1) / BN};
  const int BS64 = (BS_M + CHUNK - 1) / CHUNK * CHUNK;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (KS) {
    case 1: return launch<1>(qc, a, n_tiles, BS64, st);
    case 2: return launch<2>(qc, a, n_tiles, BS64, st);
    case 3: return launch<3>(qc, a, n_tiles, BS64, st);
    case 4: return launch<4>(qc, a, n_tiles, BS64, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
