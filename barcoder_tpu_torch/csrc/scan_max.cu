// Phase-1 block max of the older sharded engine, for NVIDIA Hopper (sm_90a):
// an int8 product on the tensor cores with wgmma.
//
// Replaces barcoder_tpu/ops/pallas_scan.py::_scan_max_kernel (wrapper
// scan_block_max), whose only caller is the sharded block-max scan that the
// scaling harness times beside the flagship engine. For one genome tile t of
// P positions and one spacer block s of BS = 128 rows it computes
//
//     score[r, p]  = sum_k Q[r, k] G[k, p]     (G[4j + b, p] = [code[p + j] == b])
//                    + the PAM/site bias of column p
//     out[t, u, s] = max of score[r, p] over the block's rows r and the
//                    columns p of subtile u (P / SUB columns each)
//
// exactly as the TPU's one-hot bf16 matmul does, in int8 with int32 sums: the
// main loop of scan_hits.cu (wgmma_tile.cuh: a thread block owns 512 columns
// of one tile, builds their G once, and walks every spacer block; two
// consumer warpgroups run wgmma m64n256k32 s8 on a ring of 64-row Q chunks
// that a producer thread fills with bulk copies; the row max comes from the
// accumulator registers). K is the 4L one-hot rows rounded up to 32 (96 at
// L = 20, 128 at L = 32).
//
// The bias stays out of the product, because the function returns the value
// itself and keeps the TPU's rounding of any bias:
//   * additive (no spare G row, or the caller's choice): every row sees the
//     same column bias, so it is added in f32 to the int32 column max, as the
//     TPU adds it before its max (f32 addition is monotone, so the two orders
//     give the same number);
//   * folded (4L < K): the TPU writes the bf16-rounded bias into G row 4L, so
//     a row's bias is Q[r, 4L] * bf16(bias[p]). Rows with the constant 1 get
//     the bias; rows without it (the engine's zero padding rows) get 0, so on
//     a masked column they score 0 and not -16384. A first small kernel
//     (scan_max_units_kernel) therefore splits every spacer block's rows into
//     those two groups and hands the main kernel units of 128 rows of ONE
//     group: a block of one group is one unit; a block of both is two, each
//     group's rows in place and the other rows replaced by a repeat of one of
//     the group's (a repeat leaves a max as it is). It writes the units' rows
//     as int8 in the chunk layout and meta[1 + u] = 2 * (unit u's spacer
//     block) + its group; the group only selects the bias that goes on after
//     the unit's row max.
//
// Subtile maxima cross thread blocks (32 of them share one output value at
// P = 16,384, SUB = 1) and units (a mixed block's two). A float maps to an
// unsigned key with the same order, and the keys meet by atomic max in the
// zeroed key array that is the output buffer. When a unit ends, its column
// maxima (packed two to a word, so the row butterfly moves half as many
// registers) are reduced over the warpgroup's rows in shared memory, each
// thread adds the bias to two columns and takes their keys, and then
//   * where a warp's 64 columns share a subtile (its width a multiple of 64:
//     SUB = 1 and SUB = 32 at P = 16,384), a redux over the warp and one
//     atomic per warp from its lane 0;
//   * else an atomic per column into the warpgroup's subtile keys in shared
//     memory and, after a barrier, one global atomic per touched subtile.
// A last small kernel decodes the keys to f32 in place and sets the
// untouched lanes (s >= n_sblocks) to -16384. Max is order-free, so the
// result is the same bit for bit from run to run (the second units of mixed
// blocks take their places in any order).
//
// What bounds it on the H100: the int8 tensor rate (2 * 4L operations a
// pair); Q, the codes, the bias and the output are a few MB. What holds it
// under that bound: the main loop is scan_hits' (K padded from 80 to 96 at
// L = 20, the row max and the issue between two products), and a unit ends
// every 2 chunks here, against every 8 in scan_hits at 512-row blocks, so
// the unit end (the row butterfly, a warpgroup barrier, the bias, the keys)
// hides behind the other warpgroup's product only in part. chip_smoke.py
// times scan_hits on the same inputs at 512- and 128-row blocks beside it.

#include <cuda_bf16.h>

#include "wgmma_tile.cuh"

namespace {

using namespace wgmma_tile;

constexpr int QSTAGES = 8;
constexpr int BS = 128;         // spacer rows per block (the TPU kernel's MXU M dim)
constexpr int UNIT_CHUNKS = 2;  // a unit is BS rows

// What the kernel reads besides Q.
struct Args {
  const int32_t* meta;   // [0] = units past n_sblocks; [1 + u] = 2 * (unit u's block) + its group
  const int32_t* tiles;  // (n_tiles, 1, tile_w) codes: base j of column p at j + p
  const float* bias;     // (n_tiles, 1, P)
  uint32_t* keys;        // (n_tiles, SUB, nsb_pad), zeroed
  long long tile_w;
  int n_sblocks, L, P, SUB, nsb_pad, fold, n_chunks;
};

template <int KS> constexpr int G_BYTES = BN * KS * 32;
template <int KS> constexpr int CHUNK_BYTES = CHUNK * KS * 32;
template <int KS> constexpr int RED_OFF = G_BYTES<KS> + QSTAGES * CHUNK_BYTES<KS>;
template <int KS> constexpr int KEY_OFF = RED_OFF<KS> + 2 * 4 * N * 4;  // 2 x N subtile keys
template <int KS> constexpr int BAR_OFF = KEY_OFF<KS> + 2 * N * 4;
template <int KS> constexpr int SMEM = BAR_OFF<KS> + 2 * QSTAGES * 8;

__device__ __forceinline__ bool nonzero_bf16(uint16_t bits) {
  return (bits & 0x7FFFu) != 0u;  // -0.0 counts as zero
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// float -> unsigned key with the same order (a < b iff key(a) < key(b)); no
// float maps to 0 but a NaN with every bit set, so 0 means "untouched"
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float from_key(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// Four int8 rows k = 4j..4j+3 of G at column p, as one little-endian word:
// the one-hot of base j (codes 4 = N and 5 = out of bounds set nothing).
__device__ __forceinline__ uint32_t g_word(const int32_t* __restrict__ tb, const Args& a, int p,
                                           int j) {
  if (p >= a.P || j >= a.L) return 0u;
  const int c = __ldg(tb + j + p);
  return (unsigned)c < 4u ? 1u << (8 * c) : 0u;
}

// *dst = max(*dst, v) where on, as one predicated reduction: no branch, so
// the code around a wgmma in flight stays uniform.
__device__ __forceinline__ void smem_max_if(uint32_t dst, uint32_t v, bool on) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p red.shared.max.u32 [%0], %1;\n}\n" ::
                   "r"(dst), "r"(v), "r"((int)on)
               : "memory");
}
__device__ __forceinline__ void global_max_if(uint32_t* dst, uint32_t v, bool on) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p red.global.max.u32 [%0], %1;\n}\n" ::
                   "l"(dst), "r"(v), "r"((int)on)
               : "memory");
}

// Row r of unit `unit` in the chunk layout (wgmma_tile.cuh; unit u is chunks
// 2u and 2u + 1): the first 32 KS columns of the bf16 row `src` as int8
// (columns past K are zero; they meet zero G rows).
__device__ __forceinline__ void write_unit_row(uint8_t* __restrict__ qc, int unit, int r,
                                               const uint16_t* __restrict__ src, int K, int KS) {
  uint8_t* dst = qc + ((size_t)unit * UNIT_CHUNKS + r / CHUNK) * (CHUNK * KS * 32) +
                 (r % CHUNK / 8) * 128 + (r % 8) * 16;
  for (int c = 0; c < 2 * KS; ++c) {  // the row's 16-byte K pieces
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const int k = 16 * c + b;
      const int v = k < K ? (int)__uint_as_float((uint32_t)src[k] << 16) : 0;
      w[b / 4] |= (uint32_t)(v & 0xFF) << (8 * (b % 4));
    }
    *reinterpret_cast<uint4*>(dst + c * 1024) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The units of spacer block blockIdx.x, one thread per row: the block's first
// unit takes slot s (group 0 where the block has such rows, else group 1),
// the second unit of a block with both groups (group 1) a slot past
// n_sblocks, counted in meta[0] (zeroed by the wrapper).
__global__ void __launch_bounds__(BS)
    scan_max_units_kernel(const uint16_t* __restrict__ q,  // (>= n_sblocks * 128, K) bf16 bits
                          uint8_t* __restrict__ qc, int32_t* __restrict__ meta, int n_sblocks,
                          int K, int L, int KS, int fold) {
  __shared__ int rep[2];  // a row of each group
  __shared__ int second;
  const int s = blockIdx.x, r = threadIdx.x;
  const uint16_t* rows = q + (size_t)s * BS * K;
  const int group = fold && nonzero_bf16(rows[(size_t)r * K + 4 * L]);
  if (r < 2) rep[r] = BS;
  __syncthreads();
  atomicMin(&rep[group], r);
  const int n1 = __syncthreads_count(group);
  const bool mixed = n1 > 0 && n1 < BS;
  const int first = n1 == BS;  // the first unit's group
  if (r == 0) {
    meta[1 + s] = 2 * s + first;
    if (mixed) {
      second = n_sblocks + atomicAdd(meta, 1);
      meta[1 + second] = 2 * s + 1;
    }
  }
  __syncthreads();
  write_unit_row(qc, s, r, rows + (size_t)(group == first ? r : rep[first]) * K, K, KS);
  if (mixed) write_unit_row(qc, second, r, rows + (size_t)(group ? r : rep[1]) * K, K, KS);
}

// Two columns' maxima in the 16-bit halves of one word (the scores are
// 0..128): the unit-end butterfly then moves and compares half as many
// registers as reduce_rows.
__device__ __forceinline__ uint32_t max_pairs(uint32_t a, uint32_t b) {
  return __vimax3_s16x2(a, b, b);
}
template <int HALF, int XOR>
__device__ __forceinline__ void halve_pairs(uint32_t (&pk)[RV / 2], int lane) {
  const bool upper = lane & XOR;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const uint32_t keep = upper ? pk[i + HALF] : pk[i];
    const uint32_t send = upper ? pk[i] : pk[i + HALF];
    pk[i] = max_pairs(keep, __shfl_xor_sync(0xffffffffu, send, XOR));
  }
}
// A unit ends: the running maxima, packed in pairs of neighbouring columns,
// over the warp's rows by the halving butterfly of wgmma_tile.cuh, written to
// the warp's row w4 of the warpgroup's 4 x N / 2 buffer, and reset. Pair u of
// the buffer is columns 2u and 2u + 1 of the warpgroup.
__device__ __forceinline__ void reduce_rows_pairs(int (&run)[RV], uint32_t* red_wg, int w4,
                                                  int lane) {
  const int g = lane / 4, qd = lane % 4;
  uint32_t pk[RV / 2];
  // run[2j + e] is column 8j + 2qd + e
#pragma unroll
  for (int j = 0; j < RV / 2; ++j) pk[j] = (uint32_t)run[2 * j] | ((uint32_t)run[2 * j + 1] << 16);
  halve_pairs<RV / 4, 16>(pk, lane);
  halve_pairs<RV / 8, 8>(pk, lane);
  halve_pairs<RV / 16, 4>(pk, lane);
  // pk[w] is now columns 32g + 8w + 2qd and the next over the warp's rows
#pragma unroll
  for (int w = 0; w < VPT / 2; ++w) red_wg[w4 * (N / 2) + 16 * g + 4 * w + qd] = pk[w];
#pragma unroll
  for (int v = 0; v < RV; ++v) run[v] = 0;
}

// qc, a.meta: the units as scan_max_units_kernel leaves them.
template <int KS>
__global__ void __launch_bounds__(WG_THREADS, 1)
    scan_max_kernel(const uint8_t* __restrict__ qc, const __grid_constant__ Args a) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int t = blockIdx.x / a.n_chunks;
  const int p0 = (blockIdx.x % a.n_chunks) * BN;
  const int32_t* tb = a.tiles + t * a.tile_w;
  const float* bb = a.bias + (long long)t * a.P;
  const uint32_t g_s = smem_u32(smem);
  const uint32_t q_s = g_s + G_BYTES<KS>;
  uint32_t* red = reinterpret_cast<uint32_t*>(smem + RED_OFF<KS>);
  uint32_t* skey = reinterpret_cast<uint32_t*>(smem + KEY_OFF<KS>);
  const uint32_t full = g_s + BAR_OFF<KS>, empty = full + QSTAGES * 8;

  // G for the block's BN columns, K-major core matrices: column n's 16-byte
  // K piece c at c * BN * 16 + n * 16
  for (int idx = threadIdx.x; idx < BN * 2 * KS; idx += WG_THREADS) {
    const int c = idx / BN, n = idx % BN;
    uint4 v;
    v.x = g_word(tb, a, p0 + n, 4 * c);
    v.y = g_word(tb, a, p0 + n, 4 * c + 1);
    v.z = g_word(tb, a, p0 + n, 4 * c + 2);
    v.w = g_word(tb, a, p0 + n, 4 * c + 3);
    *reinterpret_cast<uint4*>(smem + c * BN * 16 + n * 16) = v;
  }
  for (int i = threadIdx.x; i < 2 * N; i += WG_THREADS) skey[i] = 0u;
  ring_init(full, QSTAGES);
  __syncthreads();

  // the unit count and the warp index read through a shuffle: the compiler
  // then knows they are the same across the warp, so the loop and the role
  // branches below are not divergent ones (a wgmma in flight across a
  // divergent branch is serialized by ptxas)
  const int n = UNIT_CHUNKS * (a.n_sblocks + __shfl_sync(0xffffffffu, __ldg(a.meta), 0));
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
    // two buffers, by the unit's parity: a warp may reach the next unit's end
    // while another still reads this one's, but not the one after (the
    // barrier between a unit's writes and reads holds it)
    uint32_t* red_both = red + wg * 2 * 4 * (N / 2);
    const uint32_t skey_wg = smem_u32(skey + wg * N);
    const uint32_t g_wg = g_s + wg * (N / 8) * 128;

    // the warpgroup's first column and subtile; this thread's epilogue
    // columns c = 2 * (thread in warpgroup) + h: column p of the tile, its
    // subtile among the warpgroup's and its bias (bf16-rounded when folded);
    // dead columns (p >= P, the last block's ragged edge) never count
    const int P2 = a.P / a.SUB;
    const int pw = p0 + wg * N;
    const int sub0 = pw / P2;
    // a warp's 64 columns start at a multiple of 64: where that divides the
    // subtile width they share a subtile (and are all live or all dead), so
    // one lane speaks for the warp
    const bool warp_shares = P2 % 64 == 0;
    int sub[2];
    float badd[2];
    bool live[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = pw + 2 * (threadIdx.x % 128) + h;
      live[h] = p < a.P;
      sub[h] = live[h] ? p / P2 - sub0 : 0;
      const float b = live[h] ? __ldg(bb + p) : 0.f;
      badd[h] = a.fold ? bf16_round(b) : b;
    }

    int run[RV];
#pragma unroll
    for (int i = 0; i < RV; ++i) run[i] = 0;  // the scores are sums of 0/1 products
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
      // the unit's spacer block and row group: data only, read early
      const int um = __ldg(a.meta + 1 + i / UNIT_CHUNKS);
      wgmma_wait_all();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + 8 * (i % QSTAGES));
      fold_rows(run, acc);
      // the next product runs while this warpgroup reduces a finished unit
      if (i + 1 < n) issue(i + 1);
      if ((i + 1) % UNIT_CHUNKS) continue;
      uint32_t* red_wg = red_both + (i / UNIT_CHUNKS & 1) * 4 * (N / 2);
      reduce_rows_pairs(run, red_wg, w4, lane);
      wg_bar(1 + wg);
      // the bias goes on after the max, exactly: folded, only rows of group 1
      // carry it. Then the max over each subtile's columns: over the warp
      // where it shares a subtile, over the warpgroup in shared memory
      const bool biased = !a.fold || (um & 1);
      const int u = threadIdx.x % 128;
      const uint32_t m = max_pairs(max_pairs(red_wg[u], red_wg[N / 2 + u]),
                                   max_pairs(red_wg[N + u], red_wg[3 * (N / 2) + u]));
      uint32_t key[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float score = (float)(h ? m >> 16 : m & 0xFFFFu);
        key[h] = live[h] ? order_key(score + (biased ? badd[h] : 0.f)) : 0u;
      }
      uint32_t* out_keys = a.keys + ((long long)t * a.SUB + sub0) * a.nsb_pad + (um >> 1);
      if (warp_shares) {  // (a uniform branch) one atomic per warp, from its lane 0
        const uint32_t warp_key = __reduce_max_sync(0xffffffffu, max(key[0], key[1]));
        global_max_if(out_keys + (long long)sub[0] * a.nsb_pad, warp_key,
                      lane == 0 && warp_key != 0u);
        continue;
      }
      // else over the warpgroup in shared memory, and after a barrier one
      // atomic per touched subtile of the warpgroup, and its key reset
      smem_max_if(skey_wg + 4 * sub[0], key[0], live[0]);
      smem_max_if(skey_wg + 4 * sub[1], key[1], live[1]);
      wg_bar(1 + wg);
#pragma unroll
      for (int h = 0; h < N / 128; ++h) {
        const int local = h * 128 + threadIdx.x % 128;  // a subtile of the warpgroup
        const uint32_t best = skey[wg * N + local];
        skey[wg * N + local] = 0u;
        global_max_if(out_keys + (long long)local * a.nsb_pad, best, best != 0u);
      }
    }
  }
}

// keys -> f32 in place; a key never touched (the lanes s >= n_sblocks) is the
// TPU kernel's initial value, -16384
__global__ void decode_keys_kernel(uint32_t* keys, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const uint32_t k = keys[i];
    keys[i] = __float_as_uint(k ? from_key(k) : -16384.0f);
  }
}

template <int KS>
int launch(const void* qc, const Args& a, int n_tiles, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(scan_max_kernel<KS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM<KS>);
  if (err != cudaSuccess) return (int)err;
  scan_max_kernel<KS><<<n_tiles * a.n_chunks, WG_THREADS, SMEM<KS>, stream>>>(
      static_cast<const uint8_t*>(qc), a);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the three kernels on `stream` and returns cudaGetLastError(): the
// units of q (contiguous (>= n_sblocks * 128, K) bf16) into qc (room for
// 2 * n_sblocks units of 128 x 32 KS bytes when fold, n_sblocks otherwise) and
// meta (1 + 2 * n_sblocks int32, zeroed), the block max into keys (the zeroed
// (n_tiles, SUB, nsb_pad) output buffer) and its decode to f32 in place. The
// Python wrapper checks shapes, types and limits (KS <= 4, fold only when
// 4L < K) before calling.
extern "C" int scan_block_max_launch(const void* q, void* qc, void* meta, const void* tiles,
                                     const void* bias, void* keys, int n_tiles, int n_sblocks,
                                     int nsb_pad, int K, int KS, int L, int P, int SUB,
                                     long long tile_w, int fold, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_keys = (long long)n_tiles * SUB * nsb_pad;
  if (n_keys == 0) return 0;
  if (n_sblocks > 0) {
    scan_max_units_kernel<<<n_sblocks, BS, 0, st>>>(
        static_cast<const uint16_t*>(q), static_cast<uint8_t*>(qc), static_cast<int32_t*>(meta),
        n_sblocks, K, L, KS, fold);
    const Args a{static_cast<const int32_t*>(meta), static_cast<const int32_t*>(tiles),
                 static_cast<const float*>(bias), static_cast<uint32_t*>(keys), tile_w,
                 n_sblocks, L, P, SUB, nsb_pad, fold, (P + BN - 1) / BN};
    int rc;
    switch (KS) {
      case 1: rc = launch<1>(qc, a, n_tiles, st); break;
      case 2: rc = launch<2>(qc, a, n_tiles, st); break;
      case 3: rc = launch<3>(qc, a, n_tiles, st); break;
      case 4: rc = launch<4>(qc, a, n_tiles, st); break;
      default: rc = (int)cudaErrorInvalidValue;
    }
    if (rc != 0) return rc;
  }
  const int blocks = (int)((n_keys + 255) / 256 < 1024 ? (n_keys + 255) / 256 : 1024);
  decode_keys_kernel<<<blocks, 256, 0, st>>>(static_cast<uint32_t*>(keys), n_keys);
  return (int)cudaGetLastError();
}
