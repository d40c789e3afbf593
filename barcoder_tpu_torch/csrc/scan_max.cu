// Phase-1 block max of the older sharded engine, for NVIDIA Hopper (sm_90a).
//
// Replaces barcoder_tpu/ops/pallas_scan.py::_scan_max_kernel (wrapper
// scan_block_max), whose only caller is the sharded block-max scan that the
// scaling harness times beside the flagship engine. For one genome tile t of
// P positions and one spacer block s of BS = 128 rows it computes
//
//     score[r, p]  = sum_j [q_r[j] == code[p + j]]       (N never matches)
//                    + the PAM/site bias of column p       (0 or -16384)
//     out[t, u, s] = max of score[r, p] over the block's rows r and the
//                    columns p of subtile u (P / SUB columns each)
//
// The TPU kernel gets the score as a one-hot bf16 matmul Q.G on the MXU. The
// scores are small integers, so this kernel computes the same numbers exactly
// with the integer formulation of scan_hits.cu: every spacer row and every
// genome column is packed into NW = ceil(4L / 32) words of one-hot nibbles
// (bit 4j + b set iff base j is b; N and the out-of-bounds code 5 set no
// bit), and score = sum_w popc(q_w & g_w).
//
// The bias needs no per-pair work:
//   * additive (no spare G row, or the caller's choice): every row sees the
//     same column bias, so it is added in f32 once per column after the max
//     over rows, as the TPU adds it before its max (f32 addition is monotone,
//     so the two orders give the same number);
//   * folded (4L < K): the TPU writes the bf16-rounded bias into G row 4L, so
//     a row's bias is Q[r, 4L] * bf16(bias[p]). Rows with the constant 1 get
//     the bias; rows without it (the engine's zero padding rows) get 0, so on
//     a masked column they score 0 and not -16384. The block therefore sorts
//     its rows into those two groups, takes the column max of the popcounts
//     per group and adds each group's bias once per column.
//
// What bounds it on the H100: the integer pipes, as for scan_hits (NW
// popcounts, NW ANDs, NW - 1 adds and one max per pair; 16 popcounts per clock
// per SM). The packed G columns and running maxima live in registers; every Q
// row is one broadcast 16-byte shared-memory load that serves COLS columns.
//
// The TPU grid ran in order, so its kernel built G once per tile (s == 0) and
// let step s rewrite lane s of the tile's whole output block. Here blocks run
// in any order: block (t, s) builds its own packed columns and alone owns the
// output lanes out[t, :, s], so it needs no atomics in device memory. The
// subtile maxima are reduced in shared memory: a float maps to an unsigned key
// with the same order, warps reduce with __reduce_max_sync and one lane per
// warp takes atomicMax, which gives the same maximum in any order. The wrapper
// fills the output with -16384, so the lanes s >= n_sblocks keep the TPU
// kernel's initial value.
//
// No tensor cores, TMA or wgmma: this is the simple, exact first kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BS = 128;  // spacer rows per block (the TPU kernel's MXU M dim)
constexpr int THREADS = 256;
constexpr int COLS = 8;  // columns per thread per pass

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ bool nonzero_bf16(uint16_t bits) {
  return (bits & 0x7FFFu) != 0u;  // -0.0 counts as zero
}

// float -> unsigned key with the same order (a < b iff key(a) < key(b))
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_key(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

template <int NW>
__global__ void __launch_bounds__(THREADS) scan_max_kernel(
    const uint16_t* __restrict__ q,     // (S_pad, K) bf16 bits, 0/1 values
    const int32_t* __restrict__ tiles,  // (n_tiles, 1, tile_w) codes
    const float* __restrict__ bias,     // (n_tiles, 1, P)
    float* __restrict__ out,            // (n_tiles, SUB, nsb_pad), -16384-filled
    int K, int L, int P, int SUB, int nsb_pad, int tile_w, int fold) {
  extern __shared__ uint4 smem[];
  uint4* q_rows = smem;                                        // BS rows, grouped
  uint32_t* sub_key = reinterpret_cast<uint32_t*>(smem + BS);  // SUB keys
  __shared__ int grp_count[2];
  __shared__ int grp_fill[2];

  const int t = blockIdx.x;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const uint16_t* qb = q + (long long)s * BS * K;

  if (tid < 2) {
    grp_count[tid] = 0;
    grp_fill[tid] = 0;
  }
  for (int u = tid; u < SUB; u += THREADS) sub_key[u] = 0u;
  __syncthreads();

  // group 1: the row carries the folded bias column 4L
  auto group = [&](int r) -> int {
    return (fold && nonzero_bf16(qb[(long long)r * K + 4 * L])) ? 1 : 0;
  };
  for (int r = tid; r < BS; r += THREADS) atomicAdd(&grp_count[group(r)], 1);
  __syncthreads();
  for (int r = tid; r < BS; r += THREADS) {
    const uint16_t* row = qb + (long long)r * K;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    for (int c = 0; c < 4 * L; ++c)
      if (nonzero_bf16(row[c])) w[c >> 5] |= 1u << (c & 31);
    const int g = group(r);
    const int slot = (g ? grp_count[0] : 0) + atomicAdd(&grp_fill[g], 1);
    q_rows[slot] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  __syncthreads();

  const int P2 = P / SUB;
  const bool warp_in_one_subtile = (P2 % 32) == 0;
  const int32_t* tb = tiles + (long long)t * tile_w;
  const float* bb = bias + (long long)t * P;

  for (int c0 = 0; c0 < P; c0 += THREADS * COLS) {
    uint32_t g[COLS][NW];
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const int p = c0 + k * THREADS + tid;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        uint32_t word = 0u;
        if (p < P) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = 8 * w + jj;
            if (j < L) {
              const int c = __ldg(tb + j + p);
              if ((unsigned)c < 4u) word |= 1u << (4 * jj + c);
            }
          }
        }
        g[k][w] = word;
      }
    }

    float best[COLS];
#pragma unroll
    for (int k = 0; k < COLS; ++k) best[k] = __int_as_float(0xff800000);  // -inf

    for (int grp = 0; grp < 2; ++grp) {
      const int n = grp_count[grp];
      if (n == 0) continue;
      const int r0 = grp ? grp_count[0] : 0;
      int m[COLS];
#pragma unroll
      for (int k = 0; k < COLS; ++k) m[k] = 0;
#pragma unroll 2
      for (int r = r0; r < r0 + n; ++r) {
        const uint4 qv = q_rows[r];
        const uint32_t qw[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
        for (int k = 0; k < COLS; ++k) {
          int sc = 0;
#pragma unroll
          for (int w = 0; w < NW; ++w) sc += __popc(qw[w] & g[k][w]);
          m[k] = max(m[k], sc);
        }
      }
#pragma unroll
      for (int k = 0; k < COLS; ++k) {
        const int p = c0 + k * THREADS + tid;
        if (p < P) {
          const float b = fold ? (grp ? bf16_round(bb[p]) : 0.f) : bb[p];
          best[k] = fmaxf(best[k], (float)m[k] + b);
        }
      }
    }

#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const int p = c0 + k * THREADS + tid;
      if (warp_in_one_subtile) {
        // the warp's 32 columns start at a multiple of 32, so they are all
        // in range or all out, and all in one subtile
        if (c0 + k * THREADS + (tid & ~31) < P) {
          const uint32_t key = __reduce_max_sync(0xffffffffu, order_key(best[k]));
          if ((tid & 31) == 0) atomicMax(&sub_key[p / P2], key);
        }
      } else if (p < P) {
        atomicMax(&sub_key[p / P2], order_key(best[k]));
      }
    }
  }
  __syncthreads();

  for (int u = tid; u < SUB; u += THREADS)
    out[((long long)t * SUB + u) * nsb_pad + s] = from_key(sub_key[u]);
}

template <int NW>
void launch(dim3 grid, size_t smem, cudaStream_t stream, const void* q,
            const void* tiles, const void* bias, void* out, int K, int L, int P,
            int SUB, int nsb_pad, int tile_w, int fold) {
  scan_max_kernel<NW><<<grid, THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const int32_t*>(tiles),
      static_cast<const float*>(bias), static_cast<float*>(out), K, L, P, SUB,
      nsb_pad, tile_w, fold);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(). The Python
// wrapper checks shapes, types and limits (L <= 32, SUB <= 8192,
// n_sblocks <= 65535, fold only when 4L < K) and fills `out` before calling.
extern "C" int scan_block_max_launch(const void* q, const void* tiles,
                                     const void* bias, void* out, int n_tiles,
                                     int n_sblocks, int nsb_pad, int K, int L,
                                     int P, int SUB, int tile_w, int fold,
                                     void* stream) {
  if (n_tiles == 0 || n_sblocks == 0) return 0;
  const dim3 grid(n_tiles, n_sblocks);
  const size_t smem = BS * sizeof(uint4) + (size_t)SUB * sizeof(uint32_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((4 * L + 31) / 32) {
    case 1:
      launch<1>(grid, smem, st, q, tiles, bias, out, K, L, P, SUB, nsb_pad, tile_w, fold);
      break;
    case 2:
      launch<2>(grid, smem, st, q, tiles, bias, out, K, L, P, SUB, nsb_pad, tile_w, fold);
      break;
    case 3:
      launch<3>(grid, smem, st, q, tiles, bias, out, K, L, P, SUB, nsb_pad, tile_w, fold);
      break;
    case 4:
      launch<4>(grid, smem, st, q, tiles, bias, out, K, L, P, SUB, nsb_pad, tile_w, fold);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
