// Phase-1 Hamming-scan hit indicator for NVIDIA Hopper (sm_90a).
//
// Replaces barcoder_tpu/ops/pallas_scan.py::_scan_hits_kernel (wrapper
// scan_block_hits). For one genome tile t of P positions and one spacer
// block s of BS_M rows it computes
//
//     score[r, p] = sum_j [q_r[j] == code[p + j]]        (N never matches)
//                   + the PAM/site bias of column p        (0 or -16384)
//     hit[p]      = max_r score[r, p] >= thresh            (thresh = L - v)
//     out[t, s, u] = number of hit columns in subtile u    (P / SUB columns each)
//
// The TPU kernel gets the score as a one-hot bf16 matmul Q.G on the MXU. The
// scores are small integers (at most 32), so this kernel computes the same
// numbers exactly with integer bit operations instead:
//
//   * every spacer row is packed once per block into NW = ceil(4L / 32)
//     32-bit words of one-hot nibbles (bit 4j + b set iff base j is b; N sets
//     no bit), straight from the one-hot bf16 Q rows the engine already holds;
//   * every genome column is packed the same way from its L codes (codes 4 =
//     N and 5 = out of bounds set no bit);
//   * score = sum_w popc(q_w & g_w). Bit-equal to the f32 accumulation of the
//     0/1 bf16 products.
//
// The bias needs no per-pair work. A row's bias depends only on which of its
// constant bias columns (4L, 4L+1) are set, so the block sorts its rows into
// at most four such groups, takes the column max of the popcounts per group,
// and adds the group's bias (the bf16-rounded bias rows, as the TPU folds
// them into G) once per column. In the additive mode (no spare G row, L = 32)
// every row is in group 0 and the f32 bias row is added the same way.
//
// What bounds it on the H100: the integer pipes. Each (spacer, position) pair
// costs NW popcounts (16 per clock per SM on sm_90), NW ANDs, NW - 1 adds and
// one max; memory traffic is a few bytes per position per spacer block and
// lives in L2. Each thread keeps COLS columns' packed words and running
// maxima in registers, and every Q row is a broadcast 16-byte shared-memory
// load that serves those COLS columns.
//
// The TPU grid ran in order, so its kernel built G once per tile (s == 0) and
// let block s own output row s % 8 of a shared 8-row output block. Here blocks
// run in any order: block (t, s) builds its own packed columns, owns output
// row (t, s) alone and adds its subtile counts there with shared-nothing
// atomics (only this block touches the row, and the counts are integers, so
// the order of the adds cannot change the result). The wrapper zeroes the
// output, which also zeroes the pad rows n_sblocks..n_sb_pad8.
//
// No tensor cores, TMA or wgmma yet: an int8 mma formulation is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int COLS = 8;  // columns per thread per pass

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ bool nonzero_bf16(uint16_t bits) {
  return (bits & 0x7FFFu) != 0u;  // -0.0 counts as zero
}

template <int NW>
__global__ void __launch_bounds__(THREADS) scan_hits_kernel(
    const float* __restrict__ thresh,     // (1,)
    const uint16_t* __restrict__ q,       // (S_pad, K) bf16 bits, 0/1 values
    const int32_t* __restrict__ tiles,    // codes, see tile/code strides
    const float* __restrict__ bias,       // (n_tiles, bias_rows, P)
    float* __restrict__ out,              // (n_tiles, n_sb_pad8, SUB), zeroed
    int K, int L, int P, int SUB, int BS_M, int n_sb_pad8,
    long long tile_stride, long long code_stride, int bias_rows, int fold) {
  extern __shared__ uint4 q_rows[];  // BS_M packed rows, grouped by bias pattern
  __shared__ int grp_count[4];
  __shared__ int grp_start[4];
  __shared__ int grp_fill[4];

  const int t = blockIdx.x;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const uint16_t* qb = q + (long long)s * BS_M * K;

  if (tid < 4) {
    grp_count[tid] = 0;
    grp_fill[tid] = 0;
  }
  __syncthreads();

  // bias pattern of a row: bit i set iff its constant column 4L + i is set
  auto pattern = [&](int r) -> int {
    if (!fold) return 0;
    const uint16_t* row = qb + (long long)r * K + 4 * L;
    int pat = nonzero_bf16(row[0]) ? 1 : 0;
    if (bias_rows > 1 && nonzero_bf16(row[1])) pat |= 2;
    return pat;
  };

  for (int r = tid; r < BS_M; r += THREADS) atomicAdd(&grp_count[pattern(r)], 1);
  __syncthreads();
  if (tid == 0) {
    grp_start[0] = 0;
    for (int g = 1; g < 4; ++g) grp_start[g] = grp_start[g - 1] + grp_count[g - 1];
  }
  __syncthreads();
  for (int r = tid; r < BS_M; r += THREADS) {
    const uint16_t* row = qb + (long long)r * K;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    for (int c = 0; c < 4 * L; ++c)
      if (nonzero_bf16(row[c])) w[c >> 5] |= 1u << (c & 31);
    const int pat = pattern(r);
    const int slot = grp_start[pat] + atomicAdd(&grp_fill[pat], 1);
    q_rows[slot] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  __syncthreads();

  const float th = __ldg(thresh);
  const int P2 = P / SUB;
  const int32_t* tb = tiles + (long long)t * tile_stride;
  const float* bb = bias + (long long)t * bias_rows * P;
  float* ob = out + ((long long)t * n_sb_pad8 + s) * SUB;

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
              const int c = __ldg(tb + (long long)j * code_stride + p);
              if ((unsigned)c < 4u) word |= 1u << (4 * jj + c);
            }
          }
        }
        g[k][w] = word;
      }
    }

    float colmax[COLS];
#pragma unroll
    for (int k = 0; k < COLS; ++k) colmax[k] = __int_as_float(0xff800000);  // -inf

    for (int grp = 0; grp < 4; ++grp) {
      const int n = grp_count[grp];
      if (n == 0) continue;
      const int r0 = grp_start[grp];
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
          float b;
          if (fold) {
            b = 0.f;
            if (grp & 1) b += bf16_round(bb[p]);
            if (grp & 2) b += bf16_round(bb[P + p]);
          } else {
            b = bb[p];
          }
          colmax[k] = fmaxf(colmax[k], (float)m[k] + b);
        }
      }
    }

#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const int p = c0 + k * THREADS + tid;
      if (p < P && colmax[k] >= th) atomicAdd(ob + p / P2, 1.0f);
    }
  }
}

template <int NW>
void launch(dim3 grid, size_t smem, cudaStream_t stream, const void* thresh,
            const void* q, const void* tiles, const void* bias, void* out, int K,
            int L, int P, int SUB, int BS_M, int n_sb_pad8, long long tile_stride,
            long long code_stride, int bias_rows, int fold) {
  scan_hits_kernel<NW><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(thresh), static_cast<const uint16_t*>(q),
      static_cast<const int32_t*>(tiles), static_cast<const float*>(bias),
      static_cast<float*>(out), K, L, P, SUB, BS_M, n_sb_pad8, tile_stride,
      code_stride, bias_rows, fold);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(). The Python
// wrapper checks shapes, types and limits (L <= 32, bias_rows <= 2,
// BS_M <= 2048, n_sblocks <= 65535) before calling.
extern "C" int scan_block_hits_launch(
    const void* thresh, const void* q, const void* tiles, const void* bias,
    void* out, int n_tiles, int n_sblocks, int n_sb_pad8, int K, int L, int P,
    int SUB, int BS_M, long long tile_stride, long long code_stride,
    int bias_rows, int fold, void* stream) {
  if (n_tiles == 0 || n_sblocks == 0) return 0;
  const dim3 grid(n_tiles, n_sblocks);
  const size_t smem = (size_t)BS_M * sizeof(uint4);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((4 * L + 31) / 32) {
    case 1:
      launch<1>(grid, smem, st, thresh, q, tiles, bias, out, K, L, P, SUB, BS_M,
                n_sb_pad8, tile_stride, code_stride, bias_rows, fold);
      break;
    case 2:
      launch<2>(grid, smem, st, thresh, q, tiles, bias, out, K, L, P, SUB, BS_M,
                n_sb_pad8, tile_stride, code_stride, bias_rows, fold);
      break;
    case 3:
      launch<3>(grid, smem, st, thresh, q, tiles, bias, out, K, L, P, SUB, BS_M,
                n_sb_pad8, tile_stride, code_stride, bias_rows, fold);
      break;
    case 4:
      launch<4>(grid, smem, st, thresh, q, tiles, bias, out, K, L, P, SUB, BS_M,
                n_sb_pad8, tile_stride, code_stride, bias_rows, fold);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
