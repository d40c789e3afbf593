// The phase-1 hit kernel's TPU ablations on the tensor cores, for NVIDIA
// Hopper (sm_90a): one bf16 mma.sync main loop, templated on where G comes
// from and on the epilogue.
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
// The main loop is mma_tile.cuh's: one thread block owns 256 columns of one
// tile for its whole life and walks every spacer block, so G is built (or
// loaded) once per (tile, column chunk), as the TPU built it once per tile
// at s == 0. BUILT stages the chunk's K / 4 + 256 codes and its 2 bias rows
// in shared memory, and each lane writes its own B fragments, in the mma
// layout, straight into registers: G[4j + b, p] = (code[p + j] == b),
// G[4L + i, p] = bf16(bias[i, p]), other rows 0. STREAM stages the chunk's
// K x 256 slab of the prebuilt G and packs the same fragments from it.
//
// The counts: the TPU reduced hit bits to subtile counts with a (1, P) x
// (P, SUB) matmul per step, or one (8, P) x (P, SUB) matmul per 8 steps. Here
// a lane owns 2 columns for the block's life, so COUNT adds each hit column
// to out[t, s, p / (P / SUB)] with an atomic as block s ends, and COUNT8
// keeps the hit bits of 8 blocks in a register and adds them when s % 8 == 7.
// As on the TPU (the output block was zeroed at s % 8 == 0 and written at
// s % 8 == 7), a last group of fewer than 8 blocks is never written: its
// rows stay zero. Counts are small integers, so the order of the atomic adds
// cannot change them.
//
// What bounds it on the H100: the tensor cores' mma.sync rate and the
// shared-memory reads of the Q fragments (every warp reads each staged Q
// chunk: 32 flops per byte of shared memory). Hits are rare
// (a 20-nt spacer within 3 mismatches of a random window), so the count
// epilogues cost a few shuffles and compares per column and block.

#include "mma_tile.cuh"

namespace {

using namespace mma_tile;

enum { COUNT = 0, COUNT8 = 1, COLMAX = 2, HIT = 3 };

constexpr int HALO = K / 4;  // codes beyond the chunk's last column
constexpr int BUILD_BYTES = (NC + HALO) * 4 + 2 * NC * 4;

template <int EPI>
struct Phase1Epi {
  void* out;
  float th;
  int t, p0, P, P2, SUB, n_sblocks, n_sb_pad8;
  uint32_t bits;  // COUNT8: bit 2k + j = column c + j of block 8m + k hit

  __device__ __forceinline__ void count(int s, int p, bool h0, bool h1) {
    float* o = static_cast<float*>(out) + ((size_t)t * n_sb_pad8 + s) * SUB;
    if (h0) atomicAdd(o + p / P2, 1.0f);
    if (h1) atomicAdd(o + (p + 1) / P2, 1.0f);
  }

  __device__ __forceinline__ void block(int s, int c, float v0, float v1) {
    const int p = p0 + c;  // even, and P is a multiple of 16
    if (p >= P) return;
    const bool h0 = v0 >= th, h1 = v1 >= th;
    if constexpr (EPI == COLMAX) {
      float* o = static_cast<float*>(out) + ((size_t)t * n_sblocks + s) * P + p;
      o[0] = v0;
      o[1] = v1;
    } else if constexpr (EPI == HIT) {
      uint8_t* o = static_cast<uint8_t*>(out) + ((size_t)t * n_sblocks + s) * P + p;
      o[0] = h0;
      o[1] = h1;
    } else if constexpr (EPI == COUNT) {
      count(s, p, h0, h1);
    } else {
      const int k = s % 8;
      bits |= (uint32_t(h0) | uint32_t(h1) << 1) << (2 * k);
      if (k == 7) {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          count(s - 7 + kk, p, (bits >> (2 * kk)) & 1u, (bits >> (2 * kk + 1)) & 1u);
        bits = 0u;
      }
    }
  }
};

// B fragments of G built from the tile's codes and its 2 bias rows.
__device__ __forceinline__ void build_b(const int32_t* __restrict__ codes,
                                        const float* __restrict__ bias, int tile_w, int L,
                                        int P, int p0, uint8_t* smem, BFrag<Bf16>& b) {
  int32_t* codes_s = reinterpret_cast<int32_t*>(smem);  // NC + HALO codes
  float* bias_s = reinterpret_cast<float*>(smem + (NC + HALO) * 4);  // 2 x NC
  for (int i = threadIdx.x; i < NC + HALO; i += THREADS)
    codes_s[i] = p0 + i < tile_w ? __ldg(codes + p0 + i) : 4;  // 4 = N: no match
  for (int i = threadIdx.x; i < 2 * NC; i += THREADS) {
    const int row = i / NC, p = p0 + i % NC;
    bias_s[i] = p < P ? __ldg(bias + (size_t)row * P + p) : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = frag_col(nt);
    const bool live = p0 + c < P;
#pragma unroll
    for (int ks = 0; ks < KSTEPS<Bf16>; ++ks) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int k0 = frag_k<Bf16>(ks, r);
        uint32_t v = 0u;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = k0 + e;
          uint32_t x = 0u;
          if (!live) {
          } else if (k < 4 * L) {
            x = codes_s[c + k / 4] == (k & 3) ? 0x3F80u : 0u;  // bf16 1.0
          } else if (k < 4 * L + 2) {
            x = __bfloat16_as_ushort(__float2bfloat16_rn(bias_s[(k - 4 * L) * NC + c]));
          }
          v |= x << (16 * e);
        }
        b[nt][ks][r] = v;
      }
    }
  }
  __syncthreads();
}

template <bool STREAM, int EPI>
__global__ void __launch_bounds__(THREADS, 2) phase1_mma_kernel(
    const float* __restrict__ thresh,  // (1,)
    const uint8_t* __restrict__ q,     // (n_sblocks * BS_M, 128) bf16
    const int32_t* __restrict__ tiles, // (n_tiles, 1, tile_w) codes (BUILT)
    const float* __restrict__ bias,    // (n_tiles, 2, P) (BUILT)
    const uint8_t* __restrict__ g_all, // (n_tiles, 128, P) bf16 (STREAM)
    void* __restrict__ out, int n_sblocks, int n_sb_pad8, int BS_M, int L, int P, int SUB,
    int tile_w) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int t = blockIdx.y;
  const int p0 = blockIdx.x * NC;
  BFrag<Bf16> b;
  if constexpr (STREAM)
    load_b_streamed<Bf16>(g_all + (size_t)t * K * P * 2, P, p0, smem, b);
  else
    build_b(tiles + (size_t)t * tile_w, bias + (size_t)t * 2 * P, tile_w, L, P, p0, smem, b);
  Phase1Epi<EPI> epi{out, __ldg(thresh), t, p0, P, P / SUB, SUB, n_sblocks, n_sb_pad8, 0u};
  scan_blocks<Bf16>(q, n_sblocks, BS_M, b, smem, epi);
}

template <bool STREAM, int EPI>
int launch(const void* thresh, const void* q, const void* tiles, const void* bias,
           const void* g_all, void* out, int n_tiles, int n_sblocks, int n_sb_pad8, int BS_M,
           int L, int P, int SUB, int tile_w, cudaStream_t stream) {
  constexpr int stage = STREAM ? STAGE_G_BYTES<Bf16> : BUILD_BYTES;
  constexpr int smem = stage > RING_BYTES<Bf16> ? stage : RING_BYTES<Bf16>;
  cudaError_t err = cudaFuncSetAttribute(phase1_mma_kernel<STREAM, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P + NC - 1) / NC, n_tiles);
  phase1_mma_kernel<STREAM, EPI><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(thresh), static_cast<const uint8_t*>(q),
      static_cast<const int32_t*>(tiles), static_cast<const float*>(bias),
      static_cast<const uint8_t*>(g_all), out, n_sblocks, n_sb_pad8, BS_M, L, P, SUB, tile_w);
  return (int)cudaGetLastError();
}

template <bool STREAM, class... Args>
int launch_epi(int epilogue, Args... args) {
  switch (epilogue) {
    case COUNT: return launch<STREAM, COUNT>(args...);
    case COUNT8: return launch<STREAM, COUNT8>(args...);
    case COLMAX: return launch<STREAM, COLMAX>(args...);
    case HIT: return launch<STREAM, HIT>(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch on `stream` and return cudaGetLastError(). stream_g: 0 = G built
// from tiles and bias, 1 = G read from g_all; epilogue: 0 = counts per
// block, 1 = counts batched over 8 blocks (both into a zeroed
// (n_tiles, n_sb_pad8, SUB) f32 out), 2 = column maxima ((n_tiles, n_sblocks,
// P) f32), 3 = hit bits ((n_tiles, n_sblocks, P) uint8). The Python wrapper
// checks the shapes, types and limits first (K = 128, 4L + 2 <= K, P % 16 ==
// 0, P % SUB == 0, BS_M % 16 == 0, tile_w >= P + L - 1, n_tiles <= 65535).
extern "C" int phase1_mma_launch(int stream_g, int epilogue, const void* thresh, const void* q,
                                 const void* tiles, const void* bias, const void* g_all,
                                 void* out, int n_tiles, int n_sblocks, int n_sb_pad8, int BS_M,
                                 int L, int P, int SUB, int tile_w, void* stream) {
  if (n_tiles == 0 || n_sblocks == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return stream_g ? launch_epi<true>(epilogue, thresh, q, tiles, bias, g_all, out, n_tiles,
                                     n_sblocks, n_sb_pad8, BS_M, L, P, SUB, tile_w, st)
                  : launch_epi<false>(epilogue, thresh, q, tiles, bias, g_all, out, n_tiles,
                                      n_sblocks, n_sb_pad8, BS_M, L, P, SUB, tile_w, st);
}
