// Column max of a 0/1 matrix product on the tensor cores, for NVIDIA Hopper
// (sm_90a), in int8 and in bf16, with wgmma.
//
// Replaces experiments/int8_bench.py::kern, the TPU microbenchmark that put
// the phase-1 product Q.G on the MXU in int8 (int8 x int8 -> int32) and in
// bf16 (bf16 x bf16 -> f32):
//
//     out[t, s, p] = max over the BS_M rows r of spacer block s of
//                    sum_k Q[s * BS_M + r, k] * G[t, k, p]
//
// for every genome tile t and column p. The TPU kernel stored only lanes
// 0..127 of each (t, s) row; this kernel writes every column (the full
// (n_tiles, n_sblocks, P) array), so it does all of the product the TPU
// kernel did, and the wrapper (ops/colmax_mma.py) takes the TPU's slice.
//
// Design: the main loop of scan_hits.cu (wgmma_tile.cuh), with G streamed.
// A thread block owns 512 columns of one tile for its life and walks every
// spacer block. Two consumer warpgroups run wgmma.mma_async m64n256k32
// s32.s8.s8 (int8) or m64n256k16 f32.bf16.bf16 (bf16), both operands read
// from shared memory by the tensor cores; a producer thread keeps a ring of
// 64-row Q chunks full with one bulk copy each (8 stages of 8 KB in int8, 4
// of 16 KB in bf16, beside a 64 KB and a 128 KB slab of G); the column max
// over a block's rows comes from the accumulator registers, and every column
// of out[t, s, :] is written as the block ends.
//
//   * G arrives (K, P) with P contiguous, which is MN-major for wgmma's B
//     operand. The int8 form takes B K-major only, so the block transposes
//     its K x 512 slab while staging it: a thread reads 16 (int8) or 8 (bf16)
//     rows of 4 bytes, transposes the bytes (or halves) with __byte_perm and
//     stores each column's 16-byte K piece. bf16 is staged the same way, and
//     its wgmma reads B K-major too (transpose flags 0), so one descriptor
//     scheme serves both types: 32 bytes of K a step, 4 steps in int8, 8 in
//     bf16.
//   * Q is (S, 128) row-major: K-major, but not in core-matrix order. The
//     wrapper lays it out as the 64-row chunks of wgmma_tile.cuh inside every
//     call (a copy of a few MB, part of the kernel's time), padding a spacer
//     block to a multiple of 64 rows by repeating its last row, which leaves
//     a max as it is.
//
// What bounds it on the H100: the tensor rate of the type (2 * K operations
// a pair); the output is 4 bytes per (block, column), small beside the
// 2 * BS_M * K operations behind it.

#include "wgmma_tile.cuh"

namespace {

using namespace wgmma_tile;

constexpr int K = 128;  // contraction depth (elements)

struct S8 {
  using Acc = int;
  static constexpr int BYTES = 1, STAGES = 8;
};
struct Bf16 {
  using Acc = float;
  static constexpr int BYTES = 2, STAGES = 4;
};

template <class E> constexpr int KS = K * E::BYTES / 32;  // k-steps of 32 bytes
template <class E> constexpr int G_BYTES = BN * KS<E> * 32;
template <class E> constexpr int CHUNK_BYTES = CHUNK * KS<E> * 32;
template <class E> constexpr int RED_OFF = G_BYTES<E> + E::STAGES * CHUNK_BYTES<E>;
template <class E> constexpr int BAR_OFF = RED_OFF<E> + 2 * 4 * N * 4;
template <class E> constexpr int SMEM = BAR_OFF<E> + 2 * E::STAGES * 8;

__device__ __forceinline__ uint32_t bits(int v) { return (uint32_t)v; }
__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }

// qc: Q with its spacer blocks padded to BS64 rows (a multiple of 64), laid
// out by the wrapper as chunks of 64 rows (wgmma_tile.cuh).
template <class E>
__global__ void __launch_bounds__(WG_THREADS, 1)
    colmax_mma_kernel(const uint8_t* __restrict__ qc, const uint8_t* __restrict__ g,
                      typename E::Acc* __restrict__ out, int n_sblocks, int BS64, int P,
                      int n_chunks) {
  using Acc = typename E::Acc;
  constexpr int STAGES = E::STAGES;
  extern __shared__ __align__(1024) uint8_t smem[];
  const int t = blockIdx.x / n_chunks;
  const int p0 = (blockIdx.x % n_chunks) * BN;
  const uint32_t g_s = smem_u32(smem);
  const uint32_t q_s = g_s + G_BYTES<E>;
  Acc* red = reinterpret_cast<Acc*>(smem + RED_OFF<E>);
  const uint32_t full = g_s + BAR_OFF<E>, empty = full + STAGES * 8;

  stage_g<E::BYTES, KS<E>>(g + (size_t)t * K * P * E::BYTES, P, p0, smem);
  ring_init(full, STAGES);
  __syncthreads();

  const int cpb = BS64 / CHUNK;
  const int n = n_sblocks * cpb;
  // the warp index read through a shuffle: the compiler then knows it is the
  // same across the warp, so the role branches below are not divergent ones
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), lane = threadIdx.x % 32;

  if (warp >= 8) {  // producer: one thread keeps the ring of Q chunks full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0)
      for (int i = 0; i < n; ++i) {
        const int slot = i % STAGES;
        mbar_wait(empty + 8 * slot, ((i / STAGES) & 1) ^ 1);
        bulk_load(q_s + slot * CHUNK_BYTES<E>, qc + (size_t)i * CHUNK_BYTES<E>, CHUNK_BYTES<E>,
                  full + 8 * slot);
      }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp / 4, w4 = warp % 4;
    Acc* red_wg = red + wg * 4 * N;
    const uint32_t g_wg = g_s + wg * (N / 8) * 128;

    Acc run[RV];
#pragma unroll
    for (int i = 0; i < RV; ++i) run[i] = lowest(Acc());
    Acc acc[N / 2];
    auto issue = [&](int i) {
      const int slot = i % STAGES;
      mbar_wait(full + 8 * slot, (i / STAGES) & 1);
      const uint32_t qa = q_s + slot * CHUNK_BYTES<E>;
      wgmma_fence();  // after the row max's reads of acc
#pragma unroll
      for (int ks = 0; ks < KS<E>; ++ks)
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
      // the next product runs while this warpgroup writes a finished block
      if (i + 1 < n) issue(i + 1);
      if ((i + 1) % cpb) continue;
      reduce_rows(run, red_wg, w4, lane);
      wg_bar(1 + wg);
      Acc* out_row = out + ((size_t)t * n_sblocks + i / cpb) * P;
#pragma unroll
      for (int h = 0; h < N / 128; ++h) {
        const int c = h * 128 + threadIdx.x % 128;
        const int p = p0 + wg * N + c;
        store_if(out_row + p, bits(column_max(red_wg, c)), p < P);
      }
      wg_bar(1 + wg);
    }
  }
}

template <class E>
int launch(const void* qc, const void* g, void* out, int n_tiles, int n_sblocks, int BS_M,
           int P, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(colmax_mma_kernel<E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM<E>);
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = (P + BN - 1) / BN;
  const int BS64 = (BS_M + CHUNK - 1) / CHUNK * CHUNK;
  colmax_mma_kernel<E><<<n_tiles * n_chunks, WG_THREADS, SMEM<E>, stream>>>(
      static_cast<const uint8_t*>(qc), static_cast<const uint8_t*>(g),
      static_cast<typename E::Acc*>(out), n_sblocks, BS64, P, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream` and return cudaGetLastError(). qc is Q as the wrapper
// lays it out (see colmax_mma_kernel), g the contiguous (n_tiles, 128, P)
// array of the same type, 16-byte aligned. The Python wrapper checks what the
// kernel assumes: K = 128, P % 16 == 0, BS_M % 16 == 0.
extern "C" int colmax_int8_launch(const void* qc, const void* g, void* out, int n_tiles,
                                  int n_sblocks, int BS_M, int P, void* stream) {
  if (n_tiles == 0 || n_sblocks == 0) return 0;
  return launch<S8>(qc, g, out, n_tiles, n_sblocks, BS_M, P, static_cast<cudaStream_t>(stream));
}

extern "C" int colmax_bf16_launch(const void* qc, const void* g, void* out, int n_tiles,
                                  int n_sblocks, int BS_M, int P, void* stream) {
  if (n_tiles == 0 || n_sblocks == 0) return 0;
  return launch<Bf16>(qc, g, out, n_tiles, n_sblocks, BS_M, P,
                      static_cast<cudaStream_t>(stream));
}
