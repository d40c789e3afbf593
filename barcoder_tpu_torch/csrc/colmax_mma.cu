// Column max of a 0/1 matrix product on the tensor cores, for NVIDIA Hopper
// (sm_90a), in int8 and in bf16.
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
// Design: mma_tile.cuh's main loop with G streamed. One thread block owns
// 256 columns of one tile, stages their K x 256 slab of G once, keeps it as
// B fragments in registers, and streams every row of Q past it through a
// cp.async ring; int8 runs mma.sync m16n8k32 (s8.s8.s32), bf16 runs
// m16n8k16 (bf16.bf16.f32). Blocks walk (column chunk, tile) with the chunks
// of one tile adjacent, and Q (at most a few MB) stays in L2.
//
// What bounds it on the H100: the tensor cores' mma.sync rate and the
// shared-memory reads of the A fragments (every warp reads each staged Q
// chunk: 32 flops per byte of shared memory). The output is 4 bytes per
// (block, column), small beside the 2 * BS_M * K operations behind it.

#include "mma_tile.cuh"

namespace {

using namespace mma_tile;

template <class Acc>
struct StoreColmax {
  Acc* out;  // (n_tiles, n_sblocks, P)
  int n_sblocks, P, t, p0;
  __device__ __forceinline__ void block(int s, int c, Acc v0, Acc v1) {
    const int p = p0 + c;  // even, and P is a multiple of 16
    if (p < P) {
      Acc* o = out + ((size_t)t * n_sblocks + s) * P + p;
      o[0] = v0;
      o[1] = v1;
    }
  }
};

template <class E>
__global__ void __launch_bounds__(THREADS, 2) colmax_mma_kernel(
    const uint8_t* __restrict__ q,  // (n_sblocks * BS_M, 128)
    const uint8_t* __restrict__ g,  // (n_tiles, 128, P)
    typename E::Acc* __restrict__ out, int n_sblocks, int BS_M, int P) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int t = blockIdx.y;
  const int p0 = blockIdx.x * NC;
  BFrag<E> b;
  load_b_streamed<E>(g + (size_t)t * K * P * E::BYTES, P, p0, smem, b);
  StoreColmax<typename E::Acc> epi{out, n_sblocks, P, t, p0};
  scan_blocks<E>(q, n_sblocks, BS_M, b, smem, epi);
}

template <class E>
int launch(const void* q, const void* g, void* out, int n_tiles, int n_sblocks, int BS_M,
           int P, cudaStream_t stream) {
  const int smem = STAGE_G_BYTES<E> > RING_BYTES<E> ? STAGE_G_BYTES<E> : RING_BYTES<E>;
  cudaError_t err = cudaFuncSetAttribute(colmax_mma_kernel<E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P + NC - 1) / NC, n_tiles);
  colmax_mma_kernel<E><<<grid, THREADS, smem, stream>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(g),
      static_cast<typename E::Acc*>(out), n_sblocks, BS_M, P);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream` and return cudaGetLastError(). The Python wrapper
// checks what the kernel assumes: contiguous (S, 128) Q and (n_tiles, 128, P)
// G of the same type, P % 16 == 0, BS_M % 16 == 0, n_tiles <= 65535.
extern "C" int colmax_int8_launch(const void* q, const void* g, void* out, int n_tiles,
                                  int n_sblocks, int BS_M, int P, void* stream) {
  if (n_tiles == 0 || n_sblocks == 0) return 0;
  return launch<S8>(q, g, out, n_tiles, n_sblocks, BS_M, P, static_cast<cudaStream_t>(stream));
}

extern "C" int colmax_bf16_launch(const void* q, const void* g, void* out, int n_tiles,
                                  int n_sblocks, int BS_M, int P, void* stream) {
  if (n_tiles == 0 || n_sblocks == 0) return 0;
  return launch<Bf16>(q, g, out, n_tiles, n_sblocks, BS_M, P,
                      static_cast<cudaStream_t>(stream));
}
