// Tensor-core main loop of phase1_mma.cu: the column maxima of Q.G over the
// rows of every spacer block, for the 256 genome columns that one thread
// block owns, with mma.sync on sm_90a. (colmax_mma.cu stood on it too until
// it moved to wgmma, see wgmma_tile.cuh; the element type stays a template
// parameter, bf16 its one instance.)
//
//   Q  (n_sblocks * BS_M, K = 128) row-major bf16, in device memory;
//   G  (K, P) for one genome tile, held by the block as B fragments in
//      registers for its whole life (the caller fills them, from a streamed G
//      or from codes: see load_b_streamed and phase1_mma.cu).
//
// Layout of the work. A block of 8 warps owns NC = 256 columns of one tile;
// warp w owns columns 32w..32w+31, as 4 n8 tiles whose B fragments for all
// of K (8 k-steps) stay in 64 registers. The block
// then walks every spacer block s in order, and every row of it, in chunks of
// MR = 64 rows that a 3-stage cp.async ring brings from device memory into
// shared memory (rows padded by 16 bytes, so the ldmatrix phases hit 8
// distinct bank groups). Each warp multiplies every chunk by its columns
// (4 m16 tiles x KSTEPS x 4 n8 tiles of mma.sync per chunk) and folds the
// 16 x 8 results into running column maxima at once, so only 16 accumulator
// registers live at a time. At the end of block s the maxima are reduced
// across the 8 row groups of the warp with three shuffles and handed to the
// epilogue, which sees every column of every block: nothing is computed only
// for the lanes the TPU kernel happened to store.
//
// Why this order: G is read (or built) once per (tile, column chunk) and
// never again, as on the TPU where blocks were the inner grid axis; the
// whole Q (5 MB at the phase-1 benchmarks' size) stays in the 50 MB L2, and
// each block streams it once. A block's row max needs no atomics: one block
// sees every row of every spacer block for its columns.
//
// Exactness: the products are 0/1 (and the folded bias, 0 or -16384, times
// 1), and f32 accumulation of integers below 2^24 is exact in any order.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace mma_tile {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int NT = 4;                  // n8 tiles per warp: 32 columns
constexpr int NC = WARPS * NT * 8;     // columns per thread block
constexpr int K = 128;                 // contraction depth (elements)
constexpr int MR = 64;                 // Q rows per pipeline stage
constexpr int STAGES = 3;

struct Bf16 {
  using Acc = float;
  static constexpr int BYTES = 2;
};

template <class E> constexpr int KB = K * E::BYTES;       // bytes of a Q row
template <class E> constexpr int RS = KB<E> + 16;         // padded smem row
template <class E> constexpr int KSTEPS = KB<E> / 32;     // mma k-steps of 32 bytes
template <class E> constexpr int EPR = 4 / E::BYTES;      // elements per 32-bit register
template <class E> constexpr int RING_BYTES = STAGES * MR * RS<E>;
template <class E> constexpr int STAGE_G_BYTES = K * NC * E::BYTES;

template <class E> using BFrag = uint32_t[NT][KSTEPS<E>][2];

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// D += A.B for one m16 x n8 tile: bf16 x bf16 -> f32, k = 16
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float lowest(float) { return -INFINITY; }

// The block-local column c (0..NC-1) and k-offset of register r of B
// fragment (nt, ks) for this lane: mma's B operand is K x 8 "col", lane
// (g = lane / 4, q = lane % 4) holds column g and EPR consecutive k from
// ks * 32 bytes + r * 16 bytes + q * 4 bytes.
__device__ __forceinline__ int frag_col(int nt) {
  return (threadIdx.x / 32) * (NT * 8) + nt * 8 + (threadIdx.x % 32) / 4;
}
template <class E>
__device__ __forceinline__ int frag_k(int ks, int r) {
  return (ks * 32 + r * 16 + (threadIdx.x % 4) * 4) / E::BYTES;
}

// Fill b from a streamed G tile: g_tile points at G[0, 0] of one tile,
// row-major (K, P) with P % 16 == 0. The block's K x NC slab is staged in
// shared memory (coalesced cp.async; columns >= P are zero) and each lane
// packs its fragments from it. Ends with a barrier: smem is free again.
template <class E>
__device__ __forceinline__ void load_b_streamed(const uint8_t* g_tile, int P, int p0,
                                                uint8_t* smem, BFrag<E>& b) {
  constexpr int ROW = NC * E::BYTES;  // staged row: NC columns of one k
  constexpr int PIECES = ROW / 16;
  constexpr int PER = 16 / E::BYTES;  // columns per 16-byte piece
  for (int idx = threadIdx.x; idx < K * PIECES; idx += THREADS) {
    const int k = idx / PIECES, c = idx % PIECES;
    uint8_t* dst = smem + k * ROW + c * 16;
    if (p0 + c * PER < P)
      cp_async16(smem_u32(dst), g_tile + ((size_t)k * P + p0 + c * PER) * E::BYTES);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = frag_col(nt);
#pragma unroll
    for (int ks = 0; ks < KSTEPS<E>; ++ks) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int k0 = frag_k<E>(ks, r);
        uint32_t v = 0u;
#pragma unroll
        for (int e = 0; e < EPR<E>; ++e) {
          uint32_t x;
          if (E::BYTES == 2)
            x = reinterpret_cast<const uint16_t*>(smem)[(k0 + e) * NC + c];
          else
            x = smem[(k0 + e) * NC + c];
          v |= x << (8 * E::BYTES * e);
        }
        b[nt][ks][r] = v;
      }
    }
  }
  __syncthreads();
}

// Walk every spacer block of Q against the B fragments; for each block s
// call epi.block(s, c, v0, v1) once per pair of columns (c, c + 1) of the
// block's NC, with their maxima over the block's BS_M rows (BS_M % 16 == 0).
// smem must hold RING_BYTES<E>.
template <class E, class Epi>
__device__ __forceinline__ void scan_blocks(const uint8_t* __restrict__ q, int n_sblocks,
                                            int BS_M, const BFrag<E>& b, uint8_t* smem,
                                            Epi& epi) {
  using Acc = typename E::Acc;
  constexpr int PIECES = KB<E> / 16;
  const int lane = threadIdx.x % 32;
  const int cpb = (BS_M + MR - 1) / MR;  // chunks per spacer block
  const int n = n_sblocks * cpb;

  auto load_chunk = [&](int i) {
    const int s = i / cpb, r0 = (i % cpb) * MR, rows = min(MR, BS_M - r0);
    const uint8_t* src = q + ((size_t)s * BS_M + r0) * KB<E>;
    uint8_t* dst = smem + (i % STAGES) * MR * RS<E>;
    for (int idx = threadIdx.x; idx < rows * PIECES; idx += THREADS) {
      const int r = idx / PIECES, c = idx % PIECES;
      cp_async16(smem_u32(dst + r * RS<E> + c * 16), src + (size_t)r * KB<E> + c * 16);
    }
  };

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n) load_chunk(st);
    cp_async_commit();
  }

  Acc run[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) run[nt][0] = run[nt][1] = lowest(Acc());

  // ldmatrix.x4 row address of this lane: matrices (rows 0-7 | 8-15) x
  // (bytes 0-15 | 16-31) of a 16 x 32-byte A tile, in mma's a0..a3 order
  const int a_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * RS<E> + (lane >> 4) * 16;

  for (int i = 0; i < n; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk i landed for every thread; slot (i-1) % STAGES is free
    if (i + STAGES - 1 < n) load_chunk(i + STAGES - 1);
    cp_async_commit();

    const int s = i / cpb, r0 = (i % cpb) * MR, rows = min(MR, BS_M - r0);
    const uint32_t slot = smem_u32(smem + (i % STAGES) * MR * RS<E>) + a_off;
    for (int mt = 0; mt < rows / 16; ++mt) {
      Acc acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0;
#pragma unroll
      for (int ks = 0; ks < KSTEPS<E>; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, slot + mt * 16 * RS<E> + ks * 32);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma(acc[nt], a, b[nt][ks][0], b[nt][ks][1]);
      }
      // rows g and g + 8 of columns 2q and 2q + 1 of each n8 tile
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        run[nt][0] = max(run[nt][0], max(acc[nt][0], acc[nt][2]));
        run[nt][1] = max(run[nt][1], max(acc[nt][1], acc[nt][3]));
      }
    }

    if (r0 + rows == BS_M) {  // the last chunk of spacer block s
      Acc v0 = 0, v1 = 0;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            run[nt][j] = max(run[nt][j], __shfl_xor_sync(0xffffffffu, run[nt][j], off));
        }
        // every lane now holds its 8 columns' maxima; lanes with g == nt
        // hand n8 tile nt to the epilogue (16 lanes, 2 columns each)
        if (lane / 4 == nt) {
          v0 = run[nt][0];
          v1 = run[nt][1];
        }
        run[nt][0] = run[nt][1] = lowest(Acc());
      }
      if (lane < 16)
        epi.block(s, (threadIdx.x / 32) * (NT * 8) + (lane / 4) * 8 + (lane % 4) * 2, v0, v1);
    }
  }
  cp_async_wait<0>();
}

}  // namespace mma_tile
