// What the port's wgmma kernels share (scan_hits.cu, scan_max.cu,
// colmax_mma.cu, phase1_mma.cu), for NVIDIA Hopper (sm_90a): the column
// maxima of a product Q.G over blocks of Q's rows, for the 512 columns that
// one thread block owns.
//
// The shape of every one of them:
//
//   * a thread block of three warpgroups owns BN = 512 columns of one tile for
//     its life. It stages G for those columns once in shared memory, as
//     K-major core matrices of 8 columns x 16 bytes (no swizzle): column n's
//     16-byte K piece c at c * BN * 16 + n * 16 (built there from codes, or
//     transposed from a row-major G by stage_g);
//   * warpgroup 2 produces: one thread keeps a ring of 64-row chunks of Q full
//     with one cp.async.bulk each, on mbarriers (its registers go to the
//     consumers with setmaxnreg). The Python wrapper lays Q out as those
//     chunks (ops/scan_hits.py::chunk_layout): core matrix (8-row group g,
//     16-byte K piece c) at c * 1024 + g * 128 of its chunk;
//   * warpgroups 0 and 1 consume: each owns N = 256 columns and multiplies
//     every chunk by them with wgmma.mma_async m64n256 (k32 in int8, k16 in
//     bf16: 32 bytes of K a step), both operands read from shared memory by
//     the tensor cores, the 64 x 256 sums in 128 registers a thread;
//   * the row max comes straight from those registers (fold_rows), and when a
//     block of rows ends, a halving shuffle butterfly and shared memory reduce
//     it over the warpgroup's 64 rows (reduce_rows, column_max).
//
// What is not product hides behind one only while no divergent branch runs
// with a wgmma in flight (ptxas would serialize them): the code between two
// products is branch-free, its conditional stores and atomics are predicated
// instructions (the *_if helpers), and mbar_wait holds no trap.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace wgmma_tile {

constexpr int WG_THREADS = 3 * 128;  // warpgroups 0, 1 consume; warpgroup 2 produces
constexpr int N = 256;               // columns of one consumer warpgroup (wgmma n)
constexpr int BN = 2 * N;            // columns of one thread block
constexpr int CHUNK = 64;            // Q rows per wgmma (m64)
constexpr int RV = N / 4;            // running column maxima per thread
constexpr int VPT = N / 32;          // of them left per thread after the warp reduction

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared-memory matrix descriptor, no swizzle: K-major core matrices of 8
// rows x 16 bytes (128 contiguous bytes); lbo = byte distance of the two
// core matrices along K, sbo = byte distance of consecutive 8-row groups.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// the 128 accumulator registers of an m64n256 wgmma, as asm operands 0..127
#define WGMMA_D128                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "     \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
  "%61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, " \
  "%76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, " \
  "%91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, " \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "    \
  "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
#define WGMMA_OUT8(C, d, i)                                                       \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), \
      C(d[i + 6]), C(d[i + 7])
#define WGMMA_OUT128(C, d)                                                            \
  WGMMA_OUT8(C, d, 0), WGMMA_OUT8(C, d, 8), WGMMA_OUT8(C, d, 16), WGMMA_OUT8(C, d, 24),   \
      WGMMA_OUT8(C, d, 32), WGMMA_OUT8(C, d, 40), WGMMA_OUT8(C, d, 48),                   \
      WGMMA_OUT8(C, d, 56), WGMMA_OUT8(C, d, 64), WGMMA_OUT8(C, d, 72),                   \
      WGMMA_OUT8(C, d, 80), WGMMA_OUT8(C, d, 88), WGMMA_OUT8(C, d, 96),                   \
      WGMMA_OUT8(C, d, 104), WGMMA_OUT8(C, d, 112), WGMMA_OUT8(C, d, 120)

// D (+)= A.B for one 32-byte k-step: A 64 x 32 int8 and B 32 x 256 int8 from
// shared memory (both K-major), D 64 x 256 int32 in the warpgroup's registers.
__device__ __forceinline__ void wgmma_step(int (&d)[128], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " WGMMA_D128 ", %128, %129, p;\n}\n"
      : WGMMA_OUT128("+r", d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// The same in bf16: A 64 x 16 and B 16 x 256 bf16 (both K-major: the two
// transpose flags are 0), D 64 x 256 f32.
__device__ __forceinline__ void wgmma_step(float (&d)[128], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " WGMMA_D128
      ", %128, %129, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_OUT128("+f", d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// keeps the compiler from moving reads of d across the asynchronous wgmma
__device__ __forceinline__ void fence_regs(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// Waits until the barrier's phase of this parity has completed. (No
// watchdog trap in the loop: a conditional trap here makes ptxas serialize
// every wgmma, which costs a quarter of a kernel's time.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// one bulk copy of `bytes` from global to shared memory; the barrier's
// transaction count covers it
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void wg_bar(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// *dst = bits where on, as one predicated store (no branch beside a wgmma in
// flight)
__device__ __forceinline__ void store_if(void* dst, uint32_t bits, bool on) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p st.global.b32 [%0], %1;\n}\n" ::
                   "l"(dst), "r"(bits), "r"((int)on)
               : "memory");
}
// the same for one byte: the low byte of v
__device__ __forceinline__ void store_u8_if(void* dst, uint32_t v, bool on) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p st.global.u8 [%0], %1;\n}\n" ::
                   "l"(dst), "r"(v), "r"((int)on)
               : "memory");
}
// *dst += 1 where hit, as one predicated reduction. Counts are small
// integers: the order of the adds cannot change them.
__device__ __forceinline__ void add_one_if(float* dst, bool hit) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n@p red.global.add.f32 [%0], %2;\n}\n" ::
                   "l"(dst), "r"((int)hit), "f"(1.0f)
               : "memory");
}

// The block's K x BN slab of one tile's G, row-major (K, P) of BYTES-byte
// elements (K = 16 KS / BYTES, P even; columns >= P are zero), transposed
// into K-major core matrices: column n's 16-byte K piece c at c * BN * 16 +
// n * 16. A thread reads 16 / BYTES rows of one 4-byte word and transposes
// the bytes (int8) or halves (bf16) with __byte_perm.
template <int BYTES, int KS>
__device__ __forceinline__ void stage_g(const uint8_t* __restrict__ g_tile, int P, int p0,
                                        uint8_t* smem) {
  constexpr int PER = 4 / BYTES;    // columns in one 4-byte word of a row
  constexpr int ROWS = 16 / BYTES;  // k values in a column's 16-byte piece
  constexpr int WORDS = BN / PER;
  for (int idx = threadIdx.x; idx < 2 * KS * WORDS; idx += WG_THREADS) {
    const int c = idx / WORDS, n = (idx % WORDS) * PER;
    uint32_t w[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k)
      w[k] = p0 + n < P ? __ldg(reinterpret_cast<const uint32_t*>(
                              g_tile + ((size_t)(c * ROWS + k) * P + p0 + n) * BYTES))
                        : 0u;
    uint4* dst = reinterpret_cast<uint4*>(smem + c * BN * 16 + n * 16);
    if constexpr (BYTES == 1) {
      // 4 x 4 byte transposes: byte j of rows 4m..4m+3 -> word m of column n + j
      uint32_t col[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const uint32_t lo01 = __byte_perm(w[4 * m], w[4 * m + 1], 0x5140);
        const uint32_t lo23 = __byte_perm(w[4 * m + 2], w[4 * m + 3], 0x5140);
        const uint32_t hi01 = __byte_perm(w[4 * m], w[4 * m + 1], 0x7362);
        const uint32_t hi23 = __byte_perm(w[4 * m + 2], w[4 * m + 3], 0x7362);
        col[0][m] = __byte_perm(lo01, lo23, 0x5410);
        col[1][m] = __byte_perm(lo01, lo23, 0x7632);
        col[2][m] = __byte_perm(hi01, hi23, 0x5410);
        col[3][m] = __byte_perm(hi01, hi23, 0x7632);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[j] = make_uint4(col[j][0], col[j][1], col[j][2], col[j][3]);
    } else {
      // halves of rows 2m, 2m + 1 -> word m of columns n and n + 1
      dst[0] = make_uint4(__byte_perm(w[0], w[1], 0x5410), __byte_perm(w[2], w[3], 0x5410),
                          __byte_perm(w[4], w[5], 0x5410), __byte_perm(w[6], w[7], 0x5410));
      dst[1] = make_uint4(__byte_perm(w[0], w[1], 0x7632), __byte_perm(w[2], w[3], 0x7632),
                          __byte_perm(w[4], w[5], 0x7632), __byte_perm(w[6], w[7], 0x7632));
    }
  }
}

// The full and the empty barriers of a ring of `stages` chunks, at `full` and
// `full + 8 * stages`: one producer thread fills, lane 0 of each of the 8
// consumer warps frees. Ends with the fence that makes the barriers (and
// whatever the block wrote to shared memory before it) visible to the
// asynchronous proxy: follow it with __syncthreads().
__device__ __forceinline__ void ring_init(uint32_t full, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(full + 8 * (stages + s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ int max2(int a, int b) { return max(a, b); }
__device__ __forceinline__ float max2(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int max3(int a, int b, int c) { return __vimax3_s32(a, b, c); }
__device__ __forceinline__ float max3(float a, float b, float c) {
  return fmaxf(fmaxf(a, b), c);
}
__device__ __forceinline__ int lowest(int) { return INT_MIN; }
__device__ __forceinline__ float lowest(float) { return -INFINITY; }

// Folds a chunk's sums into the running column maxima: a thread holds rows g
// and g + 8 (of its warp's 16) of columns 8j + 2qd + e in acc[4j + e] and
// acc[4j + 2 + e]; run[2j + e] is that column over the rows seen so far.
template <class T>
__device__ __forceinline__ void fold_rows(T (&run)[RV], const T (&acc)[128]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      run[2 * j + e] = max3(run[2 * j + e], acc[4 * j + e], acc[4 * j + 2 + e]);
}

// Keeps HALF of the column maxima run[0, 2 HALF) and takes their max with
// the partner lane (lane ^ XOR), which keeps the other HALF: three such steps
// (XOR = 16, 8, 4) leave each lane of a column group the max over the 8
// row groups of the warp for its share of the columns.
template <int HALF, int XOR, class T>
__device__ __forceinline__ void halve(T (&run)[RV], int lane) {
  const bool upper = lane & XOR;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const T keep = upper ? run[i + HALF] : run[i];
    const T send = upper ? run[i] : run[i + HALF];
    run[i] = max2(keep, __shfl_xor_sync(0xffffffffu, send, XOR));
  }
}

// A block of rows ends: the running maxima over the warp's rows by the
// halving butterfly (each step hands half of the columns to the partner
// lane), written to the warp's row w4 of the warpgroup's 4 x N buffer, and
// reset. After a wg_bar, column_max reads a column over the 64 rows.
template <class T>
__device__ __forceinline__ void reduce_rows(T (&run)[RV], T* red_wg, int w4, int lane) {
  const int g = lane / 4, qd = lane % 4;
  halve<RV / 2, 16>(run, lane);
  halve<RV / 4, 8>(run, lane);
  halve<RV / 8, 4>(run, lane);
  // run[v] is now column 4 VPT g + 8 (v / 2) + 2 qd + v % 2 over the warp's rows
#pragma unroll
  for (int v = 0; v < VPT; ++v)
    red_wg[w4 * N + 4 * VPT * g + 8 * (v >> 1) + 2 * qd + (v & 1)] = run[v];
#pragma unroll
  for (int v = 0; v < RV; ++v) run[v] = lowest(T());
}
template <class T>
__device__ __forceinline__ T column_max(const T* red_wg, int c) {
  return max2(max2(red_wg[c], red_wg[N + c]), max2(red_wg[2 * N + c], red_wg[3 * N + c]));
}

}  // namespace wgmma_tile
