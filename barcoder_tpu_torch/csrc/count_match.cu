// count_match: every read's whole counting test in one pass over the raw
// read matrix, for barcoder_tpu_torch.pipeline.heuristic_count.CudaCounter.
//
// The kernel replaces no Pallas kernel: the JAX DeviceCounter matched on the
// TPU with jnp.dot outside Pallas, and tested each read (truncation, the N
// filter, the flank windows, the 2-bit key) in host numpy, which took ~30% of
// a sample while the card idled 99.97% of it. Here a read's test runs where
// its bytes are: VectorCounter.process_matrices' contract plus
// CudaCounter's exact match, bit for bit.
//
// One thread a read (a row of the uint8 matrix, zero-padded past the read's
// end). A block of R rows stages its R x W contiguous bytes of each mate's
// matrix into shared memory with 16-byte loads, then each thread:
//   1. counts the row's nonzero bytes: fewer than start + W_win is a
//      truncated window, which the host counts by the per-read oracle (the
//      row's index goes to the back of `out`; nothing else is done here);
//   2. drops the row if any byte is an uppercase N (paired: either mate);
//   3. takes the window at `start` (zero past the matrix) and compares the
//      left and right flanks byte for byte;
//   4. packs the core's codes (A C G T -> 0..3, any other byte -> 4) two bits
//      a base, base j at bits 2j, the sentinel ~0 for a core with a code 4;
//      a reverse read (single-end reverse, or mate 2) packs its reverse
//      complement; a pair is consistent when the two KEYS are equal (two
//      non-ACGT cores are both the sentinel, and so consistent);
//   5. looks a pure-ACGT core up by binary search in the library's keys,
//      sorted as int64 (so a 32-nt all-T core, key ~0 = -1, finds the all-T
//      barcode); a hit adds one to the shard's int64 accumulator at the key's
//      library row;
//   6. an eligible row that did not hit goes to the front of `out`: the host
//      tallies its core as undocumented.
// Both lists are appended with one atomicAdd a warp. Their order is not
// defined: the host sorts them.
//
// Bound: bytes. A batch's matrices are read once, and the outputs (4 bytes a
// listed row) are small; the binary search (14 probes of an 80 KB table that
// stays in L1/L2 at 10,240 barcodes) and the ~1 atomic a read are far below
// the card's rates. The hits go straight to the accumulator in global
// memory: ~250 hits a block over 10k rows cost less than flushing a 40 KB
// shared histogram per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 256;           // rows (threads) of a block
constexpr int kStageBytes = 48 * 1024;  // the most a block stages

struct Side {
  const uint8_t* m;  // (n, w) row-major, rows contiguous
  long long w;       // row width in bytes (the row stride)
  const uint8_t* lf; // left flank bytes (global), lf_len of them
  const uint8_t* rf; // right flank bytes
  int lf_len, rf_len, start;
};

struct Args {
  Side s1, s2;
  const long long* keys;  // (B,) sorted ascending as int64
  const long long* rows;  // (B,) the doc_counts row of each key
  long long* acc;         // (B,) int64 accumulator of the shard
  int* out;               // (n,): unmatched from the front, truncated from the back
  int* count;             // (2,): unmatched, truncated; zeroed by the launcher
  int n, B, bc_len;
};

__device__ __forceinline__ int base_code(uint8_t b) {
  return b == 'A' ? 0 : b == 'C' ? 1 : b == 'G' ? 2 : b == 'T' ? 3 : 4;
}

// One mate's test on its row `r` (shared or global memory): truncation, any
// N, both flanks, and the core's key (reverse complemented when REV).
template <bool REV>
__device__ __forceinline__ void test_side(const uint8_t* r, const Side& s, int bc_len,
                                          bool& trunc, bool& has_n, bool& flanks,
                                          unsigned long long& key, bool& pure) {
  const int w = (int)s.w;
  int nz = 0;
  has_n = false;
  for (int j = 0; j < w; ++j) {
    const uint8_t b = r[j];
    nz += b != 0;
    has_n |= b == 'N';
  }
  const int win = s.lf_len + bc_len + s.rf_len;
  trunc = nz < s.start + win;
  // the window: columns [lo, lo + valid) of the row, zero after (the numpy
  // window clamps its start to the matrix and pads past its end)
  const int lo = min(max(s.start, 0), w);
  const int valid = max(min(s.start + win, w) - lo, 0);
  flanks = true;
  for (int j = 0; j < s.lf_len; ++j) {
    const uint8_t b = j < valid ? r[lo + j] : 0;
    flanks &= b == __ldg(s.lf + j);
  }
  for (int j = 0; j < s.rf_len; ++j) {
    const int c = win - s.rf_len + j;
    const uint8_t b = c < valid ? r[lo + c] : 0;
    flanks &= b == __ldg(s.rf + j);
  }
  key = 0;
  pure = true;
  for (int j = 0; j < bc_len; ++j) {
    const int c = s.lf_len + (REV ? bc_len - 1 - j : j);
    int code = base_code(c < valid ? r[lo + c] : 0);
    if (REV && code < 4) code = 3 - code;
    pure &= code < 4;
    key |= (unsigned long long)(code & 3) << (2 * j);
  }
  if (!pure) key = ~0ull;
}

// Stage rows [row0, row0 + rows) of a side into `sm` with 16-byte loads;
// returns where row row0 starts in shared memory.
__device__ __forceinline__ const uint8_t* stage(uint8_t* sm, const Side& s, int row0, int rows) {
  const uint8_t* src = s.m + (long long)row0 * s.w;
  const long long nbytes = (long long)rows * s.w;
  // the shared copy sits at the global copy's offset mod 16, so both sides of
  // every 16-byte move are aligned
  const int pre = (int)((uintptr_t)src & 15);
  uint8_t* dst = sm + pre;
  const long long head = min((long long)((16 - pre) & 15), nbytes);
  for (long long i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  const long long n16 = (nbytes - head) >> 4;
  const uint4* s16 = reinterpret_cast<const uint4*>(src + head);
  uint4* d16 = reinterpret_cast<uint4*>(dst + head);
  for (long long i = threadIdx.x; i < n16; i += blockDim.x) d16[i] = __ldg(s16 + i);
  for (long long i = head + n16 * 16 + threadIdx.x; i < nbytes; i += blockDim.x) dst[i] = src[i];
  return dst;
}

// Append the rows whose `take` is set to a list through one atomicAdd a warp:
// at out[base + rank] from the front, or out[n - 1 - (base + rank)] from the back.
__device__ __forceinline__ void append(bool take, int row, int* counter, int* out, int n,
                                       bool from_back) {
  const unsigned lanes = __ballot_sync(0xffffffffu, take);
  if (!lanes) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(lanes) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(counter, __popc(lanes));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (take) {
    const int k = base + __popc(lanes & ((1u << lane) - 1));
    out[from_back ? n - 1 - k : k] = row;
  }
}

// MODE 0: single-end forward (s1); 1: single-end reverse (s2); 2: paired.
// STAGED: the block's rows fit kStageBytes and are staged; otherwise each
// thread reads its row from global memory.
template <int MODE, bool STAGED>
__global__ void __launch_bounds__(kMaxRows) count_match_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int row0 = blockIdx.x * blockDim.x;
  const int rows = min((int)blockDim.x, a.n - row0);
  if (rows <= 0) return;  // block-uniform
  const int t = threadIdx.x;
  const int row = row0 + t;
  const bool in = t < rows;
  const uint8_t* r1 = nullptr;
  const uint8_t* r2 = nullptr;
  if (STAGED) {
    long long off = 0;
    if (MODE != 1) {
      r1 = stage(smem, a.s1, row0, rows);
      off = ((long long)rows * a.s1.w + 16 + 15) & ~15ll;
    }
    if (MODE != 0) r2 = stage(smem + off, a.s2, row0, rows);
    __syncthreads();
    if (r1) r1 += (long long)t * a.s1.w;
    if (r2) r2 += (long long)t * a.s2.w;
  } else {
    if (MODE != 1) r1 = a.s1.m + (long long)row * a.s1.w;
    if (MODE != 0) r2 = a.s2.m + (long long)row * a.s2.w;
  }

  bool trunc = false, eligible = false, pure = false;
  unsigned long long key = ~0ull;
  if (in) {
    bool has_n, flanks;
    if (MODE == 0) {
      test_side<false>(r1, a.s1, a.bc_len, trunc, has_n, flanks, key, pure);
      eligible = !has_n && flanks;
    } else if (MODE == 1) {
      test_side<true>(r2, a.s2, a.bc_len, trunc, has_n, flanks, key, pure);
      eligible = !has_n && flanks;
    } else {
      bool t2, n2, f2, p2;
      unsigned long long k2;
      test_side<false>(r1, a.s1, a.bc_len, trunc, has_n, flanks, key, pure);
      test_side<true>(r2, a.s2, a.bc_len, t2, n2, f2, k2, p2);
      trunc |= t2;
      eligible = !has_n && !n2 && key == k2 && flanks && f2;
    }
  }
  bool hit = false;
  if (in && !trunc && eligible && pure) {
    const long long k = (long long)key;
    int lo = 0, hi = a.B;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(a.keys + mid) < k) lo = mid + 1; else hi = mid;
    }
    if (lo < a.B && __ldg(a.keys + lo) == k) {
      hit = true;
      atomicAdd(reinterpret_cast<unsigned long long*>(a.acc + __ldg(a.rows + lo)), 1ull);
    }
  }
  append(in && !trunc && eligible && !hit, row, a.count, a.out, a.n, false);
  append(in && trunc, row, a.count + 1, a.out, a.n, true);
}

template <int MODE>
int launch(const Args& a, cudaStream_t st) {
  const long long wsum = (MODE != 1 ? a.s1.w : 0) + (MODE != 0 ? a.s2.w : 0);
  // the most rows (a multiple of 32, at most kMaxRows) whose bytes, each side
  // padded by up to 31 bytes for alignment, fit the stage
  int rows = kMaxRows;
  while (rows >= 32 && (long long)rows * wsum + 64 > kStageBytes) rows >>= 1;
  const int per = rows >= 32 ? rows : kMaxRows;
  const int grid = a.n > 0 ? (a.n + per - 1) / per : 1;
  if (rows >= 32) {
    const size_t smem = (size_t)(rows * wsum + 64);
    count_match_kernel<MODE, true><<<grid, rows, smem, st>>>(a);
  } else {
    count_match_kernel<MODE, false><<<grid, kMaxRows, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// m1 / m2: the mates' matrices (either may be null: m1 alone is single-end
// forward, m2 alone single-end reverse, both paired); flanks: a device buffer
// holding L1 R1 L2 R2 back to back; lens: their lengths. Zeroes count, then
// launches on `stream`. n == 0 launches one empty block (loads the module).
extern "C" int count_match_launch(const void* m1, long long w1, const void* m2, long long w2,
                                  const void* flanks, int l1, int r1, int l2, int r2,
                                  int start1, int start2, int bc_len, const void* keys,
                                  const void* rows, void* acc, int B, void* out, void* count,
                                  int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* f = static_cast<const uint8_t*>(flanks);
  Args a{};
  a.s1 = Side{static_cast<const uint8_t*>(m1), w1, f, f + l1, l1, r1, start1};
  a.s2 = Side{static_cast<const uint8_t*>(m2), w2, f + l1 + r1, f + l1 + r1 + l2, l2, r2, start2};
  a.keys = static_cast<const long long*>(keys);
  a.rows = static_cast<const long long*>(rows);
  a.acc = static_cast<long long*>(acc);
  a.out = static_cast<int*>(out);
  a.count = static_cast<int*>(count);
  a.n = n;
  a.B = B;
  a.bc_len = bc_len;
  cudaError_t e = cudaMemsetAsync(count, 0, 2 * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  if (m1 && m2) return launch<2>(a, st);
  if (m2) return launch<1>(a, st);
  return launch<0>(a, st);
}
