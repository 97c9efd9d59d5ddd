// Exact greedy NMS for Hopper (sm_90a): the suppression relation as a row
// bitmask, then one sequential sweep that settles the keep set on the device.
//
// Built by plain nvcc into a shared library with a C interface and loaded
// through ctypes (simple_sfod_tpu_torch/ops/_kernels.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -Xptxas -v -shared -Xcompiler -fPIC -o libsfod_nms.so nms.cu
// --fmad=false is required: with contraction on, nvcc fuses w*h and
// area_r + area_c into FMAs that round differently from the plain PyTorch
// version and from the JAX reference, and borderline IoUs flip.
//
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() after its launch (or
// cudaErrorInvalidValue, without launching, for arguments it does not take).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int kWord = 64;          // columns per bitmask word, rows per group
constexpr unsigned kFull = 0xffffffffu;

// Kernel 1: suppress_relation_bits.
//
// Replaces the Pallas kernel simple_sfod_tpu/ops/pallas_kernels.py:
// _suppress_relation_kernel (launched by suppress_relation), which writes the
// [N, N] bool relation rel[i, j] = IoU(i, j) > thr & i < j & valid_i & valid_j
// in 128x128 tiles. Here bit j of row i of a u64 row bitmask [N, ceil(N/64)]
// holds the same relation: 8x fewer bytes than bools.
//
// Bound: the IoU arithmetic, about 13 operations for each of the N^2/2 valid
// pairs (1.6 us at N = 4096 at the card's float32 rate); the 2 MiB mask it
// writes takes 0.6 us at 3.35 TB/s.
//
// Design:
// - A triangular grid: one block for each (row group b, column word w >= b),
//   so no block starts only to return. The block of (b, w > b) also writes
//   the zero word (row group w, word b) below the diagonal, so the mask needs
//   no separate zero fill.
// - 256 threads a block: thread t takes row t % 64 against the 16 columns
//   16 * (t / 64) .. +15, so all lanes of a warp read the same column box
//   (a shared-memory broadcast, free of bank conflicts) and each thread has
//   16 independent pairs, unrolled, for instruction-level parallelism. The
//   64 row and 64 column boxes, their areas and validity are staged in
//   shared memory by one round of global loads; the four 16-bit pieces of a
//   row's word meet in shared memory.
// - No division. With t the float32 threshold, t+ the next float above it and
//   m = (t + t+) / 2 (exact in float64), round-to-nearest-even gives, for
//   uni > 0:
//       fl(inter / uni) > t  <=>  inter > m * uni, or inter == m * uni when
//                                 t+'s significand is even,
//   where m * uni is exact in float64 (25 + 24 significant bits). For
//   uni <= 0 (or NaN) the IoU is 0 and the relation is 0 > t. This equals the
//   IEEE division for every float32 inter and uni that the intersection can
//   produce, infinities and NaN included (inter = +inf forces uni to be -inf
//   or NaN). inter, the areas and uni keep structures/boxes.py:pairwise_iou's
//   float32 operations and order.
template <bool kTieUp>
__global__ void __launch_bounds__(256)
suppress_relation_bits_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
                              double m, bool zero_above, int n, int words,
                              u64* __restrict__ out) {
  // block k -> (b, w), w >= b, numbered column by column: k = w (w + 1) / 2 + b
  const long long k = blockIdx.x;
  long long w = (long long)((sqrt(8.0 * (double)k + 1.0) - 1.0) * 0.5);
  while (w * (w + 1) / 2 > k) --w;
  while ((w + 1) * (w + 2) / 2 <= k) ++w;
  const int col_word = (int)w;
  const int row_group = (int)(k - w * (w + 1) / 2);

  __shared__ float4 box[2][kWord];      // [0]: the group's rows, [1]: the word's columns
  __shared__ float area[2][kWord];
  __shared__ unsigned ok[2][2];         // validity ballots of rows and columns
  __shared__ uint16_t piece[4][kWord];  // [16 columns][row]
  const int t = threadIdx.x;
  if (t < 2 * kWord) {
    const int side = t >> 6;
    const int j = (side ? col_word : row_group) * kWord + (t & 63);
    const float4 b = j < n ? boxes[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    box[side][t & 63] = b;
    area[side][t & 63] = (b.z - b.x) * (b.w - b.y);
    const unsigned ballot = __ballot_sync(kFull, j < n && valid[j]);
    if ((t & 31) == 0) ok[side][(t >> 5) & 1] = ballot;
  }
  if (t < kWord && col_word > row_group) {
    // the word below the diagonal that mirrors this block's
    const int mirror_row = col_word * kWord + t;
    if (mirror_row < n) out[(size_t)mirror_row * words + row_group] = 0ull;
  }
  __syncthreads();

  const int r = t & 63;    // row within the group
  const int q = t >> 6;    // which 16 columns: the same for the whole warp
  unsigned bits16 = 0u;
  if ((ok[0][r >> 5] >> (r & 31)) & 1u) {
    const float4 a = box[0][r];
    const float area_r = area[0][r];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int cc = q * 16 + c;
      const float4 b = box[1][cc];
      const float lt_x = fmaxf(a.x, b.x);
      const float lt_y = fmaxf(a.y, b.y);
      const float rb_x = fminf(a.z, b.z);
      const float rb_y = fminf(a.w, b.w);
      const float inter = fmaxf(rb_x - lt_x, 0.f) * fmaxf(rb_y - lt_y, 0.f);
      const float uni = area_r + area[1][cc] - inter;
      bool hit;
      if (uni > 0.f) {
        const double p = m * (double)uni;
        hit = kTieUp ? (double)inter >= p : (double)inter > p;
      } else {
        hit = zero_above;
      }
      bits16 |= (unsigned)hit << c;
    }
  }
  piece[q][r] = (uint16_t)bits16;
  __syncthreads();

  const int i = row_group * kWord + t;
  if (t < kWord && i < n) {
    u64 bits = (u64)piece[0][t] | ((u64)piece[1][t] << 16) | ((u64)piece[2][t] << 32) |
               ((u64)piece[3][t] << 48);
    bits &= ((u64)ok[1][1] << 32) | ok[1][0];
    if (col_word == row_group) bits &= t == kWord - 1 ? 0ull : ~0ull << (t + 1);
    out[(size_t)i * words + col_word] = bits;
  }
}

// Kernel 2: greedy_keep_from_bits.
//
// Replaces the certain-suppression fixpoint around the Pallas kernel
// (simple_sfod_tpu/ops/pallas_kernels.py:nms_mask_pallas, the same loop as
// ops/nms.py:nms_mask_matrix), which iterates whole-matrix reductions until
// nothing changes. Both compute exact greedy NMS, so the keep sets are equal.
//
// Bound: a sequential dependency over the N sorted rows (row r is kept iff it
// is valid and no kept row before it suppresses it). The bytes (the kept
// rows' words right of the diagonal, about 0.7 MB at N = 4096, in L2 right
// after kernel 1) are few for the card, but a single SM pulls them from L2 at
// a small fraction of its bandwidth, and its memory instructions queue with
// the chain's shuffles: they have to stay off the chain. One block, one
// launch, no host round trip.
//
// Design: rows are settled in groups of 64, one group per step of a loop that
// all 512 threads run; the steps are separated by one __syncthreads. Warps
// have three roles, and each role loads what it needs some steps ahead.
// - Warp 0, the chain, settles group b. The walk is exact greedy order: row r
//   is kept iff bit r of `cur` (the group's removed bits) is clear, and a kept
//   row ORs its diagonal word into `cur`. It goes five rows at a time, by
//   table: for each window of five rows and each of the 32 states of their
//   five bits of `cur`, the table holds what the window ORs into `cur` (lane
//   s of warp 0 holds state s's entries, in registers). The chain takes the
//   real five bits of `cur` (a funnel shift), fetches that entry by
//   __shfl_sync and ORs it in: 13 short steps for 64 rows, with no memory
//   access. This is chosen over a walk over the candidate rows with __ffsll
//   (a shuffle whose source lane depends on the chain, for every kept row),
//   over the certain-suppression fixpoint on bits (as many rounds of warp
//   reductions as the longest suppression chain in the group: 64 for a chain
//   of boxes) and over a row-by-row walk (a test and an OR on the chain for
//   every row). Rows that kernel 1 wrote have bits
//   only to the right of their own, so after the walk kept = ~cur & valid.
//   Warp 0 then ORs column b + 1's words of the kept rows of groups b, b - 1
//   and b - 2 (loaded a step ahead) with two __reduce_or_sync, and carries
//   that into step b + 1.
// - Warps 1-4 build the tables of group b + 1 during step b, each lane
//   walking a window's five rows for its own state, from the group's 64
//   diagonal words, which they copied into shared memory (cp.async) at step
//   b - 2.
// - Warps 5-15 OR the kept rows of group b - 3 into the removed words of
//   columns b + 1 .. (columns b - 2 .. b had them from the chain's carries),
//   from shared memory: a warp takes 32 columns and 8 rows, and the pieces
//   meet by shared-memory atomicOr. And they start copying the kept rows of
//   group b - 1 (known since the end of step b - 1) into shared memory with
//   cp.async (16 bytes a copy when the row stride is 16-byte aligned, else
//   8), for step b + 2.
// A group's rows take about as long to arrive from L2 as the chain takes for a
// group, so each copy has two steps to land, and only kept rows are copied.
// Shared memory: 3 slices of 64 x S words (S = words rounded up to even), the
// removed words, the valid bits and the kept words of every group, 2 tables
// and 4 slots of diagonal words: 106 KiB at N = 4096, 222 KiB at the largest
// N taken, kMaxWords * 64 = 8960.
constexpr int kGreedyThreads = 512;
constexpr int kMaxWords = 140;
constexpr int kStep = 5;                               // rows a table entry settles
constexpr int kWindows = (kWord + kStep - 1) / kStep;  // 13
constexpr int kTableWarps = 4;                         // warps 1-4
constexpr int kOrWarps = kGreedyThreads / 32 - 1 - kTableWarps;  // warps 5-15
constexpr int kWindowsPerWarp = (kWindows + kTableWarps - 1) / kTableWarps;
// group g reaches the removed words at step g + kLag (columns g + kLag + 1
// ..); the chain carries it into columns g + 1 .. g + kLag
constexpr int kLag = 3;
constexpr int kSlices = kLag;   // a group's rows: copied at step g + 1, ORed at g + kLag
constexpr int kDiagSlots = 4;   // diagonal words of groups b + 1 .. b + 3, and b + 4 arriving

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async(u64* dst, const u64* src, int bytes) {
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Row `row`'s word of column `col`, or 0 outside the mask or for row < 0.
__device__ __forceinline__ u64 mask_word(const u64* __restrict__ bits, int row, int col, int n,
                                         int words) {
  return row >= 0 && row < n && col < words ? bits[(size_t)row * words + col] : 0ull;
}

// Table warps: start copying group g's 64 diagonal words into `diag` (rows
// >= n as zeros), as one cp.async group. tt = 0 .. 127.
__device__ __forceinline__ void copy_diag(u64* diag, const u64* __restrict__ bits, int g, int n,
                                          int words, int tt) {
  if (tt < kWord && g < words) {
    const int row = g * kWord + tt;
    if (row < n) {
      cp_async(diag + tt, bits + (size_t)row * words + g, 8);
    } else {
      diag[tt] = 0ull;
    }
  }
  cp_async_commit();
}

// Table entry of state `lane` for each of table warp tw's windows: what the
// window's rows OR into cur when bits r0 .. r0+k-1 of cur are `lane`.
__device__ __forceinline__ void build_tables(u64* table, const u64* diag, int tw, int lane) {
#pragma unroll
  for (int i = 0; i < kWindowsPerWarp; ++i) {
    const int win = tw + i * kTableWarps;
    if (win >= kWindows) break;
    const int r0 = win * kStep;
    const int k = r0 + kStep <= kWord ? kStep : kWord - r0;
    const unsigned wmask = (1u << k) - 1u;
    u64 w[kStep];  // all five loads first: none waits on the walk
#pragma unroll
    for (int j = 0; j < kStep; ++j) w[j] = j < k ? diag[r0 + j] : 0ull;
    unsigned state = (unsigned)lane & wmask;
    u64 v = 0ull;
#pragma unroll
    for (int j = 0; j < kStep; ++j) {
      if (!((state >> j) & 1u)) {
        v |= w[j];
        state |= (unsigned)(w[j] >> r0) & wmask;
      }
    }
    table[win * 32 + lane] = v;
  }
}

__global__ void __launch_bounds__(kGreedyThreads, 1)
greedy_keep_from_bits_kernel(const u64* __restrict__ bits, const uint8_t* __restrict__ valid,
                             int n, int words, uint8_t* __restrict__ keep) {
  extern __shared__ u64 smem[];
  const int stride = words + (words & 1);
  u64* slices = smem;                                // [kSlices][64][stride]
  u64* removed = slices + kSlices * kWord * stride;  // [words]
  u64* vbits = removed + words;                      // [words]
  u64* kept_words = vbits + words;                   // [words]
  u64* tables = kept_words + words;                  // [2][kWindows][32]
  u64* diag = tables + 2 * kWindows * 32;            // [kDiagSlots][64]
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int nwarps = kGreedyThreads / 32;
  const bool chain = warp == 0;
  const bool table_warp = warp >= 1 && warp <= kTableWarps;
  const int tw = warp - 1;                // table warps: 0 .. kTableWarps-1
  const int ow = warp - 1 - kTableWarps;  // OR warps: 0 .. kOrWarps-1

  for (int w = t; w < words; w += kGreedyThreads) removed[w] = 0ull;
  for (int g = warp; g < words; g += nwarps) {
    const int r0 = g * kWord + lane, r1 = r0 + 32;
    const unsigned lo = __ballot_sync(kFull, r0 < n && valid[r0]);
    const unsigned hi = __ballot_sync(kFull, r1 < n && valid[r1]);
    if (lane == 0) vbits[g] = ((u64)hi << 32) | lo;
  }
  if (table_warp) {
    const int tt = t - 32;
    for (int g = 0; g < kDiagSlots - 1; ++g) copy_diag(diag + g * kWord, bits, g, n, words, tt);
    cp_async_wait<kDiagSlots - 2>();  // group 0's words have landed
    asm volatile("bar.sync 2, %0;\n" ::"n"(kTableWarps * 32) : "memory");
    build_tables(tables, diag, tw, lane);
  }
  // chain: column b + 1's words of the rows of groups b, b - 1, b - 2
  u64 col[kLag][2] = {};
  u64 kept_hist[kLag] = {};  // kept rows of groups b, b - 1, b - 2
  u64 carry = 0ull;          // groups b - 1 .. b - kLag ORed over column b
  if (chain) {
    col[0][0] = mask_word(bits, lane, 1, n, words);
    col[0][1] = mask_word(bits, lane + 32, 1, n, words);
  }
  __syncthreads();

  for (int b = 0; b < words; ++b) {
    const int row0 = b * kWord;
    if (chain) {
      const u64* tab = tables + (b & 1) * kWindows * 32;
      u64 v[kWindows];
#pragma unroll
      for (int i = 0; i < kWindows; ++i) v[i] = tab[i * 32 + lane];
      // a step ahead: column b + 2's words of the rows of groups b + 1, b, b - 1
      u64 next[kLag][2];
#pragma unroll
      for (int k = 0; k < kLag; ++k) {
        const int g = b + 1 - k;
        next[k][0] = mask_word(bits, g * kWord + lane, b + 2, n, words);
        next[k][1] = mask_word(bits, g * kWord + lane + 32, b + 2, n, words);
      }
      const u64 start = removed[b] | carry;
      unsigned clo = (unsigned)start, chi = (unsigned)(start >> 32);
#pragma unroll
      for (int i = 0; i < kWindows; ++i) {
        const int r0 = i * kStep;
        const int k = r0 + kStep <= kWord ? kStep : kWord - r0;
        const unsigned state =
            (r0 < 32 ? __funnelshift_r(clo, chi, r0) : chi >> (r0 - 32)) & ((1u << k) - 1u);
        clo |= __shfl_sync(kFull, (unsigned)v[i], state);
        chi |= __shfl_sync(kFull, (unsigned)(v[i] >> 32), state);
      }
      const u64 kept = ~(((u64)chi << 32) | clo) & vbits[b];
      if (row0 + lane < n) keep[row0 + lane] = (uint8_t)((kept >> lane) & 1ull);
      if (row0 + lane + 32 < n) keep[row0 + lane + 32] = (uint8_t)((kept >> (lane + 32)) & 1ull);
      if (lane == 0) kept_words[b] = kept;
#pragma unroll
      for (int k = kLag - 1; k > 0; --k) kept_hist[k] = kept_hist[k - 1];
      kept_hist[0] = kept;
      u64 c = 0ull;
#pragma unroll
      for (int k = 0; k < kLag; ++k) {
        if ((kept_hist[k] >> lane) & 1ull) c |= col[k][0];
        if ((kept_hist[k] >> (lane + 32)) & 1ull) c |= col[k][1];
        col[k][0] = next[k][0];
        col[k][1] = next[k][1];
      }
      carry = (u64)__reduce_or_sync(kFull, (unsigned)c) |
              ((u64)__reduce_or_sync(kFull, (unsigned)(c >> 32)) << 32);
    } else if (table_warp) {
      const int tt = t - 32;
      copy_diag(diag + ((b + kDiagSlots - 1) % kDiagSlots) * kWord, bits, b + kDiagSlots - 1, n,
                words, tt);
      cp_async_wait<kDiagSlots - 2>();  // group b + 1's words have landed
      asm volatile("bar.sync 2, %0;\n" ::"n"(kTableWarps * 32) : "memory");
      if (b + 1 < words) {
        build_tables(tables + ((b + 1) & 1) * kWindows * 32, diag + ((b + 1) % kDiagSlots) * kWord,
                     tw, lane);
      }
    } else {
      // group g = b - kLag into columns b + 1 .., from the rows copied at
      // step g + 1
      const int g = b - kLag;
      cp_async_wait<1>();  // all but the copy started at step b - 1
      asm volatile("bar.sync 1, %0;\n" ::"n"(kOrWarps * 32) : "memory");
      if (g >= 0 && g + kLag + 1 < words) {
        const u64 kg = kept_words[g];
        const u64* sl = slices + (g % kSlices) * kWord * stride;
        const int first = g + kLag + 1;
        const int c0 = first & ~1;
        const int ntasks = ((words - first + 31) / 32) * 8;
        for (int task = ow; task < ntasks; task += kOrWarps) {
          const int part = task & 7;
          const unsigned rows = (unsigned)(kg >> (part * 8)) & 0xffu;
          const int w = first + (task >> 3) * 32 + lane;
          if (rows == 0u || w >= words) continue;
          u64 acc = 0ull;
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            if (rows & (1u << r)) acc |= sl[(part * 8 + r) * stride + (w - c0)];
          }
          unsigned* dst = reinterpret_cast<unsigned*>(removed + w);
          if ((unsigned)acc) atomicOr(dst, (unsigned)acc);
          if ((unsigned)(acc >> 32)) atomicOr(dst + 1, (unsigned)(acc >> 32));
        }
      }
      // start copying group h = b - 1's kept rows, columns (h + kLag + 1) & ~1 ..
      const int h = b - 1;
      if (h >= 0 && h + kLag + 1 < words) {
        const u64 kh = kept_words[h];
        u64* sl = slices + (h % kSlices) * kWord * stride;
        const int c0 = (h + kLag + 1) & ~1;
        const int vec = (words & 1) ? 1 : 2;  // u64 words a copy
        for (int r = ow; r < kWord; r += kOrWarps) {
          if (!((kh >> r) & 1ull)) continue;
          const u64* row = bits + (size_t)(h * kWord + r) * words;
          for (int c = c0 + lane * vec; c < words; c += 32 * vec) {
            cp_async(sl + r * stride + (c - c0), row + c, vec * 8);
          }
        }
      }
      cp_async_commit();
    }
    __syncthreads();
  }
}

size_t greedy_smem_bytes(int words) {
  const int stride = words + (words & 1);
  return (size_t)(kSlices * kWord * stride + 3 * words + 2 * kWindows * 32 + kDiagSlots * kWord) *
         sizeof(u64);
}

// Kernel 2, second route: greedy_keep_from_bits for N above kMaxWords * 64,
// where kernel 2's three slices of rows no longer fit in shared memory.
//
// The same exact greedy sweep, one block, one launch, no host round trip,
// with the removed words of every column in shared memory (8 bytes a word:
// 48 KiB at N = 393216) and nothing else of the mask kept there. For each
// group of 64 rows: the group's diagonal words and valid bits are loaded,
// thread 0 walks the 64 rows in order (a row is kept iff it is valid and its
// bit of the removed word is clear, and a kept row ORs its diagonal word in),
// then every thread ORs the kept rows' words of its columns right of the
// diagonal into the removed words, reading them from global memory (the
// threads of a warp read consecutive words of one row). This is the row walk
// of the first slice's kernel; it reads only the kept rows right of the
// diagonal, as kernel 2 does, but without kernel 2's look-ahead, so the chain
// waits on each group's loads.
constexpr int kRowWalkThreads = 256;
// 224 KiB of removed words: the static shared memory stays under the card's
// 227 KiB a block
constexpr int kRowWalkMaxWords = 224 * 1024 / 8;

__global__ void __launch_bounds__(kRowWalkThreads)
greedy_keep_from_bits_rowwalk_kernel(const u64* __restrict__ bits, const uint8_t* __restrict__ valid,
                                     int n, int words, uint8_t* __restrict__ keep) {
  extern __shared__ u64 removed[];  // [words]
  __shared__ u64 diag[kWord];
  __shared__ unsigned vhalf[2];
  __shared__ u64 kept_word;
  const int t = threadIdx.x;
  for (int w = t; w < words; w += kRowWalkThreads) removed[w] = 0ull;
  for (int b = 0; b < words; ++b) {
    const int row0 = b * kWord;
    if (t < kWord) {
      const int row = row0 + t;
      diag[t] = row < n ? bits[(size_t)row * words + b] : 0ull;
      const unsigned ballot = __ballot_sync(kFull, row < n && valid[row]);
      if ((t & 31) == 0) vhalf[t >> 5] = ballot;
    }
    __syncthreads();
    if (t == 0) {
      u64 cur = removed[b];
      const u64 v = ((u64)vhalf[1] << 32) | vhalf[0];
      u64 kw = 0ull;
      for (int r = 0; r < kWord; ++r) {
        if (((v >> r) & 1ull) && !((cur >> r) & 1ull)) {
          kw |= 1ull << r;
          cur |= diag[r];
        }
      }
      kept_word = kw;
    }
    __syncthreads();
    const u64 kw = kept_word;
    if (t < kWord && row0 + t < n) keep[row0 + t] = (uint8_t)((kw >> t) & 1ull);
    for (int w = b + 1 + t; w < words; w += kRowWalkThreads) {
      u64 acc = 0ull;
      for (u64 rest = kw; rest; rest &= rest - 1) {
        const int r = __ffsll((long long)rest) - 1;
        acc |= bits[(size_t)(row0 + r) * words + w];
      }
      removed[w] |= acc;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// boxes: float32 [n, 4], 16-byte aligned; valid: uint8 [n];
// out: uint64 [n, words], words = ceil(n / 64); every word is written.
// thr must have a finite next float above it (not NaN, inf or FLT_MAX).
int sfod_suppress_relation_bits(const void* boxes, const void* valid, float thr, int n,
                                int words, void* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const float up = nextafterf(thr, INFINITY);
  if (!std::isfinite(up) || std::isnan(thr) || words > 65535) return (int)cudaErrorInvalidValue;
  const double m = ((double)thr + (double)up) * 0.5;  // exact: 25 significant bits
  uint32_t up_bits;
  std::memcpy(&up_bits, &up, sizeof(up_bits));
  const bool tie_up = (up_bits & 1u) == 0u;  // a tie rounds to t+ when its significand is even
  const bool zero_above = 0.f > thr;
  const unsigned blocks = (unsigned)((long long)words * (words + 1) / 2);
  if (tie_up) {
    suppress_relation_bits_kernel<true><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const float4*)boxes, (const uint8_t*)valid, m, zero_above, n, words, (u64*)out);
  } else {
    suppress_relation_bits_kernel<false><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const float4*)boxes, (const uint8_t*)valid, m, zero_above, n, words, (u64*)out);
  }
  return (int)cudaGetLastError();
}

// bits: uint64 [n, words] from sfod_suppress_relation_bits, 16-byte aligned;
// valid: uint8 [n]; keep: uint8 [n] (0/1), written in sorted order.
// words <= kMaxWords (n <= 8960); larger n take the row-walk route below.
int sfod_greedy_keep_from_bits(const void* bits, const void* valid, int n, int words,
                               void* keep, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (words > kMaxWords) return (int)cudaErrorInvalidValue;
  const size_t smem = greedy_smem_bytes(words);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        greedy_keep_from_bits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  greedy_keep_from_bits_kernel<<<1, kGreedyThreads, smem, (cudaStream_t)stream>>>(
      (const u64*)bits, (const uint8_t*)valid, n, words, (uint8_t*)keep);
  return (int)cudaGetLastError();
}

// The second route of sfod_greedy_keep_from_bits, for any words (the caller
// takes it above kMaxWords); the removed words must fit in shared memory:
// words <= 28672 (n <= 1835008).
int sfod_greedy_keep_from_bits_rowwalk(const void* bits, const void* valid, int n, int words,
                                       void* keep, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)words * sizeof(u64);
  if (words > kRowWalkMaxWords) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        greedy_keep_from_bits_rowwalk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  greedy_keep_from_bits_rowwalk_kernel<<<1, kRowWalkThreads, smem, (cudaStream_t)stream>>>(
      (const u64*)bits, (const uint8_t*)valid, n, words, (uint8_t*)keep);
  return (int)cudaGetLastError();
}

}  // extern "C"
