// Exact greedy NMS for Hopper (sm_90a): the suppression relation as a row
// bitmask, then one sequential sweep that settles the keep set on the device.
//
// Built by plain nvcc into a shared library with a C interface and loaded
// through ctypes (simple_sfod_tpu_torch/ops/_kernels.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC -o libsfod_nms.so nms.cu
// --fmad=false is required: with contraction on, nvcc fuses w*h and
// area_r + area_c into FMAs that round differently from the plain PyTorch
// version and from the JAX reference, and borderline IoUs flip.
//
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWord = 64;  // columns per bitmask word, rows per block

// Kernel 1: suppress_relation_bits.
//
// Replaces the Pallas kernel simple_sfod_tpu/ops/pallas_kernels.py:
// _suppress_relation_kernel (launched by suppress_relation), which writes the
// [N, N] bool relation rel[i, j] = IoU(i, j) > thr & i < j & valid_i & valid_j
// in 128x128 tiles. Here bit j of row i of a u64 row bitmask [N, ceil(N/64)]
// holds the same relation: 8x fewer bytes than bools.
//
// Bound: the bytes it writes. At N = 4096 the mask is 4096 * 64 * 8 = 2 MiB,
// about 0.6 us at 3.35 TB/s, so in practice the launch itself bounds it; the
// IoU arithmetic (about 20 flops for each of N^2/2 pairs) is far below the
// card's float32 rate. Design: one block of 64 threads per (64-row group,
// 64-column word); the 64 column boxes are staged once in shared memory and
// each thread builds its row's word in a register and writes it with one
// 8-byte store. Blocks wholly below the diagonal return at once: the wrapper
// zero-fills the mask, and the kernel writes nothing below the diagonal.
__global__ void suppress_relation_bits_kernel(const float4* __restrict__ boxes,
                                              const uint8_t* __restrict__ valid,
                                              float thr, int n, int words,
                                              unsigned long long* __restrict__ out) {
  const int col_word = blockIdx.x;
  const int row_block = blockIdx.y;
  if (col_word < row_block) return;  // every pair there has i > j

  __shared__ float4 col_box[kWord];
  __shared__ uint8_t col_valid[kWord];
  const int t = threadIdx.x;
  const int j0 = col_word * kWord;
  if (j0 + t < n) {
    col_box[t] = boxes[j0 + t];
    col_valid[t] = valid[j0 + t];
  } else {
    col_box[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    col_valid[t] = 0;
  }
  __syncthreads();

  const int i = row_block * kWord + t;
  if (i >= n) return;
  unsigned long long bits = 0ull;
  if (valid[i]) {
    const float4 r = boxes[i];
    // same operation order as structures/boxes.py:pairwise_iou
    const float area_r = (r.z - r.x) * (r.w - r.y);
    for (int c = 0; c < kWord; ++c) {
      const int j = j0 + c;
      if (j <= i || !col_valid[c]) continue;
      const float4 b = col_box[c];
      const float lt_x = fmaxf(r.x, b.x);
      const float lt_y = fmaxf(r.y, b.y);
      const float rb_x = fminf(r.z, b.z);
      const float rb_y = fminf(r.w, b.w);
      const float inter = fmaxf(rb_x - lt_x, 0.f) * fmaxf(rb_y - lt_y, 0.f);
      const float area_c = (b.z - b.x) * (b.w - b.y);
      const float uni = area_r + area_c - inter;
      const float iou = uni > 0.f ? inter / uni : 0.f;
      if (iou > thr) bits |= 1ull << c;
    }
  }
  out[(size_t)i * words + col_word] = bits;
}

// Kernel 2: greedy_keep_from_bits.
//
// Replaces the certain-suppression fixpoint around the Pallas kernel
// (simple_sfod_tpu/ops/pallas_kernels.py:nms_mask_pallas, the same loop as
// ops/nms.py:nms_mask_matrix), which iterates whole-matrix reductions until
// nothing changes. Both compute exact greedy NMS, so the keep sets are equal.
//
// Bound: a sequential dependency over the N sorted rows; the bytes (the
// mask, read once at most) are small. Design: one block, in one launch, with
// no host round trip per step. The removed-bits words live in shared memory.
// Rows are settled 64 at a time: the block's diagonal words are staged in
// shared memory in parallel, one thread walks the 64 rows in order (row r is
// kept iff valid and not removed; a kept row ORs its diagonal word into the
// removed word), then all threads OR the kept rows' words to the right of
// the diagonal into the removed words, one word per thread per row, with
// coalesced loads. That is N/64 block-wide steps instead of N.
__global__ void greedy_keep_from_bits_kernel(const unsigned long long* __restrict__ bits,
                                             const uint8_t* __restrict__ valid, int n,
                                             int words, uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];  // [words]
  __shared__ unsigned long long diag[kWord];
  __shared__ unsigned long long kept_word;
  const int t = threadIdx.x;
  for (int w = t; w < words; w += blockDim.x) removed[w] = 0ull;
  __syncthreads();

  for (int b = 0; b < words; ++b) {
    const int row0 = b * kWord;
    for (int r = t; r < kWord; r += blockDim.x) {
      diag[r] = (row0 + r < n) ? bits[(size_t)(row0 + r) * words + b] : 0ull;
    }
    __syncthreads();
    if (t == 0) {
      unsigned long long cur = removed[b];
      unsigned long long kw = 0ull;
      for (int r = 0; r < kWord && row0 + r < n; ++r) {
        if (valid[row0 + r] && !((cur >> r) & 1ull)) {
          kw |= 1ull << r;
          cur |= diag[r];
        }
      }
      removed[b] = cur;
      kept_word = kw;
    }
    __syncthreads();
    const unsigned long long kw = kept_word;
    for (int w = b + 1 + t; w < words; w += blockDim.x) {
      unsigned long long acc = 0ull;
      unsigned long long rest = kw;
      while (rest) {
        const int r = __ffsll((long long)rest) - 1;
        rest &= rest - 1;
        acc |= bits[(size_t)(row0 + r) * words + w];
      }
      removed[w] |= acc;
    }
    for (int r = t; r < kWord; r += blockDim.x) {
      if (row0 + r < n) keep[row0 + r] = (uint8_t)((kw >> r) & 1ull);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// boxes: float32 [n, 4], 16-byte aligned; valid: uint8 [n];
// out: uint64 [n, words], zero-filled by the caller; words = ceil(n / 64).
int sfod_suppress_relation_bits(const void* boxes, const void* valid, float thr, int n,
                                int words, void* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  dim3 grid(words, words);
  suppress_relation_bits_kernel<<<grid, kWord, 0, (cudaStream_t)stream>>>(
      (const float4*)boxes, (const uint8_t*)valid, thr, n, words,
      (unsigned long long*)out);
  return (int)cudaGetLastError();
}

// bits: uint64 [n, words] from sfod_suppress_relation_bits; valid: uint8 [n];
// keep: uint8 [n] (0/1), written in sorted order.
int sfod_greedy_keep_from_bits(const void* bits, const void* valid, int n, int words,
                               void* keep, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)words * sizeof(unsigned long long);
  greedy_keep_from_bits_kernel<<<1, kWord, smem, (cudaStream_t)stream>>>(
      (const unsigned long long*)bits, (const uint8_t*)valid, n, words, (uint8_t*)keep);
  return (int)cudaGetLastError();
}

}  // extern "C"
