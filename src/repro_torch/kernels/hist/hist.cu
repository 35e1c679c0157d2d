// Masked per-code counts for Hopper (sm_90a): GROUP BY column COUNT(*)
// WHERE mask, straight from the resident packed words.
//
// Replaces src/repro/kernels/hist/kernel.py _masked_hist_kernel together
// with the XLA unpack that fed it (src/repro/kernels/predicate_scan/ops.py
// masked_counts, use_kernel=True): the function computed here is the one
// the pushdown path calls, masked_counts(flat_words, off, db, mask, k, n) ->
// (k,) int32 counts of the rows in [0, n) whose mask byte is nonzero, by
// the column's code. Codes >= k (and negative codes, 32-bit fields
// >= 2**31) are dropped.
//
// What bounds it on an H100: bytes. Per row it reads one mask byte and
// db / 8 bytes of words (only where the mask is set), and it writes 4k
// bytes once: for the 2-bit `device` column over 2**25 rows that is 8 MiB of
// words and 32 MiB of mask, about 12.5 us at 3.35 TB/s.
// The TPU kernel compared every code with a (BK,) iota tile and summed,
// k x n compares, because a TPU core has no scattered add. Here each row
// costs one atomic increment: a thread reads its 4 rows' mask bytes with one
// 32-bit load, skips the word loads when all four are 0, and counts into a
// per-block histogram in shared memory, which is added into the zeroed
// output with one global atomic per nonzero bin per block. Counts are
// integers, so the result does not depend on the order of the atomics.
// Where k int32 counters exceed the 227 KB a block may take, the same
// kernel counts straight into the output with global atomics instead (the
// kShared = false instantiation). A column with few codes (the 4-code
// `device`) makes every warp contend on the same shared bins; warp-level
// aggregation of equal codes is the next step and is not done here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../packed_code.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr long long kMaxBlocks = 132LL * 16;    // grid-stride past this
constexpr size_t kSharedLimit = 232448;         // 227 KB: a block's maximum
constexpr size_t kDefaultShared = 48 * 1024;    // above: opt in per kernel
constexpr size_t kSmShared = 233472;            // 228 KB per SM

template <bool kShared>
__global__ void __launch_bounds__(kThreads) masked_counts_kernel(
    const uint32_t* __restrict__ words, long long n_words, int word_off,
    int db, const uint8_t* __restrict__ mask, long long n, int k,
    int* __restrict__ out) {
  extern __shared__ int bins[];
  if (kShared) {
    for (int i = threadIdx.x; i < k; i += kThreads) bins[i] = 0;
    __syncthreads();
  }
  int* target = kShared ? bins : out;
  const bool aligned = (reinterpret_cast<uintptr_t>(mask) & 3) == 0;
  const long long stride = (long long)gridDim.x * kThreads * kRowsPerThread;
  for (long long r0 = ((long long)blockIdx.x * kThreads + threadIdx.x) *
                      kRowsPerThread;
       r0 < n; r0 += stride) {
    uint32_t four = 0;
    if (aligned && r0 + kRowsPerThread <= n) {
      four = __ldg(reinterpret_cast<const unsigned int*>(mask + r0));
    } else {
      for (int j = 0; j < kRowsPerThread && r0 + j < n; ++j)
        four |= (uint32_t)mask[r0 + j] << (8 * j);
    }
    if (four == 0) continue;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      if ((four >> (8 * j)) & 0xffu) {
        const int code = packed_code(words, n_words, word_off, db, r0 + j);
        if ((unsigned int)code < (unsigned int)k) atomicAdd(target + code, 1);
      }
    }
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < k; i += kThreads) {
      const int v = bins[i];
      if (v) atomicAdd(out + i, v);
    }
  }
}

}  // namespace

// Launcher with a plain C interface (bound with ctypes): launches on the
// caller's stream, allocates nothing, does not synchronise, and returns the
// first failing call's cudaError_t (0 = launched). `out` (k int32) must be
// zeroed by the caller.
extern "C" {

int masked_counts(const int* words, long long n_words, int word_off, int db,
                  const unsigned char* mask, long long n, int k, int* out,
                  void* stream) {
  long long blocks =
      (n + (long long)kThreads * kRowsPerThread - 1) /
      ((long long)kThreads * kRowsPerThread);
  if (blocks < 1) blocks = 1;
  const size_t smem = (size_t)k * sizeof(int);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(words);
  if (smem <= kSharedLimit) {
    if (smem > kDefaultShared) {
      cudaError_t err = cudaFuncSetAttribute(
          masked_counts_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSharedLimit);
      if (err != cudaSuccess) return (int)err;
    }
    // as many blocks as can be resident at once: each flushes k bins, so
    // more would only add flush atomics
    long long per_sm = (long long)(kSmShared / (smem + 1024));
    if (per_sm > 8) per_sm = 8;
    if (per_sm < 1) per_sm = 1;
    if (blocks > 132 * per_sm) blocks = 132 * per_sm;
    masked_counts_kernel<true>
        <<<(unsigned int)blocks, kThreads, smem, (cudaStream_t)stream>>>(
            w, n_words, word_off, db, mask, n, k, out);
  } else {
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    masked_counts_kernel<false>
        <<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
            w, n_words, word_off, db, mask, n, k, out);
  }
  return (int)cudaGetLastError();
}

const char* hist_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
