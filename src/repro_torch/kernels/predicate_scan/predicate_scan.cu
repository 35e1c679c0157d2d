// Predicate scan for Hopper (sm_90a): a filter evaluated on the resident
// packed words, in code space, with the match count in the same launch.
//
// Replaces src/repro/kernels/predicate_scan/kernel.py
// _predicate_scan_kernel (and, for the count, the separate reduction the
// JAX executor runs after it, src/repro/core/pipeline.py
// _mask_count_future).
//
// Inputs: the flat resident word stream (column c's words start at
// wmeta[c, 0], packed at wmeta[c, 1] bits, a width that divides 32), a term
// table of T rows (col, kind, lo, hi, lut_off, lut_len) and every LUT term's
// table back to back. Per row and term the kernel loads the word
// off_c + row / s (s = 32 / db, a power of two, so the division is a
// shift), shifts the word by (row % s) * db, masks and casts
// to int32, as the TPU kernel's astype(int32) did. Kind 0 tests
// lo <= code <= hi; kind 1 probes lut[lut_off + min(code, lut_len - 1)] != 0
// (a negative code, a 32-bit field >= 2**31, probes entry 0). The terms
// fold with AND or OR. Rows [0, n) are scanned, stored and counted; rows
// past n never are, however far the stream's capacity reaches.
//
// What bounds it on an H100: bytes. Per row it reads db / 8 bytes of each
// column a term uses and writes one mask byte; the term table and the LUTs
// are a few KB and stay in L1/L2. For two 8-bit columns over 2**25 rows
// that is 64 MiB of words and 32 MiB of mask, about 30 us at 3.35 TB/s.
// The design: each thread owns 4 consecutive rows, so the mask leaves as
// one 32-bit store per thread (a warp writes 128 contiguous bytes) and the
// 4 rows' word loads fall in one or a few neighbouring words, coalesced
// across the warp. The TPU kernel's per-step window slice and its
// zero-padded copy of the used columns have no counterpart: the kernel
// reads the resident stream in place. The count is a warp reduction, one
// shared atomic per warp and one global atomic per block, so counting adds
// no pass over the mask. Word indices are clamped to the stream, so no
// load leaves it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../packed_code.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr long long kMaxBlocks = 132LL * 16;  // grid-stride past this
constexpr int kTermInts = 6;                  // col kind lo hi lut_off lut_len

__global__ void __launch_bounds__(kThreads) scan_kernel(
    const uint32_t* __restrict__ words, long long n_words,
    const int* __restrict__ wmeta, const int* __restrict__ terms,
    int n_terms, const int* __restrict__ lut, long long n, int combine_or,
    uint8_t* __restrict__ mask, int* __restrict__ count) {
  __shared__ int block_count;
  if (threadIdx.x == 0) block_count = 0;
  __syncthreads();
  const bool aligned = (reinterpret_cast<uintptr_t>(mask) & 3) == 0;
  const long long stride = (long long)gridDim.x * kThreads * kRowsPerThread;
  int matched = 0;
  for (long long r0 = ((long long)blockIdx.x * kThreads + threadIdx.x) *
                      kRowsPerThread;
       r0 < n; r0 += stride) {
    bool acc[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) acc[j] = !combine_or;
    for (int t = 0; t < n_terms; ++t) {
      const int* term = terms + kTermInts * t;
      const int col = __ldg(term), kind = __ldg(term + 1);
      const int lo = __ldg(term + 2), hi = __ldg(term + 3);
      const int lut_off = __ldg(term + 4), lut_last = __ldg(term + 5) - 1;
      const int off = __ldg(wmeta + 2 * col), db = __ldg(wmeta + 2 * col + 1);
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const int code = packed_code(words, n_words, off, db, r0 + j);
        bool m;
        if (kind == 0) {
          m = code >= lo && code <= hi;
        } else {
          const int idx = code < 0 ? 0 : (code > lut_last ? lut_last : code);
          m = __ldg(lut + lut_off + idx) != 0;
        }
        acc[j] = combine_or ? (acc[j] || m) : (acc[j] && m);
      }
    }
    if (aligned && r0 + kRowsPerThread <= n) {
      uint32_t four = 0;
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        four |= (uint32_t)acc[j] << (8 * j);
        matched += acc[j];
      }
      *reinterpret_cast<uint32_t*>(mask + r0) = four;
    } else {
      for (int j = 0; j < kRowsPerThread && r0 + j < n; ++j) {
        mask[r0 + j] = acc[j];
        matched += acc[j];
      }
    }
  }
  // every lane of every warp reaches this point (no early exit above)
  matched = __reduce_add_sync(0xffffffffu, matched);
  if ((threadIdx.x & 31) == 0 && matched) atomicAdd(&block_count, matched);
  __syncthreads();
  if (threadIdx.x == 0 && block_count) atomicAdd(count, block_count);
}

}  // namespace

// Launcher with a plain C interface (bound with ctypes): launches on the
// caller's stream, allocates nothing, does not synchronise, and returns the
// launch's cudaError_t (0 = launched). `count` must be zeroed by the caller.
extern "C" {

int predicate_scan(const int* words, long long n_words, const int* wmeta,
                   const int* terms, int n_terms, const int* lut, long long n,
                   int combine_or, unsigned char* mask, int* count,
                   void* stream) {
  long long blocks =
      (n + (long long)kThreads * kRowsPerThread - 1) /
      ((long long)kThreads * kRowsPerThread);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  scan_kernel<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const uint32_t*>(words), n_words, wmeta, terms,
      n_terms, lut, n, combine_or, mask, count);
  return (int)cudaGetLastError();
}

const char* predicate_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
