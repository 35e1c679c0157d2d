// Per-code counts for Hopper (sm_90a): the count metadata of paper §6.2
// (counts_kernel) and GROUP BY column COUNT(*) WHERE mask straight from the
// resident packed words (masked_counts_kernel).
//
// What replaces what (the TPU kernels are in src/repro/kernels/hist/
// kernel.py):
//   counts_kernel        <- _hist_kernel: hist(codes, k) -> (k,) int32
//                           counts of int32 codes of any shape
//   masked_counts_kernel <- _masked_hist_kernel together with the XLA
//                           unpack that fed it (src/repro/kernels/
//                           predicate_scan/ops.py masked_counts,
//                           use_kernel=True): masked_counts(flat_words, off,
//                           db, mask, k, n) -> (k,) int32 counts of the rows
//                           in [0, n) whose mask byte is nonzero, by the
//                           column's code
// Both drop codes outside [0, k): codes >= k and negative codes (for the
// masked counts, 32-bit fields >= 2**31), as the Pallas kernels do (their
// compare against an iota tile hits nothing there).
//
// What bounds them on an H100: bytes. counts_kernel reads 4 B per code and
// writes 4k bytes once: for the Table 6 column (2**25 codes, k = 999) that
// is 128 MiB, about 0.040 ms at 3.35 TB/s. The masked counts read one mask
// byte and db / 8 bytes of words per row (the words only where the mask is
// set): for the 2-bit `device` column over 2**25 rows 8 MiB of words and
// 32 MiB of mask, about 12.5 us.
// The TPU kernels compared every code with a (BK,) iota tile and summed,
// k x n compares, because a TPU core has no scattered add. Here each row
// costs one atomic increment into a per-block histogram in shared memory,
// which is added into the zeroed output with one global atomic per nonzero
// bin per block. counts_kernel reads four codes per thread with one 16-byte
// load; the masked counts read a thread's four mask bytes with one 32-bit
// load and skip the word loads when all four are 0. Counts are integers, so
// the result does not depend on the order of the atomics. Where k int32
// counters exceed the 227 KB a block may take (k > 58,112), the same kernels
// count straight into the output with global atomics instead (the
// kShared = false instantiations). A column with few codes (the 4-code
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

// The counters a block counts into: k zeroed bins in shared memory, or the
// output itself.
template <bool kShared>
__device__ __forceinline__ int* counters(int* bins, int* out, int k) {
  if (kShared) {
    for (int i = threadIdx.x; i < k; i += kThreads) bins[i] = 0;
    __syncthreads();
    return bins;
  }
  return out;
}

// Add a block's shared bins into the output, one atomic per nonzero bin.
template <bool kShared>
__device__ __forceinline__ void flush(const int* bins, int* out, int k) {
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < k; i += kThreads) {
      const int v = bins[i];
      if (v) atomicAdd(out + i, v);
    }
  }
}

__device__ __forceinline__ void count(int* target, int code, int k) {
  if ((unsigned int)code < (unsigned int)k) atomicAdd(target + code, 1);
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads) counts_kernel(
    const int* __restrict__ codes, long long n, int k, int* __restrict__ out) {
  extern __shared__ int bins[];
  int* target = counters<kShared>(bins, out, k);
  const bool aligned = (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  const long long stride = (long long)gridDim.x * kThreads * kRowsPerThread;
  for (long long r0 = ((long long)blockIdx.x * kThreads + threadIdx.x) *
                      kRowsPerThread;
       r0 < n; r0 += stride) {
    if (aligned && r0 + kRowsPerThread <= n) {
      const int4 four = __ldg(reinterpret_cast<const int4*>(codes + r0));
      count(target, four.x, k);
      count(target, four.y, k);
      count(target, four.z, k);
      count(target, four.w, k);
    } else {
      for (int j = 0; j < kRowsPerThread && r0 + j < n; ++j)
        count(target, __ldg(codes + r0 + j), k);
    }
  }
  flush<kShared>(bins, out, k);
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads) masked_counts_kernel(
    const uint32_t* __restrict__ words, long long n_words, int word_off,
    int db, const uint8_t* __restrict__ mask, long long n, int k,
    int* __restrict__ out) {
  extern __shared__ int bins[];
  int* target = counters<kShared>(bins, out, k);
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
      if ((four >> (8 * j)) & 0xffu)
        count(target, packed_code(words, n_words, word_off, db, r0 + j), k);
    }
  }
  flush<kShared>(bins, out, k);
}

// Launch a counts kernel over n rows into k bins: the shared-counter
// instantiation where k int32 fit in a block's 227 KB, as many blocks as
// can be resident at once (each flushes k bins, so more would only add
// flush atomics); else the global-counter one.
template <typename... Params, typename... Args>
int launch_counts(void (*shared_kernel)(Params...),
                  void (*global_kernel)(Params...), long long n, int k,
                  cudaStream_t stream, Args... args) {
  long long blocks =
      (n + (long long)kThreads * kRowsPerThread - 1) /
      ((long long)kThreads * kRowsPerThread);
  if (blocks < 1) blocks = 1;
  const size_t smem = (size_t)k * sizeof(int);
  if (smem <= kSharedLimit) {
    if (smem > kDefaultShared) {
      cudaError_t err = cudaFuncSetAttribute(
          shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)kSharedLimit);
      if (err != cudaSuccess) return (int)err;
    }
    long long per_sm = (long long)(kSmShared / (smem + 1024));
    if (per_sm > 8) per_sm = 8;
    if (per_sm < 1) per_sm = 1;
    if (blocks > 132 * per_sm) blocks = 132 * per_sm;
    shared_kernel<<<(unsigned int)blocks, kThreads, smem, stream>>>(args...);
  } else {
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    global_kernel<<<(unsigned int)blocks, kThreads, 0, stream>>>(args...);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launchers with a plain C interface (bound with ctypes): each launches on
// the caller's stream, allocates nothing, does not synchronise, and returns
// the first failing call's cudaError_t (0 = launched). `out` (k int32) must
// be zeroed by the caller.
extern "C" {

int counts(const int* codes, long long n, int k, int* out, void* stream) {
  return launch_counts(counts_kernel<true>, counts_kernel<false>, n, k,
                       (cudaStream_t)stream, codes, n, k, out);
}

int masked_counts(const int* words, long long n_words, int word_off, int db,
                  const unsigned char* mask, long long n, int k, int* out,
                  void* stream) {
  return launch_counts(masked_counts_kernel<true>,
                       masked_counts_kernel<false>, n, k,
                       (cudaStream_t)stream,
                       reinterpret_cast<const uint32_t*>(words), n_words,
                       word_off, db, mask, n, k, out);
}

const char* hist_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
