// Bit-unpack for Hopper (sm_90a): device-width packed words -> int32 codes.
//
// Replaces src/repro/kernels/bitunpack/kernel.py _bitunpack_kernel together
// with the padding of its wrapper (ops.py bitunpack). Code i of n is field
// i % s of word i / s, s = 32 / db rows per word, db in {1, 2, 4, 8, 16, 32}
// (the layout of kernels/packed_code.cuh): word-major, subfield-minor. Codes
// are int32, so a 32-bit field >= 2**31 comes out negative, as the TPU
// kernel's astype(int32) made it. Words past the n codes are never read;
// codes past the stream's last word read a zero word, as the reference's
// zero padding to a whole block gave them.
//
// What bounds it on an H100: bytes. It reads n * db / 8 bytes of words and
// writes 4n bytes of codes: for the Table 6 column (2**25 codes at 16 bits)
// 64 MiB read and 128 MiB written, about 0.060 ms at 3.35 TB/s. The writes
// are two thirds of it, so the design keeps them wide and coalesced.
// The TPU kernel shifted a (1, BW) tile of words by an iota into an (S, BW)
// tile and transposed it to word-major order in vector registers, because a
// TPU core has no cross-lane funnel shift. Here each thread makes four
// consecutive codes and writes them with one 16-byte store, so a warp writes
// 512 contiguous bytes; the words come through the read-only path, where
// the lanes that share a word share its load (for db <= 8 one word holds all
// four of a thread's codes). A thread at the ragged end writes its codes one
// by one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCodesPerThread = 4;
constexpr long long kMaxBlocks = 132LL * 32;  // grid-stride past this

// Code i: word i >> lg (zero past the stream), field (i mod 2**lg) * db.
__device__ __forceinline__ int code_at(const uint32_t* __restrict__ words,
                                       long long n_words, int db, int lg,
                                       long long i) {
  const long long w = i >> lg;
  const uint32_t word = w < n_words ? __ldg(words + w) : 0u;
  uint32_t field = word >> ((int)(i & ((1 << lg) - 1)) * db);
  if (db < 32) field &= (1u << db) - 1u;
  return (int)field;
}

__global__ void __launch_bounds__(kThreads) bitunpack_kernel(
    const uint32_t* __restrict__ words, long long n_words, int db,
    long long n, int* __restrict__ out) {
  const int lg = 6 - __ffs(db);                 // log2(32 / db)
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
       t * kCodesPerThread < n; t += stride) {
    const long long i = t * kCodesPerThread;
    if (i + kCodesPerThread <= n) {
      int4 v;
      v.x = code_at(words, n_words, db, lg, i);
      v.y = code_at(words, n_words, db, lg, i + 1);
      v.z = code_at(words, n_words, db, lg, i + 2);
      v.w = code_at(words, n_words, db, lg, i + 3);
      reinterpret_cast<int4*>(out)[t] = v;      // out is 16-byte aligned
    } else {
      for (long long j = i; j < n; ++j)
        out[j] = code_at(words, n_words, db, lg, j);
    }
  }
}

}  // namespace

// Launcher with a plain C interface (bound with ctypes): launches on the
// caller's stream, allocates nothing, does not synchronise, and returns the
// launch's cudaError_t (0 = launched). `out` holds n int32 and is 16-byte
// aligned; the caller handles n = 0 without a launch.
extern "C" {

int bitunpack(const int* words, long long n_words, int db, long long n,
              int* out, void* stream) {
  long long blocks = (n + (long long)kThreads * kCodesPerThread - 1) /
                     ((long long)kThreads * kCodesPerThread);
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  bitunpack_kernel<<<(unsigned int)blocks, kThreads, 0,
                     (cudaStream_t)stream>>>(
      reinterpret_cast<const uint32_t*>(words), n_words, db, n, out);
  return (int)cudaGetLastError();
}

const char* bitunpack_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
