// The wide half of Wide&Deep for Hopper (sm_90a): a one-hot linear layer
// over C categorical columns and its gradient with respect to the weights.
//
//   forward   out[n, f] = sum_c W[c, codes[c, n], f]        (N, F)
//   backward  dW[c, codes[c, n], f] += g[n, f]               (C, K, F)
//
// A code outside [0, K) adds nothing and gets no gradient.
//
// What replaces what: onehot_wide_kernel replaces
// src/repro/kernels/onehot_wide/kernel.py _onehot_wide_kernel. The TPU had
// no backward kernel: JAX differentiates the pure-jnp version
// (onehot_wide_ref, a take_along_axis), whose gradient is a scatter-add into
// W; onehot_wide_backward_kernel computes that scatter-add.
//
// The TPU kernel built a (BN, BK) one-hot tile of each column's codes and fed
// it to the MXU against a (BK, F) block of W, C * K * F multiply-adds per
// row, because a TPU core has no fast vector gather. Hopper has one, so the
// forward here is a direct gather-sum: one thread per output element (n, f)
// loops over the columns in ascending c, loads the code, skips it if it is
// out of range and adds W[c, code, f] into a float32 register, then stores
// once. The one-hot form's multiply-adds are all gone; what is left is below
// the memory line (the hopper-kernels guide, section 1). Summing in
// ascending c from +0.0 is the order of the TPU kernel's accumulation into
// its output tile, so in float32 the result equals it bit for bit. A
// bfloat16 W is widened to float32, summed there and rounded once.
//
// What bounds them on an H100: bytes. The forward reads 4 B of code per
// (c, n), one W row slice per distinct (c, code) and writes N * F values;
// the backward reads the codes and g and writes C * K * F floats (the zero
// fill is part of the output). At the Wide&Deep training shape (C = 2,
// N = 1,024, K = 50, F = 1) a launch moves about 13 KB, so launch latency,
// not bandwidth, sets the time.
//
// The backward zero-fills dW on the stream, then one thread per (c, n, f)
// with an in-range code adds g[n, f] into dW with a float atomic. The order
// of the atomics changes from run to run, so the gradient is not
// bit-reproducible; it lies within the float32 bound of two summation
// orders of the plain version (ref.py backward_sum_bound). Where few codes
// take many rows (K = 4 for the `device` column) the atomics of a warp land
// on a few addresses and serialise; warp-aggregated adds are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;  // grid-stride past this

long long blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return b > kMaxBlocks ? kMaxBlocks : b;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float* out, float x) { *out = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* out, float x) {
  *out = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) onehot_wide_kernel(
    const int* __restrict__ codes, const T* __restrict__ w,
    T* __restrict__ out, int n_cols, long long n, long long k, long long f) {
  const long long total = n * f;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < total; i += stride) {
    const long long row = i / f;
    const long long j = i - row * f;
    float acc = 0.0f;
    for (int c = 0; c < n_cols; ++c) {
      const int code = __ldg(codes + (long long)c * n + row);
      if (code >= 0 && (long long)code < k)
        acc += widen(w[((long long)c * k + code) * f + j]);
    }
    narrow(out + i, acc);
  }
}

__global__ void __launch_bounds__(kThreads) onehot_wide_backward_kernel(
    const int* __restrict__ codes, const float* __restrict__ g,
    float* __restrict__ dw, int n_cols, long long n, long long k,
    long long f) {
  const long long per_col = n * f;
  const long long total = (long long)n_cols * per_col;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < total; i += stride) {
    const long long c = i / per_col;
    const long long rem = i - c * per_col;
    const long long row = rem / f;
    const long long j = rem - row * f;
    const int code = __ldg(codes + c * n + row);
    if (code >= 0 && (long long)code < k)
      atomicAdd(dw + (c * k + code) * f + j, __ldg(g + rem));
  }
}

}  // namespace

// Launchers with a plain C interface (bound with ctypes): each launches on
// the caller's stream, allocates nothing, does not synchronise, and returns
// the first failing call's cudaError_t (0 = launched). The caller handles
// empty shapes without a launch. `bf16` selects a bfloat16 W and output.
extern "C" {

int onehot_wide(const int* codes, const void* w, void* out, int n_cols,
                long long n, long long k, long long f, int bf16,
                void* stream) {
  const unsigned int blocks = (unsigned int)blocks_for(n * f);
  if (bf16) {
    onehot_wide_kernel<__nv_bfloat16>
        <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
            codes, static_cast<const __nv_bfloat16*>(w),
            static_cast<__nv_bfloat16*>(out), n_cols, n, k, f);
  } else {
    onehot_wide_kernel<float><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        codes, static_cast<const float*>(w), static_cast<float*>(out), n_cols,
        n, k, f);
  }
  return (int)cudaGetLastError();
}

int onehot_wide_backward(const int* codes, const float* g, float* dw,
                         int n_cols, long long n, long long k, long long f,
                         void* stream) {
  cudaError_t err = cudaMemsetAsync(
      dw, 0, (size_t)n_cols * (size_t)k * (size_t)f * sizeof(float),
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return (int)cudaSuccess;
  onehot_wide_backward_kernel<<<(unsigned int)blocks_for((long long)n_cols *
                                                         n * f),
                                kThreads, 0, (cudaStream_t)stream>>>(
      codes, g, dw, n_cols, n, k, f);
  return (int)cudaGetLastError();
}

const char* onehot_wide_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
