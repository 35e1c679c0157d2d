// ADV gather kernels for Hopper (sm_90a): codes in, features out.
//
// Three kernels, one per serving path. Each writes a (rows, out_dim) float32
// feature matrix: output column j belongs to source column c = col_of[j],
// whose (K_c, F_c) ADV table sits row-major at tables[base_c ...] and whose
// features start at output column col_off_c. Per output element the kernel
// finds the row's code for column c, clamps it to [0, K_c - 1] and copies
// one float of that table row. A warp owns one output row at a time and its
// lanes stride over the row's out_dim columns, so stores are coalesced and
// no index division is needed.
//
// What replaces what (the TPU kernels are in src/repro/kernels/adv_gather/
// kernel.py):
//   packed_rows_kernel  <- _adv_gather_packed_rows_kernel
//   packed_range_kernel <- _adv_gather_packed_kernel
//   multi_kernel        <- _adv_gather_multi_kernel
// The TPU kernels gathered with a one-hot (or multi-hot) x block-diagonal
// table matmul on the MXU, because a TPU core has no fast scattered load.
// Hopper has one, so here the lookup is a direct load: for finite tables
// the result is identical, and the block diagonal (sum K x sum F floats,
// almost all zeros) is replaced by the per-column tables back to back.
//
// What bounds them on an H100: bytes, not operations. Per output row the
// kernels read the row index (4 B, rows kernel) or codes (4 B per column,
// multi kernel), one packed word per column (4 B; neighbouring rows share
// words), and write out_dim floats. The tables are K-row sized (kilobytes
// to a few MB) and stay in L2 across launches, so the output store
// dominates: 232 B per row at the serving width of 58 features against
// 4 + 16 B read. The design keeps the store coalesced (consecutive lanes,
// consecutive columns of one row) and reads each word through the
// read-only path (__ldg), where the lanes of a warp that share a column
// share one load. At the serving batch sizes (2,048 rows) a launch moves
// about half a megabyte, so launch latency, not bandwidth, sets the time;
// staging with cp.async/TMA and fusing launches are left to later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                 // 8 warps, one row each
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr long long kMaxBlocks = 132LL * 16;  // grid-stride past this

// tmeta row c (int32): K_c - 1, base offset of table c in floats, F_c,
// first output column of table c
struct TableMeta {
  int limit, base, dim, col_off;
};

__device__ __forceinline__ TableMeta table_meta(const int* __restrict__ tmeta,
                                                int c) {
  return TableMeta{__ldg(tmeta + 4 * c), __ldg(tmeta + 4 * c + 1),
                   __ldg(tmeta + 4 * c + 2), __ldg(tmeta + 4 * c + 3)};
}

// Feature j of table row `code`, the code clamped into the table first.
// A code read from a 32-bit field >= 2**31 is negative as int32 and clamps
// to row 0, as the TPU kernel's astype(int32) + clip did.
__device__ __forceinline__ float lookup(const float* __restrict__ tables,
                                        const TableMeta& m, int code, int j) {
  code = code < 0 ? 0 : (code > m.limit ? m.limit : code);
  return __ldg(tables + (long long)m.base + (long long)code * m.dim +
               (j - m.col_off));
}

// Code of table row r in the column whose words start at word_off, packed
// at db bits (db divides 32, so no field straddles a word). The word index
// is clamped to the stream: an index past the end never reads out of
// bounds (callers keep rows inside the stream's capacity).
__device__ __forceinline__ int packed_code(const uint32_t* __restrict__ words,
                                           long long n_words, int word_off,
                                           int db, long long r) {
  if (r < 0) r = 0;
  const int s = 32 / db;
  long long widx = word_off + r / s;
  if (widx > n_words - 1) widx = n_words - 1;
  uint32_t field = __ldg(words + widx) >> ((int)(r % s) * db);
  if (db < 32) field &= (1u << db) - 1u;
  return (int)field;
}

// One output row from packed words: lanes stride over the columns.
__device__ __forceinline__ void packed_row(
    long long r, float* __restrict__ out_row, int out_dim, int lane,
    const uint32_t* __restrict__ words, long long n_words,
    const int* __restrict__ wmeta, const int* __restrict__ tmeta,
    const int* __restrict__ col_of, const float* __restrict__ tables) {
  for (int j = lane; j < out_dim; j += 32) {
    const int c = __ldg(col_of + j);
    const int code = packed_code(words, n_words, __ldg(wmeta + 2 * c),
                                 __ldg(wmeta + 2 * c + 1), r);
    out_row[j] = lookup(tables, table_meta(tmeta, c), code, j);
  }
}

__global__ void __launch_bounds__(kThreads) packed_rows_kernel(
    const int* __restrict__ rows, long long n,
    const uint32_t* __restrict__ words, long long n_words,
    const int* __restrict__ wmeta, const int* __restrict__ tmeta,
    const int* __restrict__ col_of, const float* __restrict__ tables,
    float* __restrict__ out, int out_dim) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarpsPerBlock;
  for (long long i = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       i < n; i += stride) {
    packed_row(__ldg(rows + i), out + i * out_dim, out_dim, lane, words,
               n_words, wmeta, tmeta, col_of, tables);
  }
}

// blockIdx.y selects the range: rows starts[k] .. starts[k] + batch - 1
// land in output rows k * batch .. k * batch + batch - 1. Neighbouring
// warps take neighbouring rows, so their word loads fall in the same
// cache lines.
__global__ void __launch_bounds__(kThreads) packed_range_kernel(
    const int* __restrict__ starts, int batch,
    const uint32_t* __restrict__ words, long long n_words,
    const int* __restrict__ wmeta, const int* __restrict__ tmeta,
    const int* __restrict__ col_of, const float* __restrict__ tables,
    float* __restrict__ out, int out_dim) {
  const int lane = threadIdx.x & 31;
  const long long k = blockIdx.y;
  const long long start = __ldg(starts + k);
  const long long stride = (long long)gridDim.x * kWarpsPerBlock;
  for (long long i = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       i < batch; i += stride) {
    packed_row(start + i, out + (k * batch + i) * out_dim, out_dim, lane,
               words, n_words, wmeta, tmeta, col_of, tables);
  }
}

// codes (C, n) int32, raw per-column codes: the clamp and the table offset
// happen here, fused into the lookup.
__global__ void __launch_bounds__(kThreads) multi_kernel(
    const int* __restrict__ codes, long long n,
    const int* __restrict__ tmeta, const int* __restrict__ col_of,
    const float* __restrict__ tables, float* __restrict__ out, int out_dim) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarpsPerBlock;
  for (long long i = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       i < n; i += stride) {
    float* out_row = out + i * out_dim;
    for (int j = lane; j < out_dim; j += 32) {
      const int c = __ldg(col_of + j);
      out_row[j] = lookup(tables, table_meta(tmeta, c),
                          __ldg(codes + (long long)c * n + i), j);
    }
  }
}

unsigned int blocks_for(long long rows) {
  long long b = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return (unsigned int)(b < 1 ? 1 : b);
}

}  // namespace

// Launchers with a plain C interface (bound with ctypes). Each launches on
// the caller's stream, allocates nothing, does not synchronise, and returns
// the launch's cudaError_t (0 = launched).
extern "C" {

int adv_gather_packed_rows(const int* rows, long long n, const int* words,
                           long long n_words, const int* wmeta,
                           const int* tmeta, const int* col_of,
                           const float* tables, float* out, int out_dim,
                           void* stream) {
  packed_rows_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      rows, n, reinterpret_cast<const uint32_t*>(words), n_words, wmeta,
      tmeta, col_of, tables, out, out_dim);
  return (int)cudaGetLastError();
}

int adv_gather_packed(const int* starts, int n_ranges, int batch,
                      const int* words, long long n_words, const int* wmeta,
                      const int* tmeta, const int* col_of, const float* tables,
                      float* out, int out_dim, void* stream) {
  dim3 grid(blocks_for(batch), (unsigned int)n_ranges);
  packed_range_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      starts, batch, reinterpret_cast<const uint32_t*>(words), n_words, wmeta,
      tmeta, col_of, tables, out, out_dim);
  return (int)cudaGetLastError();
}

int gather_fused_parts(const int* codes, long long n, const int* tmeta,
                       const int* col_of, const float* tables, float* out,
                       int out_dim, void* stream) {
  multi_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      codes, n, tmeta, col_of, tables, out, out_dim);
  return (int)cudaGetLastError();
}

const char* adv_gather_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
