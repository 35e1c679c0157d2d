// ADV gather kernels for Hopper (sm_90a): codes in, features out.
//
// Three kernels, one per serving path, and the single-table gather of the
// Table 6 featurization path (single_f1_kernel and single_rows_kernel, at
// the end of this comment). Each of the three writes a (rows, out_dim)
// float32 feature matrix: output column j belongs to source column
// c = col_of[j], whose (K_c, F_c) ADV table sits row-major at
// tables[base_c ...] and whose features start at output column col_off_c.
// Per output element the kernel finds the row's code for column c, clamps
// it to [0, K_c - 1] and copies one float of that table row.
//
// What replaces what (the TPU kernels are in src/repro/kernels/adv_gather/
// kernel.py):
//   packed_rows_kernel  <- _adv_gather_packed_rows_kernel
//   packed_range_kernel <- _adv_gather_packed_kernel
//   multi_kernel        <- _adv_gather_multi_kernel
//   single_f1_kernel,
//   single_rows_kernel  <- _adv_gather_kernel
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
// 4 + 16 B read. At the serving batch sizes (2,048 rows) a launch moves
// about half a megabyte, so latency, not bandwidth, sets the time: the
// chain of dependent loads from a row index to its store.
//
// packed_range_kernel and multi_kernel: a warp owns one output row at a
// time and its lanes stride over the row's out_dim columns, so stores are
// coalesced and no index division is needed; each lane runs the whole
// chain (metadata, word, table) for its element.
//
// packed_rows_kernel shortens that chain. A block stages col_of and the
// table metadata in shared memory once, and takes tiles of kTileRows rows:
// first one thread per (row, column) loads the row index and its packed
// word (metadata through __ldg, in parallel with the index), extracts and
// clamps the code into shared memory, C word loads per row instead of one
// per output element; after a barrier, one thread per output element walks
// the tile's (row, j) elements flattened row-major, so stores coalesce
// across row boundaries and no lane idles at out_dim 58, and copies its
// table entry. The chain is rows[i] -> word -> barrier -> table -> store.
// 8-row tiles put the serving path's 2,048-row launch on 256 blocks, one
// wave of the 132 SMs (two blocks an SM), each thread with about two
// elements.
//
// The single-table gather is adv_gather(table, codes): codes of any shape
// (n int32 in all), each clamped to [0, K - 1], and one (K, F) table of
// float32 or bfloat16 -> (n, F) in the table's type. The reference sent
// K > 2**16 to jnp.take(mode="clip") because its one-hot tile had to fit in
// VMEM; that is the same function, and here one launch serves every K. The
// table's rows are copied as raw bits (4 or 2 bytes), so the output is the
// table's rows bit for bit (for finite tables the one-hot product with one
// nonzero term equals them). Bytes bound it: 4 B of code per row read and
// n * F elements written; for `zscore` over the 2**25-row Table 6 column,
// 128 MiB of codes and 128 MiB of features, about 0.080 ms at 3.35 TB/s.
// The table is read through L1/L2 (__ldg); zscore's 3,996 B stay in L1.
// At F = 1 (zscore and eight of the ten Table 6 ADVs) each thread
// takes four consecutive codes with one 16-byte load and stores its four
// elements with one 16-byte (float32) or 8-byte (bfloat16) write, with no
// division, the layout of bitunpack.cu; codes that are not 16-byte aligned
// (a view such as codes[1:]) and the ragged end go one by one. At F > 1 a
// group of lanes (a power of two up to 32) owns a row: the code is loaded
// once per row, and the row is copied in 16-byte units where F times the
// element size is a multiple of 16 and both buffers are 16-byte aligned,
// else element by element. Offsets are 64-bit per row, so n * F >= 2**32
// needs no other route.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../packed_code.cuh"

namespace {

constexpr int kThreads = 256;                 // 8 warps, one row each
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr long long kMaxBlocks = 132LL * 16;  // grid-stride past this
constexpr int kTileRows = 8;                  // rows per packed-rows tile
constexpr int kUnroll = 4;                    // its elements per thread pass
constexpr size_t kDefaultShared = 48 * 1024;  // above: opt in per kernel
constexpr size_t kSharedLimit = 232448;       // 227 KB: a block's maximum
constexpr long long kSingleMaxBlocks = 0x7fffffffLL;  // one step a thread

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

// Dynamic shared memory of packed_rows_kernel: col_of (out_dim int32,
// padded to 16 B), the table metadata (C x int4) and a tile's codes
// (kTileRows x C int32).
size_t rows_shared_bytes(int out_dim, int n_cols) {
  return (size_t)((out_dim + 3) & ~3) * 4 + (size_t)n_cols * 16 +
         (size_t)kTileRows * n_cols * 4;
}

__global__ void __launch_bounds__(kThreads) packed_rows_kernel(
    const int* __restrict__ rows, long long n,
    const uint32_t* __restrict__ words, long long n_words,
    const int* __restrict__ wmeta, const int* __restrict__ tmeta,
    const int* __restrict__ col_of, const float* __restrict__ tables,
    float* __restrict__ out, int out_dim, int n_cols) {
  extern __shared__ __align__(16) unsigned char dyn_shared[];
  int* s_col = reinterpret_cast<int*>(dyn_shared);
  int4* s_meta = reinterpret_cast<int4*>(s_col + ((out_dim + 3) & ~3));
  int* s_code = reinterpret_cast<int*>(s_meta + n_cols);
  for (int j = threadIdx.x; j < out_dim; j += kThreads)
    s_col[j] = __ldg(col_of + j);
  for (int c = threadIdx.x; c < n_cols; c += kThreads)
    s_meta[c] = make_int4(__ldg(tmeta + 4 * c), __ldg(tmeta + 4 * c + 1),
                          __ldg(tmeta + 4 * c + 2), __ldg(tmeta + 4 * c + 3));
  for (long long r0 = (long long)blockIdx.x * kTileRows; r0 < n;
       r0 += (long long)gridDim.x * kTileRows) {
    const int tile = (int)(n - r0 < kTileRows ? n - r0 : kTileRows);
    // one thread per (row, column): the row's clamped code of that column
    for (int s = threadIdx.x; s < tile * n_cols; s += kThreads) {
      const int r = s / n_cols, c = s - r * n_cols;
      const int limit = __ldg(tmeta + 4 * c);
      const int code = packed_code(words, n_words, __ldg(wmeta + 2 * c),
                                   __ldg(wmeta + 2 * c + 1),
                                   __ldg(rows + r0 + r));
      s_code[s] = code < 0 ? 0 : (code > limit ? limit : code);
    }
    __syncthreads();
    // one thread per output element of the tile, row-major; a thread's
    // table loads (up to kUnroll) are all issued before its stores
    float* __restrict__ out_tile = out + r0 * out_dim;
    const int elems = tile * out_dim;
    for (int e0 = threadIdx.x; e0 < elems; e0 += kUnroll * kThreads) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + u * kThreads;
        if (e < elems) {
          const int r = e / out_dim, j = e - r * out_dim;
          const int c = s_col[j];
          const int4 m = s_meta[c];
          v[u] = __ldg(tables + (long long)m.y +
                       (long long)s_code[r * n_cols + c] * m.z + (j - m.w));
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (e0 + u * kThreads < elems) out_tile[e0 + u * kThreads] = v[u];
    }
    __syncthreads();                     // s_code is free for the next tile
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

// The single-table gather: codes (n,) int32, table (limit + 1, F) -> out
// (n, F). T is an unsigned integer of the element's width (the kernels copy
// bits), or uint4 for 16-byte units of a row.

// Four elements of T as one store: 16 bytes of float32, 8 of bfloat16.
template <typename T>
struct Quad;
template <>
struct Quad<uint32_t> {
  using type = uint4;
  static __device__ __forceinline__ uint4 make(uint32_t a, uint32_t b,
                                               uint32_t c, uint32_t d) {
    return make_uint4(a, b, c, d);
  }
};
template <>
struct Quad<uint16_t> {
  using type = uint2;
  static __device__ __forceinline__ uint2 make(uint16_t a, uint16_t b,
                                               uint16_t c, uint16_t d) {
    return make_uint2((uint32_t)a | ((uint32_t)b << 16),
                      (uint32_t)c | ((uint32_t)d << 16));
  }
};

__device__ __forceinline__ int clamp_code(int code, int limit) {
  return code < 0 ? 0 : (code > limit ? limit : code);
}

// F = 1: thread t copies rows 4t .. 4t + 3.
template <typename T>
__global__ void __launch_bounds__(kThreads) single_f1_kernel(
    const int* __restrict__ codes, long long n, int limit,
    const T* __restrict__ table, T* __restrict__ out) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long done = 0;                    // rows copied four at a time
  if ((reinterpret_cast<uintptr_t>(codes) & 15) == 0) {
    const long long quads = n >> 2;
    for (long long t = first; t < quads; t += stride) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(codes) + t);
      reinterpret_cast<typename Quad<T>::type*>(out)[t] = Quad<T>::make(
          __ldg(table + clamp_code(v.x, limit)),
          __ldg(table + clamp_code(v.y, limit)),
          __ldg(table + clamp_code(v.z, limit)),
          __ldg(table + clamp_code(v.w, limit)));
    }
    done = quads << 2;
  }
  for (long long i = done + first; i < n; i += stride)
    out[i] = __ldg(table + clamp_code(__ldg(codes + i), limit));
}

// F > 1: a group of 2**group_log2 lanes owns a row of `units` units of U.
template <typename U>
__global__ void __launch_bounds__(kThreads) single_rows_kernel(
    const int* __restrict__ codes, long long n, int limit, long long units,
    int group_log2, const U* __restrict__ table, U* __restrict__ out) {
  const int group = 1 << group_log2;
  const int sub = threadIdx.x & (group - 1);
  const long long stride = ((long long)gridDim.x * kThreads) >> group_log2;
  for (long long r =
           ((long long)blockIdx.x * kThreads + threadIdx.x) >> group_log2;
       r < n; r += stride) {
    const long long src =
        (long long)clamp_code(__ldg(codes + r), limit) * units;
    U* __restrict__ dst = out + r * units;
    for (long long j = sub; j < units; j += group)
      dst[j] = __ldg(table + src + j);
  }
}

long long grid_for(long long threads) {
  long long b = (threads + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return b > kSingleMaxBlocks ? kSingleMaxBlocks : b;
}

template <typename U>
void launch_rows(const int* codes, long long n, int limit, long long units,
                 const void* table, void* out, cudaStream_t stream) {
  int group_log2 = 0;
  while ((1LL << group_log2) < units && group_log2 < 5) ++group_log2;
  single_rows_kernel<U><<<(unsigned int)grid_for(n << group_log2), kThreads,
                          0, stream>>>(codes, n, limit, units, group_log2,
                                       static_cast<const U*>(table),
                                       static_cast<U*>(out));
}

template <typename T>
void launch_single(const int* codes, long long n, int limit, long long dim,
                   const void* table, void* out, cudaStream_t stream) {
  const size_t row_bytes = (size_t)dim * sizeof(T);
  if (dim == 1) {
    single_f1_kernel<T><<<(unsigned int)grid_for((n + 3) / 4), kThreads, 0,
                          stream>>>(codes, n, limit,
                                    static_cast<const T*>(table),
                                    static_cast<T*>(out));
  } else if (row_bytes % 16 == 0 &&
             ((reinterpret_cast<uintptr_t>(table) |
               reinterpret_cast<uintptr_t>(out)) & 15) == 0) {
    launch_rows<uint4>(codes, n, limit, (long long)(row_bytes / 16), table,
                       out, stream);
  } else {
    launch_rows<T>(codes, n, limit, dim, table, out, stream);
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

// A plan whose col_of, metadata and tile codes pass the 227 KB of shared
// memory a block may take (out_dim past about 58,000) is refused with
// cudaErrorInvalidValue.
int adv_gather_packed_rows(const int* rows, long long n, const int* words,
                           long long n_words, const int* wmeta,
                           const int* tmeta, const int* col_of,
                           const float* tables, float* out, int out_dim,
                           int n_cols, void* stream) {
  const size_t shared = rows_shared_bytes(out_dim, n_cols);
  if (shared > kSharedLimit) return (int)cudaErrorInvalidValue;
  if (shared > kDefaultShared) {
    const cudaError_t err = cudaFuncSetAttribute(
        packed_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  long long blocks = (n + kTileRows - 1) / kTileRows;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  packed_rows_kernel<<<(unsigned int)blocks, kThreads, shared,
                       (cudaStream_t)stream>>>(
      rows, n, reinterpret_cast<const uint32_t*>(words), n_words, wmeta,
      tmeta, col_of, tables, out, out_dim, n_cols);
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

// `elem_bytes` is the table's element width: 4 (float32) or 2 (bfloat16).
// The caller handles an empty output without a launch.
int adv_gather(const int* codes, long long n, const void* table, int k,
               long long dim, int elem_bytes, void* out, void* stream) {
  if (elem_bytes == 4) {
    launch_single<uint32_t>(codes, n, k - 1, dim, table, out,
                            (cudaStream_t)stream);
  } else if (elem_bytes == 2) {
    launch_single<uint16_t>(codes, n, k - 1, dim, table, out,
                            (cudaStream_t)stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* adv_gather_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
