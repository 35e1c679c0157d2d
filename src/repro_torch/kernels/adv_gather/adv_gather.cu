// ADV gather kernels for Hopper (sm_90a): codes in, features out.
//
// Three kernels, one per serving path, and the single-table gather of the
// Table 6 featurization path (single_f1_kernel and single_rows_kernel, at
// the end of this comment). Each of the three writes a (rows, out_dim)
// float32 feature matrix: output column j belongs to source column
// c = jmeta[j].x, whose (K_c, F_c) ADV table sits row-major at
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
// 4 + 16 B read. At the serving and train batch sizes (512 to 2,048 rows)
// a launch moves a few hundred kilobytes at most, so latency, not
// bandwidth, sets the time: the chain of dependent loads from a row index
// or code to its store, and the launch itself (a one-element fill takes
// about 1 us of device time).
//
// All three give every output element its own thread, so no lane idles at
// out_dim 4 or 58 and stores coalesce across row boundaries, and cut the
// chain of dependent loads. Which element a thread takes depends on the
// thread alone, so it loads its column's addressing when it starts: jmeta
// row j (table c, row 0's entry of column j, F_c, K_c - 1), one 16-byte
// load.
//
// packed_range_kernel (K ranges of batch rows; the executor's start at a
// multiple of 32): range k's output is one contiguous batch x out_dim
// block, blockIdx.y the range, and a thread takes one element of it. Its
// column's word addressing is wmeta row jmeta[j].x, an 8-byte load that
// L1 serves: the chain is (start, jmeta) -> wmeta -> word -> table ->
// store, two metadata loads an element where the warp-per-row layout it
// replaced made seven (col_of, then wmeta and four table words) and left
// 6 of 32 lanes idle in a second pass at out_dim 58. What lost in same-run
// A/Bs (PERF.md §6): the word addressing staged in shared memory a block,
// the tables staged in shared memory or prefetched into L1 a block, and
// tiles whose codes go to shared memory before a copy pass, because a
// barrier plus shared loads cost more than the L2 round trip they save at
// a few microseconds; four elements a thread with one 16-byte store, at
// par at the executor's launch and slower at smaller ones, where it leaves
// too few blocks to fill the SMs; the word addressing handed from lane to
// lane by __shfl_sync, at par at the executor's launch.
//
// multi_kernel (int32 codes, (C, n)): one thread per element, no shared
// memory and no barrier. Beside jmeta row j the thread loads its row's codes
// of every column (up to kRowCodes; the threads of one row load the same
// words), keeps column c's and clamps it: the chain is (jmeta, codes) ->
// table -> store, one global round trip shorter than the warp-per-row
// layout's col_of -> (metadata, code) -> table -> store, which left 28 of
// 32 lanes idle at the train path's out_dim of 4. Tiling it like
// packed_rows_kernel (codes staged in shared memory, then a barrier) read
// 0.1-0.6 us slower at the train shape than the warp-per-row kernel: with
// L2-resident codes a barrier and shared loads cost more than the round
// trip they save.
//
// packed_rows_kernel is tiled, because its codes cost a packed-word load
// each (the 109 MB stream is twice L2): a block takes tiles of 8 rows, and
// first one thread per (row, column) loads the row index and its packed
// word and puts the clamped code in shared memory, C word loads per row
// instead of one per output element. After a barrier, one thread per output
// element walks the tile row-major (copy_tile) and copies its table entry.
// The chain is rows[i] -> word -> barrier -> table -> store; jmeta is
// loaded at the start and held in registers past the barrier (hold), which
// read 0.19 us faster than letting the compiler sink it to its use. 8-row
// tiles put the serving path's 2,048-row launch on 256 blocks, one wave of
// the 132 SMs (two blocks an SM), each thread with about two elements.
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

constexpr int kThreads = 256;                 // 8 warps
constexpr long long kMaxBlocks = 132LL * 16;  // grid-stride past this
constexpr int kTileRows = 8;                  // rows per packed-rows tile
constexpr int kUnroll = 4;                    // tile elements a thread pass
constexpr int kRowCodes = 8;                  // multi_kernel's codes a row
constexpr size_t kDefaultShared = 48 * 1024;  // above: opt in per kernel
constexpr size_t kSharedLimit = 232448;       // 227 KB: a block's maximum
constexpr long long kSingleMaxBlocks = 0x7fffffffLL;  // one step a thread

// Dynamic shared memory of packed_rows_kernel: a tile's codes (kTileRows x
// C int32).
size_t rows_shared_bytes(int n_cols) {
  return (size_t)kTileRows * n_cols * 4;
}

__device__ __forceinline__ int clamp_code(int code, int limit) {
  return code < 0 ? 0 : (code > limit ? limit : code);
}

// A thread's output elements in the first pass over a tile, row-major from
// the tile's first element: e = threadIdx.x + u * kThreads is row e /
// out_dim, column j = e % out_dim, and jmeta row j (table c, row 0's entry
// of column j, F_c). They depend on the thread alone, so they are found
// and loaded when the kernel starts, with the first codes, and no division
// or metadata load waits for a tile's codes.
struct TileElems {
  int row[kUnroll];
  int4 jm[kUnroll];
};

__device__ __forceinline__ TileElems tile_elems(const int4* __restrict__ jmeta,
                                                int out_dim, int elems) {
  TileElems te;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int e = threadIdx.x + u * kThreads;
    te.row[u] = 0;
    te.jm[u] = make_int4(0, 0, 0, 0);
    if (e < elems) {
      te.row[u] = e / out_dim;
      te.jm[u] = __ldg(jmeta + (e - te.row[u] * out_dim));
    }
  }
  return te;
}

// Keeps te's loads before the barrier that follows: the compiler may
// otherwise sink them to their use, a global round trip after it.
__device__ __forceinline__ void hold(const TileElems& te) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    asm volatile("" ::"r"(te.row[u]), "r"(te.jm[u].x), "r"(te.jm[u].y),
                 "r"(te.jm[u].z));
}

__device__ __forceinline__ float tile_entry(const float* __restrict__ tables,
                                            const int* s_code, int row,
                                            int n_cols, int4 jm) {
  return __ldg(tables + (long long)jm.y +
               (long long)s_code[row * n_cols + jm.x] * jm.z);
}

// One thread per output element of a tile of `tile` rows, row-major from
// out_tile, each copying its table entry by its clamped code in s_code:
// the first kUnroll x kThreads elements by `te`, their table loads all
// issued before their stores, and any past them (a tile wider than that)
// one by one.
__device__ __forceinline__ void copy_tile(const TileElems& te,
                                          const int4* __restrict__ jmeta,
                                          const int* s_code,
                                          const float* __restrict__ tables,
                                          float* __restrict__ out_tile,
                                          int tile, int out_dim, int n_cols) {
  const int elems = tile * out_dim;
  float v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if ((int)threadIdx.x + u * kThreads < elems)
      v[u] = tile_entry(tables, s_code, te.row[u], n_cols, te.jm[u]);
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if ((int)threadIdx.x + u * kThreads < elems)
      out_tile[threadIdx.x + u * kThreads] = v[u];
  for (int e = threadIdx.x + kUnroll * kThreads; e < elems; e += kThreads) {
    const int r = e / out_dim;
    out_tile[e] = tile_entry(tables, s_code, r, n_cols,
                             __ldg(jmeta + (e - r * out_dim)));
  }
}

__global__ void __launch_bounds__(kThreads) packed_rows_kernel(
    const int* __restrict__ rows, long long n,
    const uint32_t* __restrict__ words, long long n_words,
    const int* __restrict__ wmeta, const int* __restrict__ tmeta,
    const int4* __restrict__ jmeta, const float* __restrict__ tables,
    float* __restrict__ out, int out_dim, int n_cols) {
  extern __shared__ __align__(16) unsigned char dyn_shared[];
  int* s_code = reinterpret_cast<int*>(dyn_shared);  // [row * n_cols + c]
  const long long tile_max = n < kTileRows ? n : kTileRows;
  const TileElems te = tile_elems(jmeta, out_dim, (int)tile_max * out_dim);
  for (long long r0 = (long long)blockIdx.x * kTileRows; r0 < n;
       r0 += (long long)gridDim.x * kTileRows) {
    const int tile = (int)(n - r0 < kTileRows ? n - r0 : kTileRows);
    // one thread per (row, column): the row's clamped code of that column
    for (int s = threadIdx.x; s < tile * n_cols; s += kThreads) {
      const int r = s / n_cols, c = s - r * n_cols;
      s_code[s] = clamp_code(
          packed_code(words, n_words, __ldg(wmeta + 2 * c),
                      __ldg(wmeta + 2 * c + 1), __ldg(rows + r0 + r)),
          __ldg(tmeta + 4 * c));
    }
    hold(te);
    __syncthreads();
    copy_tile(te, jmeta, s_code, tables, out + r0 * out_dim, tile, out_dim,
              n_cols);
    __syncthreads();                     // the codes are free for the next tile
  }
}

// The range gather (see the top of the file). Range k's output is one
// contiguous batch x out_dim block, so its element e is row e / out_dim,
// column e % out_dim; kNarrow (batch x out_dim < 2**32) divides in 32 bits.
template <bool kNarrow>
__global__ void __launch_bounds__(kThreads) packed_range_kernel(
    const int* __restrict__ starts, int batch,
    const uint32_t* __restrict__ words, long long n_words,
    const int2* __restrict__ wmeta, const int4* __restrict__ jmeta,
    const float* __restrict__ tables, float* __restrict__ out, int out_dim) {
  const long long total = (long long)batch * out_dim;
  const long long start = __ldg(starts + blockIdx.y);
  float* __restrict__ out_k = out + (long long)blockIdx.y * total;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
       e < total; e += (long long)gridDim.x * kThreads) {
    const long long i = kNarrow ? (long long)((uint32_t)e / (uint32_t)out_dim)
                                : e / out_dim;
    const int4 jm = __ldg(jmeta + (int)(e - i * out_dim));
    const int2 wm = __ldg(wmeta + jm.x);
    // fuse_tables keeps every table entry's index below 2**31
    out_k[e] = __ldg(tables + jm.y +
                     clamp_code(packed_code(words, n_words, wm.x, wm.y,
                                            start + i),
                                jm.w) * jm.z);
  }
}

// codes (C, n) int32, raw per-column codes: the clamp and the table offset
// happen here, fused into the lookup. One thread per output element, row r
// = e / out_dim and column j = e % out_dim: it loads jmeta row j and, with
// it, its row's codes of every column (up to kRowCodes; threads of one row
// load the same words), takes the code of table jmeta.x, clamps it and
// copies the table entry. No shared memory, no barrier: the chain is
// (jmeta, codes) -> table -> store.
__global__ void __launch_bounds__(kThreads) multi_kernel(
    const int* __restrict__ codes, long long n,
    const int4* __restrict__ jmeta, const float* __restrict__ tables,
    float* __restrict__ out, int out_dim, int n_cols) {
  const long long total = n * out_dim;
  const bool narrow = total <= 0xffffffffLL;   // 32-bit division suffices
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
       e < total; e += (long long)gridDim.x * kThreads) {
    const long long r =
        narrow ? (long long)((uint32_t)e / (uint32_t)out_dim) : e / out_dim;
    const int4 jm = __ldg(jmeta + (int)(e - r * out_dim));
    int code;
    if (n_cols <= kRowCodes) {
      int v[kRowCodes];
#pragma unroll
      for (int c = 0; c < kRowCodes; ++c)
        if (c < n_cols) v[c] = __ldg(codes + c * n + r);
      code = v[0];
#pragma unroll
      for (int c = 1; c < kRowCodes; ++c)
        if (c == jm.x) code = v[c];
    } else {
      code = __ldg(codes + (long long)jm.x * n + r);
    }
    out[e] = __ldg(tables + (long long)jm.y +
                   (long long)clamp_code(code, jm.w) * jm.z);
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

}  // namespace

// Launchers with a plain C interface (bound with ctypes). Each launches on
// the caller's stream, allocates nothing, does not synchronise, and returns
// the launch's cudaError_t (0 = launched).
extern "C" {

// A plan whose tile codes pass the 227 KB of shared memory a block may take
// (more than 7,264 columns) is refused with cudaErrorInvalidValue.
int adv_gather_packed_rows(const int* rows, long long n, const int* words,
                           long long n_words, const int* wmeta,
                           const int* tmeta, const int* jmeta,
                           const float* tables, float* out, int out_dim,
                           int n_cols, void* stream) {
  const size_t shared = rows_shared_bytes(n_cols);
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
      tmeta, reinterpret_cast<const int4*>(jmeta), tables, out, out_dim,
      n_cols);
  return (int)cudaGetLastError();
}

int adv_gather_packed(const int* starts, int n_ranges, int batch,
                      const int* words, long long n_words, const int* wmeta,
                      const int* jmeta, const float* tables, float* out,
                      int out_dim, void* stream) {
  const long long total = (long long)batch * out_dim;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid((unsigned int)blocks, (unsigned int)n_ranges);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(words);
  const int2* wm = reinterpret_cast<const int2*>(wmeta);
  const int4* jm = reinterpret_cast<const int4*>(jmeta);
  if (total <= 0xffffffffLL)   // 32-bit division suffices
    packed_range_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        starts, batch, w, n_words, wm, jm, tables, out, out_dim);
  else
    packed_range_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        starts, batch, w, n_words, wm, jm, tables, out, out_dim);
  return (int)cudaGetLastError();
}

int gather_fused_parts(const int* codes, long long n, const int* jmeta,
                       const float* tables, float* out, int out_dim,
                       int n_cols, void* stream) {
  long long blocks = (n * out_dim + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  multi_kernel<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      codes, n, reinterpret_cast<const int4*>(jmeta), tables, out, out_dim,
      n_cols);
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
