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
// W; the backward kernels below compute that scatter-add.
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
// entries are part of the output). At the Wide&Deep training shape (C = 2,
// N = 1,024, K = 50, F = 1) a launch moves about 13 KB, so latency, not
// bandwidth, sets the time: for the backward, the chain of dependent adds
// an owner runs.
//
// The backward owns its output: each dW entry (c, code, f) is the sum of
// g[n, f] over the rows n whose code in column c is `code`, in ascending n
// from +0.0, written exactly once (+0.0 where no row has the code). There
// is no zero fill and no atomic add of floats. That order is the plain
// version's (index_add_ on the CPU) and that of jax.grad of the JAX
// package's onehot_wide_ref, so in float32 the gradient equals both bit for
// bit, and it is the same in every run. Only additions are involved, so
// -O3's multiply-add contraction cannot reorder anything. Two routes,
// chosen by size in the launcher:
//   scan     up to kScanRows (2,048) rows and kScanLimit warp steps: one
//            launch; each block stages its column's codes (and g at F = 1)
//            through shared memory in 1,024-row tiles, and every owner
//            walks every row, so its time grows with N. At F = 1
//            (backward_scan_f1_kernel) a thread owns a code and adds each
//            row's g or +0.0, the staged code and g a step reads being the
//            same address for every thread of the block (a broadcast): the
//            train shape (C, N, K, F) = (2, 1,024, 50, 1). At F > 1
//            (backward_scan_rows_kernel) a warp owns a code and 32 of its
//            features; a ballot over 32 rows at a time finds the matching
//            rows, whose g loads are coalesced across the lanes.
//   grouped  past either limit: a stable counting sort of each column's
//            rows by code over row tiles, in parallel across the tiles
//            (group_count_kernel, group_scan_kernel, group_scatter_kernel;
//            integer counts and places, exact in any order), then owners
//            that sum only their own rows (group_sum_f1_kernel, a warp a
//            code, its g placed in order and added by one lane from shared
//            memory; group_sum_rows_kernel, a warp a code and 32 features).
//            Work O(C * N * F + C * K * F); an owner's chain of adds is its
//            code's rows, not N. Four launches, timed together (the
//            wrapper's one call). Codes are counted and placed kWindow at a
//            time, so past K = 4,096 a tile is walked once per window.

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

constexpr int kTile = 1024;                // rows staged per pass (scan)
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;         // grouped route's scan block
constexpr int kScanRun = 8;                // counts a scan thread takes
constexpr int kSumChunk = 128;             // placed g a summing warp reads
constexpr int kWindow = 4096;              // codes counted per pass
constexpr unsigned kFull = 0xffffffffu;
// The scan route's most rows, and its most work in warp steps (some 0.2 ms
// of issue over the 132 SMs); past either the grouped route is used.
constexpr long long kScanRows = 2048;
constexpr long long kScanLimit = 1LL << 26;

// Block b of a C * blocks_per_col grid serves column b / blocks_per_col;
// `b` is its index among that column's blocks.
struct Slot {
  long long c, b;
};

__device__ __forceinline__ Slot slot_of(long long blocks_per_col) {
  const long long c = blockIdx.x / blocks_per_col;
  return Slot{c, blockIdx.x - c * blocks_per_col};
}

// Rows n0 .. n0 + rows - 1 of the column's codes (and of g, where it is
// given) into shared memory, after the last tile is consumed.
__device__ __forceinline__ void stage_tile(const int* __restrict__ col,
                                           const float* __restrict__ g,
                                           long long n0, int rows,
                                           int* s_code, float* s_g) {
  __syncthreads();
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    s_code[i] = __ldg(col + n0 + i);
    if (g != nullptr) s_g[i] = __ldg(g + n0 + i);
  }
  __syncthreads();
}

// Scan route at F = 1: thread t of the column's block b owns code
// b * kThreads + t and walks every row. Branch-free: a row without the
// code adds +0.0, which leaves acc's bits as they are (acc starts at +0.0,
// and a float sum is -0.0 only when both terms are), so the sum is the
// matching rows' alone. Eight rows a step, the next step's shared loads
// issued before this step's adds: only the adds form the chain.
__global__ void __launch_bounds__(kThreads) backward_scan_f1_kernel(
    const int* __restrict__ codes, const float* __restrict__ g,
    float* __restrict__ dw, long long n, long long k,
    long long blocks_per_col) {
  __shared__ __align__(16) int s_code[kTile];
  __shared__ __align__(16) float s_g[kTile];
  const Slot s = slot_of(blocks_per_col);
  const long long x = s.b * kThreads + threadIdx.x;
  const bool owns = x < k;
  const int code = (int)x;
  const int4* __restrict__ c4 = reinterpret_cast<const int4*>(s_code);
  const float4* __restrict__ g4 = reinterpret_cast<const float4*>(s_g);
  float acc = 0.0f;
  for (long long n0 = 0; n0 < n; n0 += kTile) {
    const int rows = (int)(n - n0 < kTile ? n - n0 : kTile);
    stage_tile(codes + s.c * n, g, n0, rows, s_code, s_g);
    if (!owns) continue;
    const int steps = rows >> 3;
    if (steps > 0) {
      int4 xa = c4[0], xb = c4[1];
      float4 va = g4[0], vb = g4[1];
      for (int q = 0; q < steps; ++q) {
        const int nq = q + 1 < steps ? q + 1 : q;
        const int4 ya = c4[2 * nq], yb = c4[2 * nq + 1];
        const float4 wa = g4[2 * nq], wb = g4[2 * nq + 1];
        acc += xa.x == code ? va.x : 0.0f;
        acc += xa.y == code ? va.y : 0.0f;
        acc += xa.z == code ? va.z : 0.0f;
        acc += xa.w == code ? va.w : 0.0f;
        acc += xb.x == code ? vb.x : 0.0f;
        acc += xb.y == code ? vb.y : 0.0f;
        acc += xb.z == code ? vb.z : 0.0f;
        acc += xb.w == code ? vb.w : 0.0f;
        xa = ya, xb = yb, va = wa, vb = wb;
      }
    }
    for (int i = steps << 3; i < rows; ++i)
      acc += s_code[i] == code ? s_g[i] : 0.0f;
  }
  if (owns) dw[s.c * k + x] = acc;
}

// Scan route at F > 1: a warp owns code x and 32 consecutive features of
// it (`slices` warps per code), so the code is warp-uniform. Per 32 staged
// rows the lanes compare one row each and a ballot gives the matching
// rows, taken in ascending order, kBatch loads of g (coalesced across the
// lanes' features) before their kBatch adds. Absent loads add +0.0. The
// next 32 rows' codes are read before this ballot's adds.
constexpr int kBatch = 4;

__global__ void __launch_bounds__(kThreads) backward_scan_rows_kernel(
    const int* __restrict__ codes, const float* __restrict__ g,
    float* __restrict__ dw, long long n, long long k, long long f,
    long long slices, long long blocks_per_col) {
  __shared__ __align__(16) int s_code[kTile];
  const Slot s = slot_of(blocks_per_col);
  const int lane = threadIdx.x & 31;
  const long long w = s.b * kWarps + (threadIdx.x >> 5);
  const bool owns = w < k * slices;        // warp-uniform
  const long long x = owns ? w / slices : 0;
  const long long j = (w - x * slices) * 32 + lane;
  const bool live = owns && j < f;
  float acc = 0.0f;
  for (long long n0 = 0; n0 < n; n0 += kTile) {
    const int rows = (int)(n - n0 < kTile ? n - n0 : kTile);
    stage_tile(codes + s.c * n, nullptr, n0, rows, s_code, nullptr);
    if (!owns) continue;
    const float* __restrict__ gt = g + n0 * f + j;
    int mine = lane < rows ? s_code[lane] : -1;
    for (int r0 = 0; r0 < rows; r0 += 32) {
      const int next = r0 + 32 + lane < rows ? s_code[r0 + 32 + lane] : -1;
      unsigned mask = __ballot_sync(kFull, mine == (int)x);
      while (mask) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          v[u] = 0.0f;
          if (mask) {
            const int b = __ffs(mask) - 1;
            mask &= mask - 1;
            if (live) v[u] = __ldg(gt + (long long)(r0 + b) * f);
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) acc += v[u];
      }
      mine = next;
    }
  }
  if (live) dw[(s.c * k + x) * f + j] = acc;
}

// Grouped route: a stable counting sort of each column's rows by code over
// row tiles, then owners that sum their own rows. Tile t of column c holds
// rows t * rows .. t * rows + rows - 1; cur[(c * K + x) * tiles + t] counts
// (launch 1), then locates (launch 2, an exclusive scan in that order, so
// code x's rows come before x + 1's and, within x, tile t's before
// t + 1's), code x's rows of tile t in order[c, :]. Launch 3 scatters each
// tile's rows there; launch 4 sums. Counts and places are integers, exact
// in any order; the floats are added only in launch 4, in ascending rows.
// Launches 1 and 3 take the codes kWindow at a time through shared memory
// (one pass over the tile for K <= kWindow).

// Launch 1, a block per (column, tile): the tile's counts of each code
// (zeros written too).
__global__ void __launch_bounds__(kThreads) group_count_kernel(
    const int* __restrict__ codes, long long n, long long k, long long rows,
    long long tiles, int* __restrict__ cur) {
  __shared__ int s_count[kWindow];
  const long long c = blockIdx.x / tiles, t = blockIdx.x - c * tiles;
  const int* __restrict__ col = codes + c * n;
  const long long r1 = (t + 1) * rows < n ? (t + 1) * rows : n;
  for (long long x0 = 0; x0 < k; x0 += kWindow) {
    const int w = (int)(k - x0 < kWindow ? k - x0 : kWindow);
    for (int x = threadIdx.x; x < w; x += kThreads) s_count[x] = 0;
    __syncthreads();
    for (long long i = t * rows + threadIdx.x; i < r1; i += kThreads) {
      const long long x = (long long)__ldg(col + i) - x0;
      if (x >= 0 && x < w) atomicAdd(s_count + x, 1);
    }
    __syncthreads();
    for (int x = threadIdx.x; x < w; x += kThreads)
      cur[((c * k + x0 + x) * tiles) + t] = s_count[x];
    __syncthreads();
  }
}

// Launch 2, a block per column: the exclusive scan of its k * tiles counts
// in place, kScanThreads * kScanRun at a time: each thread's kScanRun
// neighbours, the block's scan of the threads' sums, then their places.
__global__ void __launch_bounds__(kScanThreads) group_scan_kernel(
    long long len, int* __restrict__ cur) {
  __shared__ int s_warp[kScanThreads / 32];
  __shared__ int s_total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* __restrict__ col = cur + blockIdx.x * len;
  int carry = 0;
  for (long long x0 = 0; x0 < len; x0 += kScanThreads * kScanRun) {
    const long long a = x0 + (long long)threadIdx.x * kScanRun;
    int v[kScanRun];
    int sum = 0;
#pragma unroll
    for (int u = 0; u < kScanRun; ++u) {
      v[u] = a + u < len ? col[a + u] : 0;
      sum += v[u];
    }
    int incl = sum;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = s_warp[lane];
      int ws = w;
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, ws, d);
        if (lane >= d) ws += y;
      }
      s_warp[lane] = ws - w;
      if (lane == 31) s_total = ws;
    }
    __syncthreads();
    int place = carry + s_warp[warp] + incl - sum;
#pragma unroll
    for (int u = 0; u < kScanRun; ++u) {
      if (a + u < len) col[a + u] = place;
      place += v[u];
    }
    carry += s_total;
    __syncthreads();                       // s_warp and s_total are reused
  }
}

// Launch 3, a block per (column, tile): each row's place is its code's
// cursor for the tile, held in shared memory for a window of codes; the
// tile's 256-row steps in order, the warps of a step in turn, equal codes
// within a warp ranked by lane. At F = 1 the row's g is placed (its bits),
// at F > 1 the row's index. The cursors end at the start of the next
// tile's rows (for the last tile, of the next code's) and are written back.
__global__ void __launch_bounds__(kThreads) group_scatter_kernel(
    const int* __restrict__ codes, const float* __restrict__ g, long long n,
    long long k, long long f, long long rows, long long tiles,
    int* __restrict__ cur, int* __restrict__ order) {
  __shared__ int s_cur[kWindow];
  const long long c = blockIdx.x / tiles, t = blockIdx.x - c * tiles;
  const int* __restrict__ col = codes + c * n;
  int* __restrict__ ord = order + c * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const long long r1 = (t + 1) * rows < n ? (t + 1) * rows : n;
  for (long long x0 = 0; x0 < k; x0 += kWindow) {
    const int w = (int)(k - x0 < kWindow ? k - x0 : kWindow);
    for (int x = threadIdx.x; x < w; x += kThreads)
      s_cur[x] = cur[(c * k + x0 + x) * tiles + t];
    __syncthreads();
    for (long long i0 = t * rows; i0 < r1; i0 += kThreads) {
      const long long i = i0 + threadIdx.x;
      const long long xw = i < r1 ? (long long)__ldg(col + i) - x0 : -1;
      const bool mine = xw >= 0 && xw < w;
      const int x = mine ? (int)xw : -1;
      int val = !mine ? 0 : (f == 1 ? __float_as_int(__ldg(g + i)) : (int)i);
      asm volatile("" : "+r"(val));        // loaded here, not in the turn
      const unsigned peers = __match_any_sync(kFull, x);
      for (int turn = 0; turn < kWarps; ++turn) {
        if (warp == turn) {                // warp-uniform
          const int base = mine ? s_cur[x] : 0;
          __syncwarp();                    // every lane has read its base
          if (mine) {
            ord[base + __popc(peers & below)] = val;
            if ((peers >> lane) == 1u) s_cur[x] = base + __popc(peers);
          }
        }
        __syncthreads();
      }
    }
    for (int x = threadIdx.x; x < w; x += kThreads)
      cur[(c * k + x0 + x) * tiles + t] = s_cur[x];
    __syncthreads();
  }
}

// End of code x's rows in order[c, :] after launch 3 (its start is x - 1's
// end, or 0).
__device__ __forceinline__ int group_end(const int* __restrict__ cur,
                                         long long c, long long k,
                                         long long tiles, long long x) {
  return __ldg(cur + (c * k + x) * tiles + tiles - 1);
}

// Launch 4 at F = 1: a warp owns a code and reads its placed g 128 at a
// time into shared memory, coalesced (the next 128 loaded before this
// 128's adds); lane 0 adds them in order, four a shared load. Entries past
// the end are +0.0, which leaves the sum's bits as they are.
__global__ void __launch_bounds__(kThreads) group_sum_f1_kernel(
    const int* __restrict__ cur, const int* __restrict__ order,
    float* __restrict__ dw, long long n, long long k, long long tiles,
    long long blocks_per_col) {
  __shared__ __align__(16) float s_val[kWarps][kSumChunk];
  const Slot s = slot_of(blocks_per_col);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long x = s.b * kWarps + warp;
  if (x >= k) return;                      // warp-uniform
  const float* __restrict__ vals =
      reinterpret_cast<const float*>(order + s.c * n);
  float* buf = s_val[warp];
  const float4* buf4 = reinterpret_cast<const float4*>(buf);
  const int end = group_end(cur, s.c, k, tiles, x);
  int i = x ? group_end(cur, s.c, k, tiles, x - 1) : 0;
#pragma unroll
  for (int q = 0; q < kSumChunk / 32; ++q) {
    const int e = i + 32 * q + lane;
    buf[32 * q + lane] = e < end ? __ldg(vals + e) : 0.0f;
  }
  __syncwarp();
  float acc = 0.0f;
  for (; i < end; i += kSumChunk) {
    float next[kSumChunk / 32];
#pragma unroll
    for (int q = 0; q < kSumChunk / 32; ++q) {
      const int e = i + kSumChunk + 32 * q + lane;
      next[q] = e < end ? __ldg(vals + e) : 0.0f;
    }
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < kSumChunk / 4; ++q) {
        const float4 t = buf4[q];
        acc += t.x;
        acc += t.y;
        acc += t.z;
        acc += t.w;
      }
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kSumChunk / 32; ++q) buf[32 * q + lane] = next[q];
    __syncwarp();
  }
  if (lane == 0) dw[s.c * k + x] = acc;
}

// Launch 4 at F > 1: a warp owns a code and 32 of its features (`slices`
// warps a code). Its lanes read 32 of the code's row indices at a time (the
// next 32 before this 32's adds), then each lane loads its feature of those
// 32 rows, coalesced across the lanes, all before their adds; loads past
// the end give +0.0.
__global__ void __launch_bounds__(kThreads) group_sum_rows_kernel(
    const float* __restrict__ g, const int* __restrict__ cur,
    const int* __restrict__ order, float* __restrict__ dw, long long n,
    long long k, long long f, long long tiles, long long slices,
    long long blocks_per_col) {
  const Slot s = slot_of(blocks_per_col);
  const long long w = s.b * kWarps + (threadIdx.x >> 5);
  if (w >= k * slices) return;             // warp-uniform
  const long long x = w / slices;
  const int lane = threadIdx.x & 31;
  const long long j = (w - x * slices) * 32 + lane;
  const bool live = j < f;
  const int* __restrict__ ord = order + s.c * n;
  const int end = group_end(cur, s.c, k, tiles, x);
  int i = x ? group_end(cur, s.c, k, tiles, x - 1) : 0;
  int r = i + lane < end ? __ldg(ord + i + lane) : 0;
  float acc = 0.0f;
  for (; i < end; i += 32) {
    const int next = i + 32 + lane < end ? __ldg(ord + i + 32 + lane) : 0;
    const int m = end - i;
    int row[32];
#pragma unroll
    for (int u = 0; u < 32; ++u) row[u] = __shfl_sync(kFull, r, u);
    __syncwarp();                          // every shuffle before the loads
    float t[32];
#pragma unroll
    for (int u = 0; u < 32; ++u)
      t[u] = live && u < m ? __ldg(g + (long long)row[u] * f + j) : 0.0f;
#pragma unroll
    for (int u = 0; u < 32; ++u) acc += t[u];
    r = next;
  }
  if (live) dw[(s.c * k + x) * f + j] = acc;
}

// Rows per tile of the grouped route: 256, doubled while the k * tiles
// counts would pass an eighth of the rows (so the scan's work is at most
// max(n / 8, k) per column).
long long group_rows(long long n, long long k) {
  long long rows = kThreads;
  while (rows < n && 8 * k * ((n + rows - 1) / rows) > n) rows *= 2;
  return rows;
}

// The scan route serves rows up to kScanRows within kScanLimit warp steps:
// its warps times the steps each takes (a row at F = 1; 32 rows, about
// four times the work, at F > 1). Its time grows with n on every shape
// (each owner walks every row), the grouped route's with the rows of a
// code.
bool scan_route(long long n_cols, long long n, long long k, long long f) {
  const long long warps = f == 1 ? n_cols * ((k + 31) / 32)
                                 : n_cols * k * ((f + 31) / 32) * 4;
  const long long steps = f == 1 ? n : (n + 31) / 32;
  return n <= kScanRows && warps <= kScanLimit / steps;
}

// int32 scratch the grouped route needs (cur, then order), or 0 where the
// scan route serves the shape.
long long scratch_ints(long long n_cols, long long n, long long k,
                       long long f) {
  if (scan_route(n_cols, n, k, f)) return 0;
  const long long rows = group_rows(n, k);
  return n_cols * (k * ((n + rows - 1) / rows) + n);
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

// Scratch ints onehot_wide_backward needs for this shape (n >= 1).
long long onehot_wide_backward_scratch(int n_cols, long long n, long long k,
                                       long long f) {
  return scratch_ints(n_cols, n, k, f);
}

// n >= 1; `scratch` holds onehot_wide_backward_scratch(...) int32.
int onehot_wide_backward(const int* codes, const float* g, float* dw,
                         int n_cols, long long n, long long k, long long f,
                         int* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long slices = (f + 31) / 32;
  if (scan_route(n_cols, n, k, f)) {
    // blocks per column: of owners (F = 1) or of warps (F > 1)
    const long long per_col = f == 1 ? (k + kThreads - 1) / kThreads
                                     : (k * slices + kWarps - 1) / kWarps;
    if ((long long)n_cols * per_col > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    const unsigned int blocks = (unsigned int)(n_cols * per_col);
    if (f == 1) {
      backward_scan_f1_kernel<<<blocks, kThreads, 0, s>>>(codes, g, dw, n, k,
                                                          per_col);
    } else {
      backward_scan_rows_kernel<<<blocks, kThreads, 0, s>>>(
          codes, g, dw, n, k, f, slices, per_col);
    }
    return (int)cudaGetLastError();
  }
  const long long rows = group_rows(n, k);
  const long long tiles = (n + rows - 1) / rows;
  // blocks per column of the sums: of warps, a warp a code (F = 1) or a
  // code's 32 features
  const long long per_col = (k * slices + kWarps - 1) / kWarps;
  if (scratch == nullptr || n > 0x7fffffffLL || k * tiles > 0x7fffffffLL ||
      (long long)n_cols * per_col > 0x7fffffffLL ||
      (long long)n_cols * tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int* cur = scratch;
  int* order = scratch + (long long)n_cols * k * tiles;
  const unsigned int tile_blocks = (unsigned int)(n_cols * tiles);
  group_count_kernel<<<tile_blocks, kThreads, 0, s>>>(codes, n, k, rows,
                                                       tiles, cur);
  group_scan_kernel<<<(unsigned int)n_cols, kScanThreads, 0, s>>>(k * tiles,
                                                                   cur);
  group_scatter_kernel<<<tile_blocks, kThreads, 0, s>>>(
      codes, g, n, k, f, rows, tiles, cur, order);
  const unsigned int blocks = (unsigned int)(n_cols * per_col);
  if (f == 1) {
    group_sum_f1_kernel<<<blocks, kThreads, 0, s>>>(cur, order, dw, n, k,
                                                    tiles, per_col);
  } else {
    group_sum_rows_kernel<<<blocks, kThreads, 0, s>>>(
        g, cur, order, dw, n, k, f, tiles, slices, per_col);
  }
  return (int)cudaGetLastError();
}

const char* onehot_wide_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
