// Per-code counts for Hopper (sm_90a): the count metadata of paper §6.2
// (counts_kernel) and GROUP BY column COUNT(*) WHERE mask straight from the
// resident packed words (the masked counts).
//
// What replaces what (the TPU kernels are in src/repro/kernels/hist/
// kernel.py):
//   counts_kernel        <- _hist_kernel: hist(codes, k) -> (k,) int32
//                           counts of int32 codes of any shape
//   masked_counts_narrow_kernel (widths 1, 2, 4),
//   masked_counts_binned_kernel (widths 8, 16, 32)
//                        <- _masked_hist_kernel together with the XLA
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
// k x n compares, because a TPU core has no scattered add. counts_kernel
// instead adds each code with one atomic increment into a per-block
// histogram in shared memory (four codes a thread, one 16-byte load),
// added into the zeroed output with one global atomic per nonzero bin per
// block; past 58,112 bins (227 KB) it counts straight into the output
// (kShared = false). The masked counts are word-major: a thread takes a
// group of rows (one 16-byte mask load) and the words that hold them,
// skips the word loads where no row of the group is selected, and turns
// the mask bytes into one bit a row. At widths 1-4 (the 4-code `device`)
// a row's atomic would fall on one of a few bins that every warp shares,
// so codes are counted in registers by popcount instead; at widths 8-32
// equal codes of a warp are combined before their atomic. Counts are
// integers, so the result does not depend on the order of the adds.

#include <cuda_runtime.h>
#include <stdint.h>

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

// -- the masked counts, word-major ---------------------------------------
//
// A group is the rows of one 16-byte mask load (two at 1 bit) and the words
// that hold them: Group<DB>::kRows rows in kWords words, in the layout of
// packed_code.cuh (row r at bits (r % kPerWord) * DB of word r / kPerWord). A thread takes
// kStepGroups groups a step, kThreads apart, so a warp's loads are
// contiguous (walk_groups). The step loop is the same for every lane of a
// warp, so the warp collectives below see all 32 lanes.
template <int DB>
struct Group {
  static constexpr int kRows = DB == 1 ? 32 : 16;
  static constexpr int kWords = kRows * DB / 32;
  static constexpr int kPerWord = 32 / DB;    // rows of a word
  static constexpr int kMaskWords = kRows / 4;
};

constexpr int kStepGroups = 2;             // groups a thread takes a step
constexpr unsigned kFull = 0xffffffffu;
// the binned kernel walks a step's rows as the bits of one word
static_assert(16 * kStepGroups <= 32, "a step's rows past 32 bits");

// Bit 8t set iff byte t of x is nonzero.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return ((((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) >> 7) & 0x01010101u;
}

// Group g's mask bytes, as words: 16-byte loads where the mask is aligned
// and the group lies inside [0, n), else byte by byte, a row past n read as
// 0; all 0 for a group past the last.
template <int DB>
__device__ __forceinline__ void group_mask(
    const uint8_t* __restrict__ mask, long long n, long long g,
    bool mask_vec, long long n_groups, uint32_t (&m)[Group<DB>::kMaskWords]) {
  using G = Group<DB>;
  const long long r0 = g * G::kRows;
  if (g >= n_groups) {
#pragma unroll
    for (int q = 0; q < G::kMaskWords; ++q) m[q] = 0;
  } else if (mask_vec && r0 + G::kRows <= n) {
#pragma unroll
    for (int h = 0; h < G::kMaskWords / 4; ++h) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(mask + r0) + h);
      m[4 * h] = v.x, m[4 * h + 1] = v.y, m[4 * h + 2] = v.z,
      m[4 * h + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < G::kMaskWords; ++q) {
      uint32_t x = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const long long r = r0 + 4 * q + t;
        if (r < n && __ldg(mask + r)) x |= 1u << (8 * t);
      }
      m[q] = x;
    }
  }
}

// A group's selection from its mask words: bit r set iff row r's mask byte
// is nonzero. Four mask bytes become four bits by one multiply: bits 8t
// (t < 4) times 2**0 + 2**7 + 2**14 + 2**21 land bit t at 21 + t, and no
// two of the sixteen products share a bit, so nothing carries.
template <int DB>
__device__ __forceinline__ uint32_t mask_bits(
    const uint32_t (&m)[Group<DB>::kMaskWords]) {
  uint32_t bits = 0;
#pragma unroll
  for (int q = 0; q < Group<DB>::kMaskWords; ++q)
    bits |= (((nonzero_bytes(m[q]) * 0x204081u) >> 21) & 0xfu) << (4 * q);
  return bits;
}

// The selection of word i of a group at widths 1, 2 and 4: bit r of the
// word's rows moved to bit r * DB, the lowest bit of its field.
template <int DB>
__device__ __forceinline__ uint32_t field_selection(uint32_t bits, int i) {
  uint32_t x = bits >> (i * Group<DB>::kPerWord);
  if constexpr (DB == 2) {               // 16 rows -> even bits
    x = (x | (x << 8)) & 0x00ff00ffu;
    x = (x | (x << 4)) & 0x0f0f0f0fu;
    x = (x | (x << 2)) & 0x33333333u;
    x = (x | (x << 1)) & 0x55555555u;
  } else if constexpr (DB == 4) {        // 8 rows -> every fourth bit
    x &= 0xffu;
    x = (x | (x << 12)) & 0x000f000fu;
    x = (x | (x << 6)) & 0x03030303u;
    x = (x | (x << 3)) & 0x11111111u;
  }
  return x;
}

// A group's words: vector loads where the column's words are aligned for
// them and the group's words lie inside [0, n) and the stream, else one
// 4-byte load a word with its index clamped to the stream.
template <int DB>
__device__ __forceinline__ void group_words(
    const uint32_t* __restrict__ words, long long n_words, int word_off,
    long long n, long long g, bool words_vec,
    uint32_t (&w)[Group<DB>::kWords]) {
  using G = Group<DB>;
  const long long w0 = word_off + g * G::kWords;
  if (G::kWords >= 2 && words_vec && (g + 1) * G::kRows <= n &&
      w0 + G::kWords <= n_words) {
    if constexpr (G::kWords == 2) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(words + w0));
      w[0] = v.x, w[1] = v.y;
    } else {
#pragma unroll
      for (int h = 0; h < G::kWords / 4; ++h) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(words + w0) + h);
        w[4 * h] = v.x, w[4 * h + 1] = v.y, w[4 * h + 2] = v.z,
        w[4 * h + 3] = v.w;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < G::kWords; ++i)
      w[i] = __ldg(words + (w0 + i < n_words ? w0 + i : n_words - 1));
  }
}

// The block's steps, counted by count(bits, w) with each step's selections
// and words (group u of the step: bits[u], w[u]). A step's mask is loaded
// one step ahead, so it is in flight while the last step counts; its words
// (loaded where any of its rows is selected) wait on it. Loading the words
// a step ahead as well measured 4% faster at 8 bits and 16% slower at 2.
// Groups past the last read as unselected.
template <int DB, typename Count>
__device__ __forceinline__ void walk_groups(
    const uint32_t* __restrict__ words, long long n_words, int word_off,
    const uint8_t* __restrict__ mask, long long n, bool mask_vec,
    bool words_vec, Count count) {
  using G = Group<DB>;
  const long long n_groups = (n + G::kRows - 1) / G::kRows;
  const long long stride = (long long)gridDim.x * kThreads * kStepGroups;
  const long long mine = (long long)blockIdx.x * kThreads * kStepGroups +
                         threadIdx.x;
  uint32_t m[kStepGroups][G::kMaskWords];
#pragma unroll
  for (int u = 0; u < kStepGroups; ++u)
    group_mask<DB>(mask, n, mine + u * kThreads, mask_vec, n_groups, m[u]);
  for (long long g0 = mine; g0 - threadIdx.x < n_groups; g0 += stride) {
    uint32_t bits[kStepGroups], w[kStepGroups][G::kWords];
#pragma unroll
    for (int u = 0; u < kStepGroups; ++u) {
      bits[u] = mask_bits<DB>(m[u]);
      group_mask<DB>(mask, n, g0 + stride + u * kThreads, mask_vec, n_groups,
                     m[u]);
    }
#pragma unroll
    for (int u = 0; u < kStepGroups; ++u) {
      if (bits[u]) {
        group_words<DB>(words, n_words, word_off, n, g0 + u * kThreads,
                        words_vec, w[u]);
      } else {
#pragma unroll
        for (int i = 0; i < G::kWords; ++i) w[u][i] = 0;
      }
    }
    count(bits, w);
  }
}

// Widths 1, 2 and 4: each thread counts codes 0 .. min(k, 2**DB) - 1 in
// registers. A word's rows with code v are the fields of w equal to v: a
// field of ~(w ^ v repeated) is all ones exactly there, and AND-folding it
// leaves that at the field's lowest bit, where sel has the row's flag, so a
// popcount counts a word's selected rows with code v. No atomic a row; at
// the end a warp sum a code, one shared add a warp, one global add a
// nonzero code a block.
template <int DB>
__global__ void __launch_bounds__(kThreads) masked_counts_narrow_kernel(
    const uint32_t* __restrict__ words, long long n_words, int word_off,
    const uint8_t* __restrict__ mask, long long n, int k,
    int* __restrict__ out, bool mask_vec, bool words_vec) {
  using G = Group<DB>;
  constexpr int kCodes = 1 << DB;
  constexpr uint32_t kRepeat = 0xffffffffu / (kCodes - 1);
  __shared__ unsigned int s_bins[kCodes];
  const int kv = k < kCodes ? k : kCodes;
  if (threadIdx.x < kCodes) s_bins[threadIdx.x] = 0;
  unsigned int cnt[kCodes];
#pragma unroll
  for (int v = 0; v < kCodes; ++v) cnt[v] = 0;
  walk_groups<DB>(
      words, n_words, word_off, mask, n, mask_vec, words_vec,
      [&](const uint32_t (&bits)[kStepGroups],
          const uint32_t (&w)[kStepGroups][G::kWords]) {
#pragma unroll
        for (int u = 0; u < kStepGroups; ++u) {
#pragma unroll
          for (int i = 0; i < G::kWords; ++i) {
            const uint32_t sel = field_selection<DB>(bits[u], i);
#pragma unroll
            for (int v = 0; v < kCodes; ++v) {
              uint32_t x = ~(w[u][i] ^ (kRepeat * (uint32_t)v));
              if (DB >= 2) x &= x >> 1;
              if (DB >= 4) x &= x >> 2;
              if (v < kv) cnt[v] += __popc(x & sel);
            }
          }
        }
      });
  __syncthreads();                       // bins zeroed
  // every lane of every warp reaches this point (no early exit above)
#pragma unroll
  for (int v = 0; v < kCodes; ++v) {
    const unsigned int total = __reduce_add_sync(kFull, cnt[v]);
    if ((threadIdx.x & 31) == 0 && total) atomicAdd(&s_bins[v], total);
  }
  __syncthreads();
  if (threadIdx.x < kv && s_bins[threadIdx.x])
    atomicAdd(out + threadIdx.x, (int)s_bins[threadIdx.x]);
}

// Widths 8, 16 and 32: a row's code is its field, and each selected row
// with a code below k adds one to its bin. A lane walks its group's
// selected rows, lowest first, one a turn, while any lane of the warp has
// one left (a sparse mask costs a turn or two a group, not a step a row);
// lanes holding the same code in a turn are combined first
// (__match_any_sync), so one atomic adds each distinct code's rows. The
// bins are a block's k counters in shared memory, added into the zeroed
// output at the end (per-warp sub-histograms measured no faster at k =
// 230), or past 58,112 bins the output itself (kShared = false). A 32-bit
// field >= 2**31 is >= k as an unsigned number, so it is dropped.
template <int DB, bool kShared>
__global__ void __launch_bounds__(kThreads) masked_counts_binned_kernel(
    const uint32_t* __restrict__ words, long long n_words, int word_off,
    const uint8_t* __restrict__ mask, long long n, int k,
    int* __restrict__ out, bool mask_vec, bool words_vec) {
  using G = Group<DB>;
  extern __shared__ int bins[];
  const int lane = threadIdx.x & 31;
  int* target = counters<kShared>(bins, out, k);
  walk_groups<DB>(
      words, n_words, word_off, mask, n, mask_vec, words_vec,
      [&](const uint32_t (&bits)[kStepGroups],
          const uint32_t (&w)[kStepGroups][G::kWords]) {
        // the step's selected rows, group u's at bits u * kRows up
        uint32_t left = 0;
#pragma unroll
        for (int u = 0; u < kStepGroups; ++u)
          left |= bits[u] << (u * G::kRows);
        while (__any_sync(kFull, left)) {
          int v = -1;
          if (left) {
            const int r = __ffs(left) - 1;
            left &= left - 1;
            const int at = r / G::kPerWord;  // word u * kWords + i
            uint32_t word = w[0][0];
#pragma unroll
            for (int u = 0; u < kStepGroups; ++u)
#pragma unroll
              for (int i = 0; i < G::kWords; ++i)
                if (at == u * G::kWords + i) word = w[u][i];
            uint32_t field = word >> ((r % G::kPerWord) * DB);
            if constexpr (DB < 32) field &= (1u << DB) - 1u;
            if (field < (uint32_t)k) v = (int)field;
          }
          const unsigned int peers = __match_any_sync(kFull, v);
          if (v >= 0 && lane == __ffs(peers) - 1)
            atomicAdd(target + v, __popc(peers));
        }
      });
  flush<kShared>(bins, out, k);
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms < 1) {
    cudaGetLastError();                  // not the launch's error
    return 132;
  }
  return sms;
}

// Launch one masked counts kernel: as many blocks as the groups need, at
// most those the card holds at once (each block flushes its bins, so more
// would only add flush atomics).
template <typename Kernel>
int launch_masked(Kernel kernel, size_t smem, long long n_groups,
                  cudaStream_t stream, const uint32_t* words,
                  long long n_words, int word_off, const uint8_t* mask,
                  long long n, int k, int* out, bool mask_vec,
                  bool words_vec) {
  if (smem > kDefaultShared) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  static const int sms = sm_count();
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    smem) != cudaSuccess ||
      per_sm < 1) {
    cudaGetLastError();
    per_sm = 1;
  }
  long long blocks = (n_groups + kThreads * kStepGroups - 1) /
                     (kThreads * kStepGroups);
  if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  if (blocks < 1) blocks = 1;
  kernel<<<(unsigned int)blocks, kThreads, smem, stream>>>(
      words, n_words, word_off, mask, n, k, out, mask_vec, words_vec);
  return (int)cudaGetLastError();
}

template <int DB>
int masked_counts_at(const uint32_t* words, long long n_words, int word_off,
                     const uint8_t* mask, long long n, int k, int* out,
                     cudaStream_t stream) {
  using G = Group<DB>;
  const long long n_groups = (n + G::kRows - 1) / G::kRows;
  const bool mask_vec = (reinterpret_cast<uintptr_t>(mask) & 15) == 0;
  const uintptr_t vec_bytes = G::kWords >= 4 ? 16 : 4 * G::kWords;
  const bool words_vec =
      (reinterpret_cast<uintptr_t>(words + word_off) & (vec_bytes - 1)) == 0;
  if constexpr (DB <= 4) {
    return launch_masked(masked_counts_narrow_kernel<DB>, 0, n_groups,
                         stream, words, n_words, word_off, mask, n, k, out,
                         mask_vec, words_vec);
  } else {
    const size_t smem = (size_t)k * sizeof(int);
    if (smem <= kSharedLimit)
      return launch_masked(masked_counts_binned_kernel<DB, true>, smem,
                           n_groups, stream, words, n_words, word_off, mask,
                           n, k, out, mask_vec, words_vec);
    return launch_masked(masked_counts_binned_kernel<DB, false>, 0, n_groups,
                         stream, words, n_words, word_off, mask, n, k, out,
                         mask_vec, words_vec);
  }
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
  const uint32_t* w = reinterpret_cast<const uint32_t*>(words);
  cudaStream_t s = (cudaStream_t)stream;
  switch (db) {
    case 1: return masked_counts_at<1>(w, n_words, word_off, mask, n, k, out, s);
    case 2: return masked_counts_at<2>(w, n_words, word_off, mask, n, k, out, s);
    case 4: return masked_counts_at<4>(w, n_words, word_off, mask, n, k, out, s);
    case 8: return masked_counts_at<8>(w, n_words, word_off, mask, n, k, out, s);
    case 16:
      return masked_counts_at<16>(w, n_words, word_off, mask, n, k, out, s);
    case 32:
      return masked_counts_at<32>(w, n_words, word_off, mask, n, k, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* hist_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
