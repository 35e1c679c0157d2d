// Predicate scan for Hopper (sm_90a): a filter evaluated on the resident
// packed words, in code space, with the match count in the same launch.
//
// Replaces src/repro/kernels/predicate_scan/kernel.py
// _predicate_scan_kernel (and, for the count, the separate reduction the
// JAX executor runs after it, src/repro/core/pipeline.py
// _mask_count_future).
//
// Inputs: the flat resident word stream (column c's words start at
// wmeta[c, 0], packed at wmeta[c, 1] bits, a width that divides 32: row r's
// field is bits (r % s) * db of word wmeta[c, 0] + r / s, s = 32 / db), a
// term table of T rows (col, kind, lo, hi, lut_off, lut_len) and every LUT
// term's table back to back. A field is cast to int32, as the TPU kernel's
// astype(int32) did, so a 32-bit field >= 2**31 is a negative code. Kind 0
// tests lo <= code <= hi; kind 1 probes lut[lut_off + clamp(code, 0,
// lut_len - 1)] != 0. The terms fold with AND or OR. Rows [0, n) are
// scanned, stored and counted; rows past n never are, however far the
// stream's capacity reaches. Word indices are clamped to the stream, so no
// load leaves it.
//
// What bounds it on an H100: bytes, once a row costs few instructions. Per
// row it reads db / 8 bytes of each column a term uses and writes one mask
// byte; for P1 (two terms on two 8-bit columns) over 2**25 rows that is
// 64 MiB of words and 32 MiB of mask, 30 us at 3.35 TB/s. The first design
// (a thread per 4 rows, each row's field fetched on its own) spent about 25
// instructions per row and term: the term's metadata reloaded, the word
// index and shift in 64 bits, the same word loaded again for each of its
// rows. It ran at 5.5x the byte bound, issue-bound.
//
// The design is word-major, as the TPU kernel's window of words broadcast
// against an iota of shifts is. A thread owns groups of 16 consecutive rows
// (one 16-byte mask store) and takes four groups a step, kThreads groups
// apart, so a warp's loads and stores are contiguous. Per term it loads the
// group's words of the term's column whole (16 rows are db / 2 words: half
// a word at 1 bit, one 16-byte load at 8, four at 32), the four groups'
// loads issued before any compare, and takes every field out of registers
// with shifts fixed at compile time: a switch on the width picks a body
// templated on it. Width and kind are the same for every thread, so nothing
// diverges. A group's mask is four words of 0/1 bytes, which are the mask
// bytes themselves; the count is their popcount. Per width and kind:
//   1, 2, 4 bits, either kind: the term is a set of at most 16 codes,
//     staged as a bitmask. At 1 and 2 bits the 16 rows are matched at once
//     by logic on the word's bit planes, then spread to bytes by a
//     multiply; at 4 bits row by row.
//   8 bits, kind 1: a 256-byte table in shared memory, entry c the answer
//     for code c with the LUT's clamp folded in: one byte load a row (5.1
//     and 8.6 us faster on P1 and P2 than probing the LUT through L1).
//   8, 16, 32 bits, kind 0: two compares a row. Four 8-bit rows a word
//     compared at once (SWAR) measured no faster on P1, so it is not used.
//   16 and 32 bits, kind 1: the LUT probed through L1, row by row.
// The term table is read once per block: each term's word offset, width,
// kind, bounds, LUT place, load alignment and small-width set are staged in
// shared memory, in chunks of kChunk terms (a predicate with more terms
// restages each chunk per step). A column whose words do not start on the
// vector load's alignment, and a group that reaches the end of the stream,
// take 4-byte loads with clamped indices inside the same body. The grid is
// the blocks the card holds at once (occupancy x SMs), each looping over
// 16,384-row steps (four groups a thread measured 2-4% faster than two).
// The count is a warp reduction, one shared atomic per warp and one global
// atomic per block, so counting adds no pass over the mask.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // also the 8-bit table's entries
constexpr int kGroupRows = 16;           // rows of a group: one 16-byte store
constexpr int kGroups = 4;               // groups a thread takes a step
constexpr int kStepGroups = kThreads * kGroups;
constexpr int kChunk = 32;               // terms staged at once
constexpr int kTermInts = 6;             // col kind lo hi lut_off lut_len

// A term as the main loop reads it.
struct __align__(16) Term {
  int off;        // the column's first word in the stream
  int db;         // its width
  int kind;       // 0 range, 1 LUT
  int lo, hi;     // kind 0
  int lut_off, lut_last;
  int vec;        // the column's words start on the vector load's alignment
  uint32_t set;   // widths 1, 2, 4: bit c set iff code c matches
};

// The term's answer for a code >= 0 (LUT codes past its end probe its last
// entry).
__device__ __forceinline__ bool term_match(int kind, int lo, int hi,
                                           const int* __restrict__ lut,
                                           int lut_off, int lut_last,
                                           int code) {
  if (kind == 0) return code >= lo && code <= hi;
  return __ldg(lut + lut_off + (code > lut_last ? lut_last : code)) != 0;
}

// Terms t0 .. t0 + cn - 1 into shared memory; ends in a barrier.
__device__ void stage_terms(const uint32_t* __restrict__ words,
                            const int* __restrict__ wmeta,
                            const int* __restrict__ terms, int t0, int cn,
                            const int* __restrict__ lut, Term* s_term,
                            uint8_t (*s_tab)[kThreads]) {
  for (int t = threadIdx.x; t < cn; t += kThreads) {
    const int* row = terms + kTermInts * (t0 + t);
    const int col = __ldg(row);
    Term tm;
    tm.kind = __ldg(row + 1);
    tm.lo = __ldg(row + 2);
    tm.hi = __ldg(row + 3);
    tm.lut_off = __ldg(row + 4);
    tm.lut_last = __ldg(row + 5) - 1;
    tm.off = __ldg(wmeta + 2 * col);
    tm.db = __ldg(wmeta + 2 * col + 1);
    const uintptr_t vec_bytes = tm.db >= 8 ? 16 : (tm.db == 4 ? 8 : 4);
    tm.vec = (reinterpret_cast<uintptr_t>(words + tm.off) & (vec_bytes - 1))
             == 0;
    tm.set = 0;
    s_term[t] = tm;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int t = 0; t < cn; ++t) {
    const int db = s_term[t].db, kind = s_term[t].kind;
    if (db == 8 && kind == 1) {
      s_tab[t][threadIdx.x] = term_match(1, 0, -1, lut, s_term[t].lut_off,
                                         s_term[t].lut_last, threadIdx.x);
    } else if (db >= 1 && db <= 4 && threadIdx.x < 32) {
      const bool m = lane < (1 << db) &&
                     term_match(kind, s_term[t].lo, s_term[t].hi, lut,
                                s_term[t].lut_off, s_term[t].lut_last, lane);
      const uint32_t set = __ballot_sync(0xffffffffu, m);
      if (lane == 0) s_term[t].set = set;
    }
  }
  __syncthreads();
}

// Byte 0 of each of a, b, c, d as the four bytes of one word.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// The NW words of a group from word wb on: vector loads where the column is
// aligned for them and the group lies inside the stream, else word by word
// with each index clamped to the stream's last word.
template <int NW>
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ words,
                                           long long n_words, long long wb,
                                           int vec, uint32_t (&w)[NW]) {
  if (vec && wb + NW <= n_words) {
    if constexpr (NW == 1) {
      w[0] = __ldg(words + wb);
    } else if constexpr (NW == 2) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(words + wb));
      w[0] = v.x;
      w[1] = v.y;
    } else {
#pragma unroll
      for (int k = 0; k < NW; k += 4) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(words + wb + k));
        w[k] = v.x;
        w[k + 1] = v.y;
        w[k + 2] = v.z;
        w[k + 3] = v.w;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      const long long i = wb + k;
      w[k] = __ldg(words + (i < n_words ? i : n_words - 1));
    }
  }
}

// Row j's field of a group's words w, as int32 (j fixed at compile time).
template <int DB>
__device__ __forceinline__ int field(const uint32_t* w, int j) {
  if constexpr (DB == 32) {
    return (int)w[j];
  } else if constexpr (DB == 8) {
    return (int)__byte_perm(w[j >> 2], 0, 0x4440 + (j & 3));
  } else {
    constexpr int kPerWord = 32 / DB;
    return (int)((w[j / kPerWord] >> (DB * (j % kPerWord))) &
                 ((1u << DB) - 1u));
  }
}

// The term's answers for the 16 rows of one group, as four words of 0/1
// bytes (row j is byte j % 4 of word j / 4). w holds the group's words;
// at 1 bit the group is half of w[0], the upper half when `half` is 1.
template <int DB>
__device__ __forceinline__ void match_group(const Term& tm,
                                            const uint8_t* __restrict__ tab,
                                            const int* __restrict__ lut,
                                            int half, const uint32_t* w,
                                            uint32_t (&m)[4]) {
  if constexpr (DB == 1) {
    const uint32_t h = (w[0] >> (16 * half)) & 0xffffu;
    const uint32_t bits = ((tm.set & 1u) ? ~h : 0u) | ((tm.set & 2u) ? h : 0u);
    // bits 4q .. 4q + 3 -> bit 0 of bytes 0 .. 3: x * (1 + 2^7 + 2^14 + 2^21)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      m[q] = (((bits >> (4 * q)) & 0xfu) * 0x00204081u) & 0x01010101u;
  } else if constexpr (DB == 2) {
    // code = a + 2b, a and b the low and high bit planes (row j at bit 2j)
    const uint32_t a = w[0] & 0x55555555u, b = (w[0] >> 1) & 0x55555555u;
    const uint32_t s = tm.set;
    uint32_t bits = 0;
    if (s & 1u) bits |= ~(a | b);
    if (s & 2u) bits |= a & ~b;
    if (s & 4u) bits |= ~a & b;
    if (s & 8u) bits |= a & b;
    bits &= 0x55555555u;
    // bits 8q, +2, +4, +6 -> bit 0 of bytes 0 .. 3: x * (1 + 2^6 + 2^12 + 2^18)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      m[q] = (((bits >> (8 * q)) & 0x55u) * 0x41041u) & 0x01010101u;
  } else {
    // one loop per kind, the kind tested once a group: a test inside the
    // unrolled loop is predicated row by row (70 registers, P1 1.6x slower)
    uint32_t r[16];
    if constexpr (DB == 4) {
#pragma unroll
      for (int j = 0; j < 16; ++j) r[j] = (tm.set >> field<4>(w, j)) & 1u;
    } else if (tm.kind == 0) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int code = field<DB>(w, j);
        r[j] = code >= tm.lo && code <= tm.hi;
      }
    } else if constexpr (DB == 8) {
#pragma unroll
      for (int j = 0; j < 16; ++j) r[j] = tab[field<8>(w, j)];
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int code = field<DB>(w, j);
        const int idx =
            code < 0 ? 0 : (code > tm.lut_last ? tm.lut_last : code);
        r[j] = __ldg(lut + tm.lut_off + idx) != 0;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      m[q] = pack4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
  }
}

// The term's answers for the thread's groups g: every group's words loaded
// before any is matched (one group at a time at 32 bits, 16 words a
// group).
template <int DB>
__device__ __forceinline__ void term_groups(
    const Term& tm, const uint8_t* __restrict__ tab,
    const uint32_t* __restrict__ words, long long n_words,
    const int* __restrict__ lut, const long long (&g)[kGroups],
    uint32_t (&m)[kGroups][4]) {
  constexpr int NW = DB == 1 ? 1 : DB / 2;
  constexpr int U = DB == 32 ? 1 : kGroups;
#pragma unroll
  for (int u0 = 0; u0 < kGroups; u0 += U) {
    uint32_t w[U][NW];
#pragma unroll
    for (int u = 0; u < U; ++u)
      load_words<NW>(words, n_words,
                     tm.off + (DB == 1 ? g[u0 + u] >> 1 : g[u0 + u] * NW),
                     tm.vec, w[u]);
#pragma unroll
    for (int u = 0; u < U; ++u)
      match_group<DB>(tm, tab, lut, (int)(g[u0 + u] & 1), w[u], m[u0 + u]);
  }
}

__global__ void __launch_bounds__(kThreads) scan_kernel(
    const uint32_t* __restrict__ words, long long n_words,
    const int* __restrict__ wmeta, const int* __restrict__ terms,
    int n_terms, const int* __restrict__ lut, long long n, int combine_or,
    uint8_t* __restrict__ mask, int* __restrict__ count) {
  __shared__ Term s_term[kChunk];
  __shared__ __align__(16) uint8_t s_tab[kChunk][kThreads];
  __shared__ int block_count;
  if (threadIdx.x == 0) block_count = 0;
  const bool staged = n_terms <= kChunk;
  if (staged) {
    stage_terms(words, wmeta, terms, 0, n_terms, lut, s_term, s_tab);
  } else {
    __syncthreads();
  }
  const long long n_groups = (n + kGroupRows - 1) / kGroupRows;
  const bool mask_vec = (reinterpret_cast<uintptr_t>(mask) & 15) == 0;
  const uint32_t init = combine_or ? 0u : 0x01010101u;
  int matched = 0;
  for (long long base = (long long)blockIdx.x * kStepGroups; base < n_groups;
       base += (long long)gridDim.x * kStepGroups) {
    long long g[kGroups];
    uint32_t acc[kGroups][4];
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const long long gg = base + u * kThreads + threadIdx.x;
      g[u] = gg < n_groups ? gg : n_groups - 1;   // loads stay in range
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[u][q] = init;
    }
    for (int t0 = 0; t0 < n_terms; t0 += kChunk) {
      const int cn = n_terms - t0 < kChunk ? n_terms - t0 : kChunk;
      if (!staged) {
        __syncthreads();                 // all are done with the last chunk
        stage_terms(words, wmeta, terms, t0, cn, lut, s_term, s_tab);
      }
      for (int t = 0; t < cn; ++t) {
        const Term& tm = s_term[t];
        const uint8_t* tab = s_tab[t];
        uint32_t m[kGroups][4] = {};     // a width not dividing 32: none
        switch (tm.db) {
          case 1: term_groups<1>(tm, tab, words, n_words, lut, g, m); break;
          case 2: term_groups<2>(tm, tab, words, n_words, lut, g, m); break;
          case 4: term_groups<4>(tm, tab, words, n_words, lut, g, m); break;
          case 8: term_groups<8>(tm, tab, words, n_words, lut, g, m); break;
          case 16: term_groups<16>(tm, tab, words, n_words, lut, g, m); break;
          case 32: term_groups<32>(tm, tab, words, n_words, lut, g, m); break;
          default: break;
        }
#pragma unroll
        for (int u = 0; u < kGroups; ++u)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[u][q] = combine_or ? (acc[u][q] | m[u][q])
                                   : (acc[u][q] & m[u][q]);
      }
    }
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const long long gg = base + u * kThreads + threadIdx.x;
      if (gg >= n_groups) continue;
      const long long r0 = gg * kGroupRows;
      if (mask_vec && r0 + kGroupRows <= n) {
        *reinterpret_cast<uint4*>(mask + r0) =
            make_uint4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
        matched += __popc(acc[u][0]) + __popc(acc[u][1]) +
                   __popc(acc[u][2]) + __popc(acc[u][3]);
      } else {                           // the last group, or an unaligned mask
#pragma unroll
        for (int j = 0; j < kGroupRows; ++j) {
          if (r0 + j < n) {
            const uint32_t b = (acc[u][j >> 2] >> (8 * (j & 3))) & 1u;
            mask[r0 + j] = (uint8_t)b;
            matched += (int)b;
          }
        }
      }
    }
  }
  // every lane of every warp reaches this point (no early exit above)
  matched = __reduce_add_sync(0xffffffffu, matched);
  if ((threadIdx.x & 31) == 0 && matched) atomicAdd(&block_count, matched);
  __syncthreads();
  if (threadIdx.x == 0 && block_count) atomicAdd(count, block_count);
}

// The blocks the card holds at once; one block an SM of an H100 if the
// runtime cannot say.
int resident_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scan_kernel,
                                                    kThreads, 0) !=
          cudaSuccess ||
      sms < 1 || per_sm < 1) {
    cudaGetLastError();                  // not the launch's error
    return 132;
  }
  return sms * per_sm;
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
  if (n <= 0) return (int)cudaSuccess;
  static const int grid_cap = resident_blocks();
  const long long steps =
      ((n + kGroupRows - 1) / kGroupRows + kStepGroups - 1) / kStepGroups;
  const long long blocks = steps < grid_cap ? steps : grid_cap;
  scan_kernel<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const uint32_t*>(words), n_words, wmeta, terms,
      n_terms, lut, n, combine_or, mask, count);
  return (int)cudaGetLastError();
}

const char* predicate_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
