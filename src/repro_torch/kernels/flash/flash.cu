// Flash attention for Hopper (sm_90a): the forward and the backward of
// models/flash.py's _Flash, each a fused tensor-core kernel.
//
//   forward  out = softmax(q k^T + mask) v, with (out32, m, l) saved   (1)
//   dQ       delta = rowsum(dout * out32), then dq = dS k               (2)
//   dK/dV    dv = P^T dout, dk = dS^T q                                 (3)
//
// where P = exp(q k^T + mask - m) / l and dS = P * (dout v^T - delta).
// GQA layout: q (B,S,KV,G,DH) [pre-scaled], k/v (B,T,KV,DH); the G query
// heads of one KV head are rows of one tile, row r = s * G + g, so one K/V
// tile load serves all G heads. m, l, delta are (B,KV,G,S) float32. The
// mask is models/flash.py's: keep (s, t) where 0 <= q_pos[s] - t < window
// (window <= 0: no limit), add kbias[t]; a score at or below -5e29 gives
// p = 0. Only keys below t_eff (the whole chunks the plain version scans)
// are read.
//
// What replaces what: src/repro/models/flash.py, a jax.custom_vjp over two
// lax.scans (forward and backward) with no Pallas kernel; the port's plain
// version (models/flash.py _fwd_scan, _bwd_scan) ran it as chunked float32
// PyTorch ops, an SGEMM and then separate mask, max, exp, where, sum and
// rescale passes for each 1,024-key chunk, the (S, chunk) score matrix
// going to device memory and back between passes.
//
// What bounds them on an H100: operations. A causal layer of minicpm-2b
// (B 2 x S 2,048 x 36 heads of 64) holds 151,068,672 live (query, key)
// pairs: the forward's two products are 4 * 64 operations a pair, 3.9e10
// (39 us at 989 TFLOP/s), against 114 MB of q, k, v, out, out32, m, l
// (34 us at 3.35 TB/s); the backward's four (dv, dp, dq, dk) twice that
// against 171 MB. This design runs more: the backward recomputes the
// scores and dout v^T in both of its kernels, and P and dS enter as three
// pieces (below), 13 bf16 products of the pairs' size where four would do.
//
// Design. Each block is four warps, each warp 16 rows of a tile; every
// product is mma.sync m16n8k16 bf16 with float32 accumulation, its operands
// loaded from shared memory by ldmatrix (rows padded by 16 bytes, so the
// eight rows of a load fall in distinct banks), the next tile's K/V (or
// q/dout) copied in by cp.async while this one is used (double buffering).
// The score tile, the mask, the online max and sum, P and dS live in
// registers; the accumulators of two C tiles are the A operand of the next
// product (the m16n8 C layout is the m16k16 A layout), so nothing of size
// (S, T) touches device memory. A key tile is skipped only where the mask
// removes every pair in it: the wrapper gives each query tile its live key
// tiles [lo, hi) from the positions its rows hold (ops.live_tiles), and the
// dK/dV kernel visits the query tiles whose range holds its key tile.
// Where every pair of a tile is kept by position, the mask's position tests
// are skipped and only kbias added; exp is the special function unit's ex2
// of a fused multiply-add; the forward and dQ grids start the causal
// staircase's longest tiles first. Two blocks of 16 rows a warp (each B
// fragment feeding both) ran no faster at DH 64 and slower in the
// backward: the registers they take halve the warps an SM holds.
//
// Precision: the same work as the plain version, not less of it. q k^T and
// dout v^T multiply bf16 values, which a bf16 MMA with float32 accumulation
// multiplies exactly. The plain version rounds P to v's dtype before P v
// (as the reference does), so the forward's P enters as one bf16 piece for
// bf16 v; but the backward's P and dS are float32 in the plain version, and
// enter each product as three bf16 pieces (hi + mid + lo, which together
// hold float32's 24-bit significand): three MMAs accumulated in float32.
// float32 inputs are split the same way by the wrapper (NP = 3 pieces of
// q, k, v, dout), and a product of pieces i and j is taken where i + j < 3,
// the terms above float32's rounding, and each tile's products are added
// to the running sums by a rounding float add (mma_abt says why). The
// forward accumulates P v over all tiles in float32, finer than the plain
// version's per-chunk bf16 pv.
//
// Determinism: no atomics. delta is written by the dQ kernel, which the
// wrapper launches before the dK/dV kernel on the same stream; each dq row
// and each dk/dv row is written once by the block that owns it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;                 // four warps
constexpr float kNegInf = -1e30f;             // models/flash.py NEG_INF
constexpr float kDead = 2.0f * kNegInf;       // a key at or past t_eff
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// Tile sizes: BM query rows (forward, dQ) against BN keys; the dK/dV kernel
// holds BKV keys and walks BQ query rows at a time. float32 inputs (NP = 3
// pieces) take smaller tiles to fit shared memory; DH 128 takes BQ 32 in
// the dK/dV kernel, whose two (16, DH) float32 accumulators a thread holds.
template <int DH, int NP>
struct Tiles {
  static_assert(DH % 16 == 0 && DH >= 16 && DH <= 128, "head size");
  static_assert(NP == 1 || NP == 3, "pieces");
  static constexpr int BM = 64;
  static constexpr int BN = NP == 1 ? 64 : 32;
  static constexpr int BKV = 64;
  static constexpr int BQ = (DH == 128 || NP == 3) ? 32 : 64;
  static constexpr int LD = DH + 8;           // shared row stride, bf16
  // blocks an SM is to hold, which caps the registers a thread takes: at
  // DH <= 64 in bf16 the backward kernels ran 12% faster so (four dQ
  // blocks of at most 128 registers, three dK/dV of at most 168, a few
  // bytes spilled) than at the compiler's 168 and 181
  static constexpr int DQ_BLOCKS = (DH <= 64 && NP == 1) ? 4 : 1;
  static constexpr int KV_BLOCKS = (DH <= 64 && NP == 1) ? 3 : 1;
  using Out = typename std::conditional<NP == 1, bf16, float>::type;
};

struct Shape {
  int b, s, t, t_eff, kv, g;
  float window_limit;                         // window > 0 ? window : 1e18
};

struct Args {
  Shape p;
  const bf16* q;          // NP pieces of (B,S,KV,G,DH), q_piece apart
  const bf16* k;          // NP pieces of (B,T,KV,DH), k_piece apart
  const bf16* v;          // like k
  const bf16* dout;       // backward: like q
  long long q_piece, k_piece;
  const float* q_pos;     // (S,)
  const float* kbias;     // (T,)
  const int* bounds;      // per query tile: live key tiles [lo, hi) and
                          // those every pair of is kept by position
  int n_qt;               // query tiles the bounds cover
  float* out32;           // (B,S,KV,G,DH): forward writes, dQ reads
  void* out;              // forward, in the inputs' dtype (null: none)
  float* m;               // (B,KV,G,S): forward writes, backward reads
  float* l;
  float* delta;           // dQ writes, dK/dV reads
  void* dq;               // backward outputs, in the inputs' dtype
  void* dk;
  void* dv;
};

// The addressing of one (b, kv): query row r = s * G + g of (B,S,KV,G,DH),
// its m / l / delta entry of (B,KV,G,S), key t of (B,T,KV,DH).
struct Rows {
  long long q0, k0, st0;  // offsets of (b, 0, kv, 0), (b, 0, kv), (b, kv, 0, 0)
  int qs, ks, s, g, dh;   // q: elements between positions; k: between keys
  float inv_g;

  __device__ Rows(const Shape& p, int b, int kv, int dh_)
      : q0(((long long)b * p.s * p.kv + kv) * p.g * dh_),
        k0(((long long)b * p.t * p.kv + kv) * dh_),
        st0(((long long)b * p.kv + kv) * p.g * p.s),
        qs(p.kv * p.g * dh_), ks(p.kv * dh_), s(p.s), g(p.g), dh(dh_),
        inv_g(1.f / p.g) {}

  // r / g: the float estimate is within one of it for r < 2**24
  __device__ int pos(int r) const {
    int d = __float2int_rz(static_cast<float>(r) * inv_g);
    d += (d + 1) * g <= r;
    d -= d * g > r;
    return d;
  }
  __device__ long long q(int r) const {
    const int sp = pos(r);
    return q0 + (long long)sp * qs + (long long)(r - sp * g) * dh;
  }
  __device__ long long stat(int r) const {
    const int sp = pos(r);
    return st0 + (long long)(r - sp * g) * s + sp;
  }
  __device__ long long k(int t) const { return k0 + (long long)t * ks; }
};

// The plain version's masked score: x + (where(keep, 0, NEG_INF) + kbias).
__device__ __forceinline__ float masked(float x, float qpos, int t, float kb,
                                        const Shape& p) {
  if (t >= p.t_eff) return kDead;
  const float diff = qpos - static_cast<float>(t);
  const bool keep = diff >= 0.f && diff < p.window_limit;
  return x + ((keep ? 0.f : kNegInf) + kb);
}

// -- PTX: cp.async, ldmatrix, mma.sync ---------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes from global to shared memory; zeros where !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory, each lane naming one row.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d (16 x 8, float32) += a (16 x 16, bf16) * b (16 x 8, bf16).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 2**x, the special function unit's approximation (2**-22 relative).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// -- end of PTX ---------------------------------------------------------------
template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = 0.f;
}

template <int N>
__device__ __forceinline__ void add(float (&acc)[N][4], const float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] += x[i][e];
}

// Two float32 values as NS packed bf16 pairs: the first rounds each value,
// each next one rounds what the earlier ones left (hi, mid, lo).
template <int NS>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t (&out)[NS]) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    out[i] = *reinterpret_cast<const uint32_t*>(&h);
    if (i + 1 < NS) {
      x0 -= __low2float(h);
      x1 -= __high2float(h);
    }
  }
}

// The A operand (16 x 16) of NS pieces from two C tiles (16 x 8 each): the
// m16n8 C layout of two column blocks is the m16k16 A layout.
template <int NS>
__device__ __forceinline__ void a_from_c(const float (&c0)[4],
                                         const float (&c1)[4],
                                         uint32_t (&a)[NS][4]) {
  uint32_t t[4][NS];
  split2<NS>(c0[0], c0[1], t[0]);
  split2<NS>(c0[2], c0[3], t[1]);
  split2<NS>(c1[0], c1[1], t[2]);
  split2<NS>(c1[2], c1[3], t[3]);
#pragma unroll
  for (int i = 0; i < NS; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[i][r] = t[r][i];
}

// acc (16 x N) += A (16 x DH) * B (N x DH)^T: A's rows a_row0.. of a shared
// tile [NP][a_rows][LD], B's rows 0..N-1 of [NP][b_rows][LD]; the pieces i
// of A and j of B where i + j < 3. Consecutive MMAs go to different
// accumulators, so none waits on the one before. The tensor cores round
// their float32 sums toward zero, which biases a long chain of MMAs by up to
// 2**-24 an MMA; float32 inputs (NP = 3) therefore sum each 16 columns'
// products into a zeroed tile and add it with a rounding float add.
template <int DH, int NP, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4],
                                        const bf16* sa, int a_rows,
                                        int a_row0, const bf16* sb,
                                        int b_rows) {
  constexpr int LD = DH + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    float t[N / 8][4];
    float(*d)[4] = NP == 3 ? t : acc;
    if (NP == 3) zero(t);
    uint32_t a[NP][4];
#pragma unroll
    for (int pa = 0; pa < NP; ++pa)
      ldsm_x4(a[pa], sa + (pa * a_rows + a_row0 + (lane & 15)) * LD +
                         kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int pb = 0; pb < NP; ++pb) {
      uint32_t b[N / 16][4];
#pragma unroll
      for (int nb = 0; nb < N / 16; ++nb)
        ldsm_x4(b[nb], sb + (pb * b_rows + nb * 16 + (lane & 7) +
                             ((lane >> 4) << 3)) * LD +
                           kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int pa = 0; pa < NP; ++pa) {
        if (pa + pb < 3) {
#pragma unroll
          for (int nb = 0; nb < N / 16; ++nb) {
            mma(d[2 * nb], a[pa], b[nb][0], b[nb][1]);
            mma(d[2 * nb + 1], a[pa], b[nb][2], b[nb][3]);
          }
        }
      }
    }
    if (NP == 3) add(acc, t);
  }
}

// acc (16 x DH) += C (16 x K) * B (K x DH): C in registers as K / 8 C tiles,
// entering as NS pieces; B's rows 0..K-1 of a shared tile [NP][b_rows][LD].
// Consecutive MMAs go to different accumulators, as in mma_abt.
template <int DH, int NP, int K, int NS>
__device__ __forceinline__ void mma_cb(float (&acc)[DH / 8][4],
                                       const float (&c)[K / 8][4],
                                       const bf16* sb, int b_rows) {
  constexpr int LD = DH + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[NS][4];
    a_from_c<NS>(c[2 * kk], c[2 * kk + 1], a);
#pragma unroll
    for (int pb = 0; pb < NP; ++pb) {
      uint32_t b[DH / 16][4];
#pragma unroll
      for (int nd = 0; nd < DH / 16; ++nd)
        ldsm_x4_t(b[nd], sb + (pb * b_rows + kk * 16 + (lane & 7) +
                               ((lane >> 3) & 1) * 8) * LD +
                             nd * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int pa = 0; pa < NS; ++pa) {
        if (pa + pb < 3) {
#pragma unroll
          for (int nd = 0; nd < DH / 16; ++nd) {
            mma(acc[2 * nd], a[pa], b[nd][0], b[nd][1]);
            mma(acc[2 * nd + 1], a[pa], b[nd][2], b[nd][3]);
          }
        }
      }
    }
  }
}

// acc += C * B as mma_cb, over a chain of tiles: float32 inputs take each
// tile's product into a zeroed tile and add it with a rounding float add
// (mma_abt says why).
template <int DH, int NP, int K, int NS>
__device__ __forceinline__ void mma_cb_add(float (&acc)[DH / 8][4],
                                           const float (&c)[K / 8][4],
                                           const bf16* sb, int b_rows) {
  if (NP == 3) {
    float t[DH / 8][4];
    zero(t);
    mma_cb<DH, NP, K, NS>(t, c, sb, b_rows);
    add(acc, t);
  } else {
    mma_cb<DH, NP, K, NS>(acc, c, sb, b_rows);
  }
}

// Rows row0.. (ROWS of them, NP pieces each) of one tensor, or of two with
// the same layout (d2 not null), into shared tiles [NP][ROWS][LD]; rows at
// or past n_rows are zeros. off(r) is row r's element offset.
template <int DH, int NP, int ROWS, typename Off>
__device__ __forceinline__ void load_rows(bf16* d1, const bf16* s1, bf16* d2,
                                          const bf16* s2, long long piece,
                                          int row0, int n_rows, Off off) {
  constexpr int CH = DH / 8, LD = DH + 8;
  for (int c = threadIdx.x; c < ROWS * CH; c += kThreads) {
    const int row = c / CH, ch = c - row * CH;
    const int r = row0 + row;
    const bool valid = r < n_rows;
    const long long o = valid ? off(r) + ch * 8 : 0;
#pragma unroll
    for (int pc = 0; pc < NP; ++pc) {
      const int to = (pc * ROWS + row) * LD + ch * 8;
      cp_async16(d1 + to, s1 + pc * piece + o, valid);
      if (d2 != nullptr) cp_async16(d2 + to, s2 + pc * piece + o, valid);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Sums over the four lanes that hold one row of a C tile.
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}
__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

// The kbias of the keys a thread's C-tile columns hold in key tile j of N
// keys (0 past t_eff, where the mask gives kDead).
template <int N>
__device__ __forceinline__ void load_kb(float (&kb)[N / 8][2], int j, int t4,
                                        const float* kbias, const Shape& p) {
  const int t0 = j * N + t4 * 2;
  if ((j + 1) * N <= p.t_eff) {
#pragma unroll
    for (int nb = 0; nb < N / 8; ++nb) {
      const float2 v =
          __ldg(reinterpret_cast<const float2*>(kbias + t0) + nb * 4);
      kb[nb][0] = v.x;
      kb[nb][1] = v.y;
    }
  } else {
#pragma unroll
    for (int nb = 0; nb < N / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = t0 + nb * 8 + e;
        kb[nb][e] = t < p.t_eff ? __ldg(kbias + t) : 0.f;
      }
  }
}

// The masked scores of a (16 x N) C tile of key tile j, for rows at
// positions qp. Where every pair of the tile is kept by position (`inner`)
// only kbias is added: 0 + kbias is kbias, so this is the plain version's
// sum too.
template <int N>
__device__ __forceinline__ void mask_tile(float (&s)[N / 8][4],
                                          const float (&kb)[N / 8][2], int j,
                                          int t4, const float (&qp)[2],
                                          const Shape& p, bool inner) {
  if (inner) {
#pragma unroll
    for (int nb = 0; nb < N / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] += kb[nb][e & 1];
  } else {
#pragma unroll
    for (int nb = 0; nb < N / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nb][e] = masked(s[nb][e], qp[e >> 1],
                          j * N + nb * 8 + t4 * 2 + (e & 1), kb[nb][e & 1],
                          p);
  }
}

// Whether every pair of key tile j (n keys a tile) is kept by position for
// the query tile whose bounds are bd (ops.live_tiles' full_lo, full_hi).
__device__ __forceinline__ bool inner_tile(int4 bd, int j, int n,
                                           const Shape& p) {
  return bd.z <= j && j < bd.w && (j + 1) * n <= p.t_eff;
}

// (1) The forward. Grid (query tiles, B * KV); a thread holds rows
// warp * 16 + lane / 4 and + 8 of its tile.
template <int DH, int NP>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  using C = Tiles<DH, NP>;
  constexpr int BM = C::BM, BN = C::BN, LD = C::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);   // [NP][BM][LD]
  bf16* sk = sq + NP * BM * LD;               // [2][NP][BN][LD]
  bf16* sv = sk + 2 * NP * BN * LD;           // [2][NP][BN][LD]
  const Shape& p = a.p;
  // the causal staircase's longest tiles first, so none starts last
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / p.kv, kv = blockIdx.y % p.kv;
  const int rows = p.s * p.g;
  const int4 bd = __ldg(reinterpret_cast<const int4*>(a.bounds) + tile);
  const int lo = bd.x, hi = bd.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const Rows at(p, b, kv, DH);
  auto q_off = [&](int r) { return at.q(r); };
  auto k_off = [&](int t) { return at.k(t); };

  load_rows<DH, NP, BM>(sq, a.q, nullptr, nullptr, a.q_piece, tile * BM,
                        rows, q_off);
  if (lo < hi)
    load_rows<DH, NP, BN>(sk, a.k, sv, a.v, a.k_piece, lo * BN, p.t_eff,
                          k_off);
  cp_async_commit();

  int row[2];
  float qp[2], m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = tile * BM + warp * 16 + (lane >> 2) + 8 * i;
    qp[i] = row[i] < rows ? __ldg(a.q_pos + at.pos(row[i])) : 0.f;
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  float acc[DH / 8][4];
  zero(acc);

  for (int j = lo; j < hi; ++j) {
    const int buf = (j - lo) & 1;
    if (j + 1 < hi) {
      const int nxt = (buf ^ 1) * NP * BN * LD;
      load_rows<DH, NP, BN>(sk + nxt, a.k, sv + nxt, a.v, a.k_piece,
                            (j + 1) * BN, p.t_eff, k_off);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* skb = sk + buf * NP * BN * LD;
    const bf16* svb = sv + buf * NP * BN * LD;

    float s[BN / 8][4];
    zero(s);
    mma_abt<DH, NP, BN>(s, sq, BM, warp * 16, skb, BN);
    float kb[BN / 8][2];
    load_kb<BN>(kb, j, t4, a.kbias, p);
    mask_tile<BN>(s, kb, j, t4, qp, p, inner_tile(bd, j, BN, p));

    // the online max and sum, as the plain version's
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
    float alpha[2], mxl[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = row_max(mx[i]);
      alpha[i] = ex2(fminf(m[i] - mx[i], 0.f) * kLog2e);
      m[i] = mx[i];
      mxl[i] = mx[i] * kLog2e;
    }
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[nb][e];
        const float pr =
            x <= 0.5f * kNegInf ? 0.f : ex2(x * kLog2e - mxl[e >> 1]);
        s[nb][e] = pr;
        sum[e >> 1] += pr;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + row_sum(sum[i]);
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] *= alpha[e >> 1];
    // P rounded to v's dtype (one bf16 piece for bf16 v), as the plain
    // version does before p.v
    mma_cb_add<DH, NP, BN, NP>(acc, s, svb, BN);
    __syncthreads();
  }
  cp_async_wait<0>();

  using Out = typename C::Out;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= rows) continue;
    const float ls = fmaxf(l[i], 1e-30f);
    const long long o = at.q(row[i]);
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      const int col = nd * 8 + t4 * 2;
      const float x = acc[nd][2 * i] / ls, y = acc[nd][2 * i + 1] / ls;
      store2(a.out32 + o + col, x, y);
      if (a.out != nullptr) store2(static_cast<Out*>(a.out) + o + col, x, y);
    }
    if (t4 == 0) {
      const long long si = at.stat(row[i]);
      a.m[si] = m[i];
      a.l[si] = l[i];
    }
  }
}

// (2) dQ, and delta for (3). Grid (query tiles, B * KV); rows as the
// forward's.
template <int DH, int NP>
__global__ void __launch_bounds__(kThreads, (Tiles<DH, NP>::DQ_BLOCKS))
    flash_bwd_dq_kernel(Args a) {
  using C = Tiles<DH, NP>;
  constexpr int BM = C::BM, BN = C::BN, LD = C::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);   // [NP][BM][LD]
  bf16* sdo = sq + NP * BM * LD;              // [NP][BM][LD]
  bf16* sk = sdo + NP * BM * LD;              // [2][NP][BN][LD]
  bf16* sv = sk + 2 * NP * BN * LD;           // [2][NP][BN][LD]
  const Shape& p = a.p;
  const int tile = gridDim.x - 1 - blockIdx.x;  // longest first
  const int b = blockIdx.y / p.kv, kv = blockIdx.y % p.kv;
  const int rows = p.s * p.g;
  const int4 bd = __ldg(reinterpret_cast<const int4*>(a.bounds) + tile);
  const int lo = bd.x, hi = bd.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const Rows at(p, b, kv, DH);
  auto q_off = [&](int r) { return at.q(r); };
  auto k_off = [&](int t) { return at.k(t); };

  load_rows<DH, NP, BM>(sq, a.q, sdo, a.dout, a.q_piece, tile * BM, rows,
                        q_off);
  cp_async_commit();
  if (lo < hi)
    load_rows<DH, NP, BN>(sk, a.k, sv, a.v, a.k_piece, lo * BN, p.t_eff,
                          k_off);
  cp_async_commit();

  int row[2];
  float qp[2], ml[2], il[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = tile * BM + warp * 16 + (lane >> 2) + 8 * i;
    const bool ok = row[i] < rows;
    const long long si = ok ? at.stat(row[i]) : 0;
    qp[i] = ok ? __ldg(a.q_pos + at.pos(row[i])) : 0.f;
    ml[i] = ok ? a.m[si] * kLog2e : 0.f;
    il[i] = ok ? 1.f / fmaxf(a.l[si], 1e-30f) : 0.f;
  }
  cp_async_wait<1>();
  __syncthreads();

  // delta = rowsum(dout * out32), dout summed from its pieces
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float d = 0.f;
    if (row[i] < rows) {
      const float* o = a.out32 + at.q(row[i]);
      const int r = warp * 16 + (lane >> 2) + 8 * i;
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nd * 8 + t4 * 2 + e;
          float x = 0.f;
#pragma unroll
          for (int pc = 0; pc < NP; ++pc)
            x += __bfloat162float(sdo[(pc * BM + r) * LD + col]);
          d += x * o[col];
        }
      }
    }
    dl[i] = row_sum(d);
    if (t4 == 0 && row[i] < rows) a.delta[at.stat(row[i])] = dl[i];
  }

  float dq[DH / 8][4];
  zero(dq);
  for (int j = lo; j < hi; ++j) {
    const int buf = (j - lo) & 1;
    if (j + 1 < hi) {
      const int nxt = (buf ^ 1) * NP * BN * LD;
      load_rows<DH, NP, BN>(sk + nxt, a.k, sv + nxt, a.v, a.k_piece,
                            (j + 1) * BN, p.t_eff, k_off);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* skb = sk + buf * NP * BN * LD;
    const bf16* svb = sv + buf * NP * BN * LD;

    float s[BN / 8][4], dp[BN / 8][4];
    zero(s);
    zero(dp);
    mma_abt<DH, NP, BN>(s, sq, BM, warp * 16, skb, BN);
    mma_abt<DH, NP, BN>(dp, sdo, BM, warp * 16, svb, BN);
    float kb[BN / 8][2];
    load_kb<BN>(kb, j, t4, a.kbias, p);
    mask_tile<BN>(s, kb, j, t4, qp, p, inner_tile(bd, j, BN, p));
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float x = s[nb][e];
        const float pr =
            x <= 0.5f * kNegInf ? 0.f : ex2(x * kLog2e - ml[i]) * il[i];
        s[nb][e] = pr * (dp[nb][e] - dl[i]);     // dS
      }
    }
    mma_cb_add<DH, NP, BN, 3>(dq, s, skb, BN);
    __syncthreads();
  }
  cp_async_wait<0>();

  using Out = typename C::Out;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= rows) continue;
    Out* o = static_cast<Out*>(a.dq) + at.q(row[i]);
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd)
      store2(o + nd * 8 + t4 * 2, dq[nd][2 * i], dq[nd][2 * i + 1]);
  }
}

// (3) dK and dV. Grid (key tiles of BKV, B * KV); a thread holds keys
// warp * 16 + lane / 4 and + 8 of its tile, and walks the query tiles (BQ
// rows, all G heads) whose live range holds this key tile.
template <int DH, int NP>
__global__ void __launch_bounds__(kThreads, (Tiles<DH, NP>::KV_BLOCKS))
    flash_bwd_dkdv_kernel(Args a) {
  using C = Tiles<DH, NP>;
  constexpr int BKV = C::BKV, BQ = C::BQ, LD = C::LD;
  static_assert(BQ <= kThreads, "a thread copies one row's statistics");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);   // [NP][BKV][LD]
  bf16* sv = sk + NP * BKV * LD;              // [NP][BKV][LD]
  bf16* sq = sv + NP * BKV * LD;              // [2][NP][BQ][LD]
  bf16* sdo = sq + 2 * NP * BQ * LD;          // [2][NP][BQ][LD]
  // [2][4][BQ]: each query row's position, m, l (then 1 / max(l, 1e-30)),
  // delta
  float* st = reinterpret_cast<float*>(sdo + 2 * NP * BQ * LD);
  const Shape& p = a.p;
  const int jt = blockIdx.x, b = blockIdx.y / p.kv, kv = blockIdx.y % p.kv;
  const int rows = p.s * p.g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const Rows at(p, b, kv, DH);
  auto q_off = [&](int r) { return at.q(r); };
  auto k_off = [&](int t) { return at.k(t); };
  // the first query tile from i on whose live range holds jt: each warp
  // tests 32 tiles at a time
  auto next_live = [&](int i) {
    for (; i < a.n_qt; i += 32) {
      const int c = i + lane;
      const unsigned live = __ballot_sync(
          kFull, c < a.n_qt && __ldg(a.bounds + 4 * c) <= jt &&
                     jt < __ldg(a.bounds + 4 * c + 1));
      if (live) return i + __ffs(live) - 1;
    }
    return a.n_qt;
  };
  auto load_q = [&](int i, int buf) {
    load_rows<DH, NP, BQ>(sq + buf * NP * BQ * LD, a.q,
                          sdo + buf * NP * BQ * LD, a.dout, a.q_piece, i * BQ,
                          rows, q_off);
    for (int c = threadIdx.x; c < BQ; c += kThreads) {
      const int r = i * BQ + c;
      const bool ok = r < rows;
      const long long si = ok ? at.stat(r) : 0;
      float* d = st + buf * 4 * BQ + c;
      cp_async4(d, ok ? a.q_pos + at.pos(r) : a.q_pos, ok);
      cp_async4(d + BQ, a.m + si, ok);
      cp_async4(d + 2 * BQ, a.l + si, ok);
      cp_async4(d + 3 * BQ, a.delta + si, ok);
    }
  };

  load_rows<DH, NP, BKV>(sk, a.k, sv, a.v, a.k_piece, jt * BKV, p.t_eff,
                         k_off);
  int i = next_live(0);
  if (i < a.n_qt) load_q(i, 0);
  cp_async_commit();

  int key[2];
  float kb[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    key[h] = jt * BKV + warp * 16 + (lane >> 2) + 8 * h;
    kb[h] = key[h] < p.t_eff ? __ldg(a.kbias + key[h]) : 0.f;
  }
  float dk[DH / 8][4], dv[DH / 8][4];
  zero(dk);
  zero(dv);

  int buf = 0;
  while (i < a.n_qt) {
    const int nxt = next_live(i + 1);
    if (nxt < a.n_qt) load_q(nxt, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    // the thread that copied a row's l in makes it 1 / max(l, 1e-30), as
    // the dQ kernel does, before the barrier shows it to the others
    if (threadIdx.x < BQ) {
      float* il = st + buf * 4 * BQ + 2 * BQ + threadIdx.x;
      *il = 1.f / fmaxf(*il, 1e-30f);
    }
    __syncthreads();
    const bf16* sqb = sq + buf * NP * BQ * LD;
    const bf16* sdob = sdo + buf * NP * BQ * LD;
    const float* stb = st + buf * 4 * BQ;

    // S^T (keys x query rows) and dP^T
    float s[BQ / 8][4], dp[BQ / 8][4];
    zero(s);
    zero(dp);
    mma_abt<DH, NP, BQ>(s, sk, BKV, warp * 16, sqb, BQ);
    mma_abt<DH, NP, BQ>(dp, sv, BKV, warp * 16, sdob, BQ);
    const bool inner = inner_tile(
        __ldg(reinterpret_cast<const int4*>(a.bounds) + i), jt, BKV, p);
    const bool all_rows = (i + 1) * BQ <= rows;
#pragma unroll
    for (int nb = 0; nb < BQ / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int c = nb * 8 + t4 * 2 + (e & 1);
        const float x = inner ? s[nb][e] + kb[h]
                              : masked(s[nb][e], stb[c], key[h], kb[h], p);
        const float pr = (all_rows || i * BQ + c < rows) &&
                                 x > 0.5f * kNegInf
                             ? __expf(x - stb[BQ + c]) * stb[2 * BQ + c]
                             : 0.f;
        s[nb][e] = pr;                                   // P^T
        dp[nb][e] = pr * (dp[nb][e] - stb[3 * BQ + c]);  // dS^T
      }
    }
    mma_cb_add<DH, NP, BQ, 3>(dv, s, sdob, BQ);
    mma_cb_add<DH, NP, BQ, 3>(dk, dp, sqb, BQ);
    __syncthreads();
    i = nxt;
    buf ^= 1;
  }
  cp_async_wait<0>();

  using Out = typename C::Out;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= p.t_eff) continue;
    const long long o = at.k(key[h]);
    Out* ok = static_cast<Out*>(a.dk) + o;
    Out* ov = static_cast<Out*>(a.dv) + o;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      store2(ok + nd * 8 + t4 * 2, dk[nd][2 * h], dk[nd][2 * h + 1]);
      store2(ov + nd * 8 + t4 * 2, dv[nd][2 * h], dv[nd][2 * h + 1]);
    }
  }
}

enum class Kind { kFwd, kDq, kDkdv };

template <int DH, int NP>
int smem_bytes(Kind kind) {
  using C = Tiles<DH, NP>;
  const int row = 2 * C::LD * NP;             // bytes of one row, all pieces
  switch (kind) {
    case Kind::kFwd: return (C::BM + 4 * C::BN) * row;
    case Kind::kDq: return (2 * C::BM + 4 * C::BN) * row;
    default: return (2 * C::BKV + 4 * C::BQ) * row + 2 * 4 * C::BQ * 4;
  }
}

template <int DH, int NP>
cudaError_t launch(Kind kind, const Args& a, int blocks, cudaStream_t stream) {
  void (*kernel)(Args) = kind == Kind::kFwd  ? flash_fwd_kernel<DH, NP>
                         : kind == Kind::kDq ? flash_bwd_dq_kernel<DH, NP>
                                             : flash_bwd_dkdv_kernel<DH, NP>;
  const int smem = smem_bytes<DH, NP>(kind);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks, a.p.b * a.p.kv);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch(int dh, int np, Kind kind, const Args& a, int blocks,
                     cudaStream_t stream) {
  if (blocks <= 0 || a.p.b * a.p.kv <= 0) return cudaSuccess;
  if ((long long)a.p.b * a.p.kv > 65535) return cudaErrorInvalidValue;
  if (np == 1) {
    switch (dh) {
      case 16: return launch<16, 1>(kind, a, blocks, stream);
      case 32: return launch<32, 1>(kind, a, blocks, stream);
      case 64: return launch<64, 1>(kind, a, blocks, stream);
      case 128: return launch<128, 1>(kind, a, blocks, stream);
    }
  } else if (np == 3) {
    switch (dh) {
      case 16: return launch<16, 3>(kind, a, blocks, stream);
      case 32: return launch<32, 3>(kind, a, blocks, stream);
      case 64: return launch<64, 3>(kind, a, blocks, stream);
      case 128: return launch<128, 3>(kind, a, blocks, stream);
    }
  }
  return cudaErrorInvalidValue;
}

template <int DH, int NP>
void tiles_of(int* out) {
  using C = Tiles<DH, NP>;
  out[0] = C::BM;
  out[1] = C::BN;
  out[2] = C::BQ;
  out[3] = C::BKV;
}

Shape shape_of(int b, int s, int t, int t_eff, int kv, int g, float window) {
  return Shape{b, s, t, t_eff, kv, g, window > 0.f ? window : 1e18f};
}

}  // namespace

extern "C" {

// The tiles a (dh, np) launch uses: (BM, BN, BQ, BKV). 0, or
// cudaErrorInvalidValue for a head size or piece count it does not take.
int flash_tiles(int dh, int np, int* out) {
  if (np == 1 || np == 3) {
    const bool one = np == 1;
    switch (dh) {
      case 16: one ? tiles_of<16, 1>(out) : tiles_of<16, 3>(out); return 0;
      case 32: one ? tiles_of<32, 1>(out) : tiles_of<32, 3>(out); return 0;
      case 64: one ? tiles_of<64, 1>(out) : tiles_of<64, 3>(out); return 0;
      case 128: one ? tiles_of<128, 1>(out) : tiles_of<128, 3>(out); return 0;
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The forward: writes out32, out (unless null), m and l. `bounds` holds
// n_qt rows (lo, hi, full_lo, full_hi) for tiles of BM query rows against
// BN keys: the live key tiles, and those every pair of is kept by
// position.
int flash_fwd(const void* q, const void* k, const void* v, long long q_piece,
              long long k_piece, const float* q_pos, const float* kbias,
              const int* bounds, int n_qt, float* out32, void* out, float* m,
              float* l, int b, int s, int t, int t_eff, int kv, int g, int dh,
              int np, float window, void* stream) {
  Args a{};
  a.p = shape_of(b, s, t, t_eff, kv, g, window);
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.q_piece = q_piece;
  a.k_piece = k_piece;
  a.q_pos = q_pos;
  a.kbias = kbias;
  a.bounds = bounds;
  a.n_qt = n_qt;
  a.out32 = out32;
  a.out = out;
  a.m = m;
  a.l = l;
  return (int)dispatch(dh, np, Kind::kFwd, a, n_qt, (cudaStream_t)stream);
}

// dq, and delta for each row; launch before flash_bwd_dkdv, which reads
// it. `bounds` as the forward's.
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, long long q_piece, long long k_piece,
                 const float* q_pos, const float* kbias, const int* bounds,
                 int n_qt, const float* out32, const float* m, const float* l,
                 float* delta, void* dq, int b, int s, int t, int t_eff,
                 int kv, int g, int dh, int np, float window, void* stream) {
  Args a{};
  a.p = shape_of(b, s, t, t_eff, kv, g, window);
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.q_piece = q_piece;
  a.k_piece = k_piece;
  a.q_pos = q_pos;
  a.kbias = kbias;
  a.bounds = bounds;
  a.n_qt = n_qt;
  a.out32 = const_cast<float*>(out32);
  a.m = const_cast<float*>(m);
  a.l = const_cast<float*>(l);
  a.delta = delta;
  a.dq = dq;
  return (int)dispatch(dh, np, Kind::kDq, a, n_qt, (cudaStream_t)stream);
}

// dk and dv over n_kt key tiles of BKV keys. `bounds` as the forward's, for
// tiles of BQ query rows against BKV keys.
int flash_bwd_dkdv(const void* q, const void* k, const void* v,
                   const void* dout, long long q_piece, long long k_piece,
                   const float* q_pos, const float* kbias, const int* bounds,
                   int n_qt, const float* m, const float* l,
                   const float* delta, void* dk, void* dv, int n_kt, int b,
                   int s, int t, int t_eff, int kv, int g, int dh, int np,
                   float window, void* stream) {
  Args a{};
  a.p = shape_of(b, s, t, t_eff, kv, g, window);
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.q_piece = q_piece;
  a.k_piece = k_piece;
  a.q_pos = q_pos;
  a.kbias = kbias;
  a.bounds = bounds;
  a.n_qt = n_qt;
  a.m = const_cast<float*>(m);
  a.l = const_cast<float*>(l);
  a.delta = const_cast<float*>(delta);
  a.dk = dk;
  a.dv = dv;
  return (int)dispatch(dh, np, Kind::kDkdv, a, n_kt, (cudaStream_t)stream);
}

const char* flash_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
