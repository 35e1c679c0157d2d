// The resident packed word layout, as every kernel of this package reads it.
//
// A column's codes are packed at db bits (db divides 32) into uint32 words
// that start at word_off: row r's field is bits (r % s) * db of word
// word_off + r / s, with s = 32 / db rows per word, so no field straddles a
// word (the layout of src/repro/kernels/bitunpack; the plain versions read
// it in adv_gather/ref.py packed_codes_ref). s is a power of two, so the
// division and the remainder are a shift and a mask: on a 64-bit r, / and %
// by a runtime s would cost a long division sequence per row and column.
#pragma once

#include <stdint.h>

// Code of row r (a negative r reads row 0) as int32: a 32-bit field
// >= 2**31 comes out negative, as the reference's astype(int32) made it.
// The word index is clamped to the stream, so no load leaves it (callers
// keep rows inside the stream's capacity).
static __device__ __forceinline__ int packed_code(
    const uint32_t* __restrict__ words, long long n_words, int word_off,
    int db, long long r) {
  if (r < 0) r = 0;
  const int lg = 6 - __ffs(db);                 // log2(32 / db)
  long long widx = word_off + (r >> lg);
  if (widx > n_words - 1) widx = n_words - 1;
  uint32_t field = __ldg(words + widx) >> ((int)(r & ((1 << lg) - 1)) * db);
  if (db < 32) field &= (1u << db) - 1u;
  return (int)field;
}
