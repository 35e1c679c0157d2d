"""Bit-packing of dictionary codes (paper §5.1).

Codes with cardinality K need ``ceil(log2(K))`` bits each (Table 2 of the
paper). We pack b-bit codes into little-endian uint32 words, with fields
allowed to straddle word boundaries — the same consecutive bit-packed layout
the paper scans with SIMD/DAX. Host-side packing uses numpy;
:func:`unpack_bits_torch` is the tensor rendering of the unpack.
"""
from __future__ import annotations

import math

import numpy as np
import torch

WORD_BITS = 32


def bits_needed(cardinality: int) -> int:
    """Bits to encode ``cardinality`` distinct values (paper Table 2)."""
    if cardinality < 1:
        raise ValueError("cardinality must be >= 1")
    if cardinality == 1:
        return 1
    return int(math.ceil(math.log2(cardinality)))


def pack_bits(codes: np.ndarray, bits: int) -> np.ndarray:
    """Pack ``codes`` (non-negative ints < 2**bits) into a uint32 word stream.

    Fields are little-endian within and across words and may straddle word
    boundaries, giving the paper's fully-consecutive layout.
    """
    if not (1 <= bits <= WORD_BITS):
        raise ValueError(f"bits must be in [1, {WORD_BITS}], got {bits}")
    codes = np.asarray(codes, dtype=np.uint64)
    if codes.ndim != 1:
        raise ValueError("codes must be 1-D")
    if codes.size and int(codes.max()) >= (1 << bits):
        raise ValueError(f"code {int(codes.max())} does not fit in {bits} bits")
    n = codes.size
    total_bits = n * bits
    n_words = (total_bits + WORD_BITS - 1) // WORD_BITS
    # Accumulate into uint64 words then fold carries; vectorized two-word split.
    out = np.zeros(n_words + 1, dtype=np.uint64)
    bit_pos = np.arange(n, dtype=np.uint64) * np.uint64(bits)
    word_idx = (bit_pos // WORD_BITS).astype(np.int64)
    bit_off = (bit_pos % WORD_BITS).astype(np.uint64)
    lo = (codes << bit_off) & np.uint64(0xFFFFFFFF)
    hi = codes >> (np.uint64(WORD_BITS) - bit_off)  # bit_off==0 -> shift 32 ok on uint64
    np.bitwise_or.at(out, word_idx, lo)
    np.bitwise_or.at(out, word_idx + 1, hi)
    return out[:n_words].astype(np.uint32)


def unpack_bits(words: np.ndarray, bits: int, n: int) -> np.ndarray:
    """Inverse of :func:`pack_bits`; returns int32 codes (host/numpy path)."""
    words = np.asarray(words, dtype=np.uint64)
    bit_pos = np.arange(n, dtype=np.uint64) * np.uint64(bits)
    word_idx = (bit_pos // WORD_BITS).astype(np.int64)
    bit_off = (bit_pos % WORD_BITS).astype(np.uint64)
    padded = np.concatenate([words, np.zeros(1, dtype=np.uint64)])
    lo = padded[word_idx] >> bit_off
    hi = padded[word_idx + 1] << (np.uint64(WORD_BITS) - bit_off)
    mask = np.uint64((1 << bits) - 1)
    vals = np.where(bit_off == 0, lo & mask, (lo | hi) & mask)
    return vals.astype(np.int32)


def unpack_bits_torch(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Tensor rendering of :func:`unpack_bits`, on ``words``' device.

    ``words`` holds uint32 words in any integer dtype (the port stores them
    as int32); returns int32 codes of length ``n``. Arithmetic runs in int64
    on the words' unsigned values: torch has no uint32 shift on the CPU, and
    an int32 ``>>`` would be arithmetic, not logical.
    """
    w = words.to(torch.int64) & 0xFFFFFFFF
    bit_pos = torch.arange(n, dtype=torch.int64, device=w.device) * bits
    word_idx = bit_pos // WORD_BITS
    bit_off = bit_pos % WORD_BITS
    padded = torch.cat([w, w.new_zeros(1)])
    lo = padded[word_idx] >> bit_off
    # at bit_off == 0 the next word lands wholly above bit 31: the mask
    # drops it (an int64 shift by 32 is defined, unlike a uint32 one)
    hi = padded[word_idx + 1] << (WORD_BITS - bit_off)
    return ((lo | hi) & ((1 << bits) - 1)).to(torch.int32)


def packed_gather(words: np.ndarray, bits: int, rows: np.ndarray) -> np.ndarray:
    """Gather codes for arbitrary ``rows`` from divisor-width packed words.

    For device widths (bits | 32) fields never straddle words, so row ``r``
    is subfield ``r % s`` of word ``r // s`` — one vectorized word gather +
    shift/mask, touching O(len(rows)) words instead of unpacking the stream.
    """
    if 32 % bits:
        raise ValueError(f"packed_gather needs bits | 32, got {bits}")
    s = 32 // bits
    rows = np.asarray(rows, dtype=np.int64)
    w = np.asarray(words, dtype=np.uint32)[rows // s]
    fields = w >> ((rows % s).astype(np.uint32) * np.uint32(bits))
    if bits < 32:
        fields = fields & np.uint32((1 << bits) - 1)
    return fields.astype(np.int32)


def packed_nbytes(n: int, bits: int) -> int:
    """Bytes used by n codes packed at ``bits`` bits each."""
    return 4 * ((n * bits + WORD_BITS - 1) // WORD_BITS)
