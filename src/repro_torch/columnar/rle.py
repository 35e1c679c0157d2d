"""Run-length encoding on dictionary codes (paper §5.2).

RLE stacks on top of dictionary encoding and shines on sorted/semi-sorted
columns. Decode is variable-rate and sequential, so it is a host-side
storage codec (numpy); a cumsum-based tensor decode is provided for
block-aligned device use.
"""
from __future__ import annotations

import numpy as np
import torch


def rle_encode(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Return (values, run_lengths), both int32/int64-safe numpy arrays."""
    codes = np.asarray(codes)
    if codes.ndim != 1:
        raise ValueError("codes must be 1-D")
    n = codes.size
    if n == 0:
        return codes[:0].astype(np.int32), np.zeros(0, dtype=np.int64)
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(codes[1:], codes[:-1], out=change[1:])
    starts = np.flatnonzero(change)
    values = codes[starts].astype(np.int32)
    lengths = np.diff(np.append(starts, n)).astype(np.int64)
    return values, lengths


def rle_decode(values: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    return np.repeat(np.asarray(values), np.asarray(lengths)).astype(np.int32)


def rle_decode_torch(values: torch.Tensor, lengths: torch.Tensor,
                     n: int) -> torch.Tensor:
    """Device decode for a fixed output length ``n`` (cumsum + searchsorted)."""
    ends = torch.cumsum(lengths.to(torch.int64), 0)
    pos = torch.arange(n, dtype=torch.int64, device=values.device)
    run = torch.searchsorted(ends, pos, right=True)
    run = run.clamp(0, values.shape[0] - 1)
    return values[run].to(torch.int32)


def rle_nbytes(values: np.ndarray, lengths: np.ndarray, value_bits: int) -> int:
    """Storage estimate: value_bits per value + run lengths at their
    ACTUAL dtype width (int64 lengths cost 8 B/run, not a flattering 4)."""
    n_runs = int(np.asarray(values).size)
    lengths = np.asarray(lengths)
    return (n_runs * value_bits + 7) // 8 + lengths.dtype.itemsize * n_runs
