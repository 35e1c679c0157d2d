"""Plain PyTorch version of the masked-counts kernel (``hist.cu``).

It computes what the kernel computes, on whatever device its inputs are on:
the wrapper in ``ops.py`` uses it for CPU tensors, and on the card it is
what the kernel is held against. Codes are read from the packed words as
``adv_gather/ref.py`` reads them (in int64, word indices clamped to the
stream, 32-bit fields >= 2**31 negative).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.adv_gather.ref import packed_codes_ref


def masked_counts_ref(flat_words: torch.Tensor, off: int, db: int,
                      mask: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """(k,) int32 per-code counts of the rows in [0, n) where ``mask`` is
    set, for the column whose ``db``-bit words start at ``off``. Codes
    outside [0, k) are dropped."""
    codes = packed_codes_ref(flat_words, off, db,
                             torch.arange(n, device=flat_words.device))
    keep = (mask[:n] != 0) & (codes >= 0) & (codes < k)
    return torch.bincount(codes[keep], minlength=k).to(torch.int32)
