"""Plain PyTorch versions of the two counts kernels (``hist.cu``).

Each computes what its kernel computes, on whatever device its inputs are
on: the wrappers in ``ops.py`` use them for CPU tensors, and on the card
they are what each kernel is held against. Both drop codes outside
[0, k), as the Pallas kernels do; the reference's jnp oracle
(``jnp.bincount``) would count a negative code as code 0. The masked
counts read codes from the packed words as ``adv_gather/ref.py`` reads them
(in int64, word indices clamped to the stream, 32-bit fields >= 2**31
negative).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.adv_gather.ref import packed_codes_ref


def hist_ref(codes: torch.Tensor, k: int) -> torch.Tensor:
    """(k,) int32 counts of each code in [0, k) among ``codes`` (any
    shape); other codes are dropped."""
    flat = codes.reshape(-1)
    keep = (flat >= 0) & (flat < k)
    return torch.bincount(flat[keep].to(torch.int64),
                          minlength=k).to(torch.int32)


def masked_counts_ref(flat_words: torch.Tensor, off: int, db: int,
                      mask: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """(k,) int32 per-code counts of the rows in [0, n) where ``mask`` is
    set, for the column whose ``db``-bit words start at ``off``. Codes
    outside [0, k) are dropped."""
    codes = packed_codes_ref(flat_words, off, db,
                             torch.arange(n, device=flat_words.device))
    keep = (mask[:n] != 0) & (codes >= 0) & (codes < k)
    return torch.bincount(codes[keep], minlength=k).to(torch.int32)
