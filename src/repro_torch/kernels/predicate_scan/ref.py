"""Plain PyTorch versions of the predicate scan (``predicate_scan.cu``) and
of the bitmap compaction.

Each computes what its kernel or wrapper computes, on whatever device its
inputs are on: the wrappers in ``ops.py`` use the scan's for CPU tensors,
and on the card it is what the kernel is held against. Codes are read from
the packed words as ``adv_gather/ref.py`` reads them: in int64 (torch has
no uint32 shift on the CPU), word indices clamped to the stream, a 32-bit
field >= 2**31 negative as the reference's ``astype(int32)`` made it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.adv_gather.ref import packed_codes_ref


def predicate_scan_ref(flat_words: torch.Tensor, wmeta: torch.Tensor,
                       packed, n: int,
                       combine: str) -> tuple[torch.Tensor, torch.Tensor]:
    """((n,) bool mask, int64 match count) of the packed term table
    ``packed`` (:class:`~repro_torch.kernels.predicate_scan.ops.PackedTerms`)
    over rows [0, n) of the resident stream. Kind 0 is ``lo <= code <= hi``;
    kind 1 is ``lut[lut_off + clamp(code, 0, lut_len - 1)] != 0``; the terms
    fold with AND or OR."""
    rows = torch.arange(n, device=flat_words.device)
    meta = wmeta.tolist()
    codes_of: dict[int, torch.Tensor] = {}
    acc = None
    for col, kind, lo, hi, lut_off, lut_len in packed.table.tolist():
        codes = codes_of.get(col)
        if codes is None:
            off, db = meta[col]
            codes = codes_of[col] = packed_codes_ref(flat_words, off, db, rows)
        if kind == 0:
            m = (codes >= lo) & (codes <= hi)
        else:
            m = packed.lut[lut_off + codes.clamp(0, lut_len - 1)] != 0
        if acc is None:
            acc = m
        else:
            acc = (acc & m) if combine == "and" else (acc | m)
    return acc, acc.sum()


def compact_rows_ref(mask: torch.Tensor, cap: int,
                     fill: int = 0) -> torch.Tensor:
    """(cap,) int32: the ascending indices of the set rows of ``mask``,
    cut to ``cap``, then ``fill`` up to ``cap``."""
    rows = torch.nonzero(mask).reshape(-1)[:cap].to(torch.int32)
    out = torch.full((cap,), fill, dtype=torch.int32, device=mask.device)
    out[:rows.shape[0]] = rows
    return out
