"""Plain PyTorch versions of the three ADV gather kernels.

Each computes what its CUDA kernel computes, by direct tensor indexing, on
whatever device its inputs are on. The wrappers in ``ops.py`` use them for
CPU tensors; on the card they are what each kernel is held against.

Packed words are uint32 values stored as int32. torch has no uint32 shift
on the CPU and an int32 ``>>`` is arithmetic, so fields are extracted in
int64 from the word's unsigned value. A 32-bit field >= 2**31 is then
wrapped to its int32 value (negative), which the clamp sends to row 0 —
the reference's ``astype(int32)`` followed by ``clip``.
"""
from __future__ import annotations

import torch


def packed_codes_ref(flat_words: torch.Tensor, word_off: int, db: int,
                     rows: torch.Tensor) -> torch.Tensor:
    """int64 codes of table ``rows`` in the column whose ``db``-bit words
    start at ``word_off`` of ``flat_words``. Negative rows read row 0 and
    word indices past the stream read its last word, as the kernels do."""
    s = 32 // db
    rows = rows.to(torch.int64).clamp(min=0)
    widx = (word_off + rows // s).clamp(max=flat_words.numel() - 1)
    w = flat_words[widx].to(torch.int64) & 0xFFFFFFFF
    field = (w >> ((rows % s) * db)) & ((1 << db) - 1)
    return torch.where(field > 0x7FFFFFFF, field - (1 << 32), field)


def gather_codes_ref(fused, codes) -> torch.Tensor:
    """Per-column codes (a sequence of C int tensors of n rows) ->
    (n, out_dim) float32: each code clamped into its table, then the
    table row copied into the column's slice of the output."""
    tables = fused.tables
    n = codes[0].shape[0] if len(codes) else 0
    out = torch.empty((n, fused.out_dim), dtype=torch.float32,
                      device=tables.device)
    for c, (limit, base, dim, col_off) in enumerate(fused.meta.tolist()):
        table = tables[base:base + (limit + 1) * dim].view(limit + 1, dim)
        out[:, col_off:col_off + dim] = table[codes[c].to(torch.int64)
                                              .clamp(0, limit)]
    return out


def adv_gather_packed_rows_ref(flat_words, wmeta, fused,
                               rows) -> torch.Tensor:
    """rows (n,) -> (n, out_dim): each column's code read from the resident
    word stream (``wmeta`` row c = word offset, device width), then
    gathered from its table."""
    codes = [packed_codes_ref(flat_words, off, db, rows)
             for off, db in wmeta.tolist()]
    if not codes:
        return torch.empty((rows.shape[0], 0), dtype=torch.float32,
                           device=flat_words.device)
    return gather_codes_ref(fused, codes)


def adv_gather_packed_ref(flat_words, wmeta, fused, starts,
                          batch: int) -> torch.Tensor:
    """K ranges [starts[k], starts[k] + batch) -> (K * batch, out_dim)."""
    rows = (starts.to(torch.int64)[:, None]
            + torch.arange(batch, device=starts.device)).reshape(-1)
    return adv_gather_packed_rows_ref(flat_words, wmeta, fused, rows)


def gather_fused_parts_ref(fused, codes: torch.Tensor) -> torch.Tensor:
    """codes (C, n) raw per-column codes -> (n, out_dim)."""
    if codes.shape[0] == 0:
        return torch.empty((codes.shape[1], 0), dtype=torch.float32,
                           device=codes.device)
    return gather_codes_ref(fused, list(codes))
