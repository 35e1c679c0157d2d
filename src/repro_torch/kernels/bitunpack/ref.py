"""Plain PyTorch version of the bit-unpack kernel (``bitunpack.cu``).

It computes what the kernel computes, on whatever device its inputs are on:
the wrapper in ``ops.py`` uses it for CPU tensors, and on the card it is
what the kernel is held against. It is the divisor-width recipe of the
reference (a reshape, a shift and a mask, word-major and subfield-minor),
done in int64 on each word's unsigned value as ``adv_gather/ref.py``
``packed_codes_ref`` reads words: torch has no uint32 shift on the CPU,
and an int32 ``>>`` is arithmetic.
"""
from __future__ import annotations

import torch


def bitunpack_ref(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """(n,) int32 codes from ``words`` (uint32 words in int32 storage)
    packed at ``bits`` | 32. Words past the n codes are ignored; codes past
    the last word read zero words. A 32-bit field >= 2**31 comes out
    negative."""
    if bits < 1 or 32 % bits:
        raise ValueError(f"divisor unpack needs bits | 32, got {bits}")
    s = 32 // bits
    w_needed = -(-n // s)
    w = words[:w_needed].to(torch.int64) & 0xFFFFFFFF
    w = torch.nn.functional.pad(w, (0, w_needed - w.shape[0]))
    shifts = torch.arange(s, dtype=torch.int64, device=words.device) * bits
    fields = ((w[:, None] >> shifts[None, :]) & ((1 << bits) - 1))
    fields = fields.reshape(-1)[:n]
    return torch.where(fields > 0x7FFFFFFF, fields - (1 << 32),
                       fields).to(torch.int32)
