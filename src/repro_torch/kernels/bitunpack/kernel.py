"""Device word widths for packed code streams (the unpack kernel is
``bitunpack.cu``, its wrapper ``ops.py``).

The device packs each column's codes at a width that divides 32
({1,2,4,8,16,32}), so no field straddles a word: row ``r`` is subfield
``r % (32/db)`` of word ``r // (32/db)``. That trades a bounded <= 2x
packing loss (e.g. 6 -> 8 bits) for an unpack that is one word load, one
shift and one mask per row. Host storage (columnar/bitpack.py) keeps exact
widths.
"""
from __future__ import annotations

DIVISOR_WIDTHS = (1, 2, 4, 8, 16, 32)


def tpu_width(bits: int) -> int:
    """Round a dictionary bit-width up to the next divisor of 32."""
    for w in DIVISOR_WIDTHS:
        if bits <= w:
            return w
    raise ValueError(f"bits {bits} > 32")
