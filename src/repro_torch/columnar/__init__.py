"""Columnar storage substrate (paper §5): dictionary encoding, bit-packing,
RLE and count metadata — the host layer the device plans are compiled from.

A ``Table`` holds ``Column``s; each column is dictionary-encoded into small
integer *codes* stored bit-packed per IMCU (in-memory compression unit); the
``Dictionary`` carries min/max and per-entry counts (paper §6.2) and hosts
Augmented Dictionary Values (ADVs, paper §6.3) managed by
:mod:`repro_torch.core.adv`.
"""
from repro_torch.columnar.bitpack import bits_needed, pack_bits, unpack_bits
from repro_torch.columnar.rle import rle_encode, rle_decode
from repro_torch.columnar.dictionary import Dictionary
from repro_torch.columnar.column import Column, IMCU_ROWS
from repro_torch.columnar.table import Table

__all__ = [
    "bits_needed", "pack_bits", "unpack_bits",
    "rle_encode", "rle_decode",
    "Dictionary", "Column", "Table", "IMCU_ROWS",
]
