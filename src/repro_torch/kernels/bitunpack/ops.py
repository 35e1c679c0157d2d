"""Host repack to a device width, and the bit-unpack kernel's wrapper
(``bitunpack.cu``).

- :func:`repack_for_device` packs host codes at the device width
  (:func:`~repro_torch.kernels.bitunpack.kernel.tpu_width`, a divisor of
  32), so no field straddles a word.
- :func:`bitunpack` unpacks ``n`` int32 codes from such words on the
  words' device.
- :func:`device_overhead` is the byte cost of the device width against
  exact packing.

Words are uint32 values in int32 storage, as the port keeps every packed
stream (``flat_words``): ``torch.from_numpy(words.view(np.int32))``.
For CPU tensors :func:`bitunpack` computes the plain version (``ref.py``);
for CUDA tensors it launches the kernel on the current stream and raises if
the launch fails — there is no fallback. ``LAUNCHES`` counts kernel
launches (only real launches, never plain-version calls).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.columnar.bitpack import pack_bits, packed_nbytes
from repro_torch.kernels import build
from repro_torch.kernels.bitunpack import ref
from repro_torch.kernels.bitunpack.kernel import DIVISOR_WIDTHS, tpu_width
from repro_torch.kernels.launch import check, device_kind, raise_on, stream_ptr

LAUNCHES = {"bitunpack": 0}

_P, _I64, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "bitunpack": ([_P, _I64, _I, _I64, _P, _P], _I),
    "bitunpack_error_string": ([_I], ctypes.c_char_p),
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def repack_for_device(codes: np.ndarray, bits: int) -> tuple[np.ndarray, int]:
    """Host: pack codes at the device width. Returns (uint32 words,
    device_bits)."""
    db = tpu_width(bits)
    return pack_bits(np.asarray(codes), db), db


def device_overhead(bits: int, n: int) -> float:
    """Bytes-overhead factor of the device width vs exact packing."""
    return packed_nbytes(n, tpu_width(bits)) / packed_nbytes(n, bits)


def bitunpack(words: torch.Tensor, device_bits: int, n: int) -> torch.Tensor:
    """(n,) int32 codes from ``words`` (W,) int32 storage of uint32 words
    packed at ``device_bits`` | 32: code i is field ``i % s`` of word
    ``i // s``, s = 32 / device_bits. Words past the n codes are ignored
    (a whole stream queried for a prefix); codes past the last word read
    zero words. A 32-bit field >= 2**31 comes out negative."""
    device = words.device
    check("words", words, torch.int32, 1, device)
    if device_bits not in DIVISOR_WIDTHS:
        raise ValueError(f"device path needs bits | 32, got {device_bits} "
                         "(use tpu_width + repack_for_device)")
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if device_kind(device) == "cpu":
        return ref.bitunpack_ref(words, device_bits, n)
    out = torch.empty(n, dtype=torch.int32, device=device)
    if n == 0:
        return out
    lib = build.load("bitunpack", _SIGNATURES)
    raise_on(lib.bitunpack(words.data_ptr(), words.numel(), device_bits, n,
                           out.data_ptr(), stream_ptr(device)),
             lib.bitunpack_error_string, "bitunpack")
    LAUNCHES["bitunpack"] += 1
    return out
