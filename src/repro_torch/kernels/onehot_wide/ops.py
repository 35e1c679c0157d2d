"""Wrappers for the one-hot wide layer and its gradient (``onehot_wide.cu``).

:func:`onehot_wide` is the wide half of Wide&Deep: ``out[n] = sum_c
W[c, codes[c, n]]``, differentiable in ``W`` through :class:`OneHotWide`.
:func:`onehot_wide_backward` is that gradient: dW, a scatter-add of the
output gradient at the in-range codes. A code outside ``[0, K)`` adds
nothing and gets no gradient (the TPU kernel's rule).

For CPU tensors both compute the plain versions (``ref.py``); for CUDA
tensors they launch the kernels on the current stream and raise if the
launch fails — there is no fallback. ``OneHotWide`` takes the same route
on every device, so the CPU runs the same backward wiring as the card.
``LAUNCHES`` counts kernel launches (only real launches, never
plain-version calls); a gradient counts once, also where its large-shape
route takes four launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import check, device_kind, raise_on, stream_ptr
from repro_torch.kernels.onehot_wide import ref

LAUNCHES = {"onehot_wide": 0, "onehot_wide_backward": 0}

_P, _I64, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "onehot_wide": ([_P, _P, _P, _I, _I64, _I64, _I64, _I, _P], _I),
    "onehot_wide_backward_scratch": ([_I, _I64, _I64, _I64], _I64),
    "onehot_wide_backward": ([_P, _P, _P, _I, _I64, _I64, _I64, _P, _P],
                             _I),
    "onehot_wide_error_string": ([_I], ctypes.c_char_p),
}
_INT32_MAX = (1 << 31) - 1
_W_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    return build.load("onehot_wide", _SIGNATURES)


def _check_codes(codes: torch.Tensor, device: torch.device) -> None:
    check("codes", codes, torch.int32, 2, device)
    if codes.shape[0] > _INT32_MAX:
        raise ValueError(f"at most 2**31 - 1 columns, got {codes.shape[0]}")


def onehot_wide(codes: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """codes (C, N) int32, w (C, K, F) float32 or bfloat16 -> (N, F) in
    w's dtype; differentiable in ``w`` (float32 only)."""
    device = codes.device
    _check_codes(codes, device)
    if w.dtype not in _W_DTYPES:
        raise TypeError(f"w must be float32 or bfloat16, got {w.dtype}")
    check("w", w, w.dtype, 3, device)
    if w.shape[0] != codes.shape[0]:
        raise ValueError(f"w has {w.shape[0]} columns, codes "
                         f"{codes.shape[0]}")
    if w.shape[1] < 1:
        raise ValueError("w needs at least one row per column (K >= 1)")
    return OneHotWide.apply(codes, w)


class OneHotWide(torch.autograd.Function):
    """The wide layer with its gradient in ``w``; none for ``codes``."""

    @staticmethod
    def forward(ctx, codes, w):
        ctx.save_for_backward(codes)
        ctx.k = w.shape[1]
        return _forward(codes, w)

    @staticmethod
    def backward(ctx, grad_out):
        (codes,) = ctx.saved_tensors
        return None, onehot_wide_backward(codes, grad_out.contiguous(), ctx.k)


def _forward(codes: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    device = codes.device
    if device_kind(device) == "cpu":
        return ref.onehot_wide_ref(codes, w)
    c, n = codes.shape
    _, k, f = w.shape
    if c == 0 or n == 0 or f == 0:
        return torch.zeros((n, f), dtype=w.dtype, device=device)
    out = torch.empty((n, f), dtype=w.dtype, device=device)
    lib = _lib()
    raise_on(lib.onehot_wide(
        codes.data_ptr(), w.data_ptr(), out.data_ptr(), c, n, k, f,
        int(w.dtype == torch.bfloat16), stream_ptr(device)),
        lib.onehot_wide_error_string, "onehot_wide")
    LAUNCHES["onehot_wide"] += 1
    return out


def onehot_wide_backward(codes: torch.Tensor, grad_out: torch.Tensor,
                         k: int) -> torch.Tensor:
    """dW (C, K, F) float32 of ``sum(onehot_wide(codes, w) * grad_out)``
    for (N, F) float32 ``grad_out``. Each entry is the float32 sum of its
    rows' ``grad_out`` in ascending row order from +0.0, on the card as on
    the CPU: the kernel equals the plain version run on the CPU (and
    ``jax.grad`` of the JAX package's ``onehot_wide_ref``) bit for bit, in
    every run. (The plain version on a CUDA tensor is not that order:
    ``index_add_`` there adds with atomics.)"""
    device = codes.device
    _check_codes(codes, device)
    check("grad_out", grad_out, torch.float32, 2, device)
    c, n = codes.shape
    if grad_out.shape[0] != n:
        raise ValueError(f"grad_out has {grad_out.shape[0]} rows, codes {n}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if device_kind(device) == "cpu":
        return ref.onehot_wide_backward_ref(codes, grad_out, k)
    f = grad_out.shape[1]
    if c == 0 or n == 0 or f == 0:
        return torch.zeros((c, k, f), dtype=torch.float32, device=device)
    dw = torch.empty((c, k, f), dtype=torch.float32, device=device)
    lib = _lib()
    # the large-shape route's grouping of rows by code: ends, then order
    scratch = torch.empty(lib.onehot_wide_backward_scratch(c, n, k, f),
                          dtype=torch.int32, device=device)
    raise_on(lib.onehot_wide_backward(
        codes.data_ptr(), grad_out.data_ptr(), dw.data_ptr(), c, n, k, f,
        scratch.data_ptr() or None, stream_ptr(device)),
        lib.onehot_wide_error_string, "onehot_wide_backward")
    LAUNCHES["onehot_wide_backward"] += 1
    return dw
