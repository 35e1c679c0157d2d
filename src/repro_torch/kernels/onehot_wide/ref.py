"""Plain PyTorch versions of the one-hot wide layer and its gradient
(``onehot_wide.cu``).

They compute what the kernels compute, on whatever device their inputs are
on: the wrapper in ``ops.py`` uses them for CPU tensors, and on the card
they are what the kernels are held against.

The rule is the TPU kernel's (``_onehot_wide_kernel``): a code outside
``[0, K)`` adds nothing to the output and gets no gradient. The forward sums
the columns in ascending ``c`` from +0.0 in float32, the order in which the
TPU kernel accumulates into its output tile, so in float32 it equals that
kernel bit for bit; for bfloat16 tables it accumulates in float32 and rounds
once.
"""
from __future__ import annotations

import torch


def valid_codes(codes: torch.Tensor, k: int) -> torch.Tensor:
    """(C, N) bool: which codes lie in ``[0, k)``."""
    return (codes >= 0) & (codes < k)


def onehot_wide_ref(codes: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """codes (C, N) int32, w (C, K, F) -> (N, F) in w's dtype:
    ``out[n] = sum_c w[c, codes[c, n]]`` over the in-range codes."""
    c, n = codes.shape
    _, k, f = w.shape
    valid = valid_codes(codes, k)
    safe = torch.where(valid, codes, 0).to(torch.int64)
    acc = torch.zeros((n, f), dtype=torch.float32, device=w.device)
    for ci in range(c):
        rows = w[ci].index_select(0, safe[ci]).to(torch.float32)
        acc = torch.where(valid[ci, :, None], acc + rows, acc)
    return acc.to(w.dtype)


def onehot_wide_backward_ref(codes: torch.Tensor, grad_out: torch.Tensor,
                             k: int) -> torch.Tensor:
    """dW (C, K, F) float32 of ``sum(onehot_wide(codes, w) * grad_out)``:
    zeros plus, for each column, ``grad_out`` rows added at the column's
    in-range codes."""
    c, n = codes.shape
    f = grad_out.shape[1]
    valid = valid_codes(codes, k)
    # flat row of W for each (c, n): c * K + code
    flat = codes.to(torch.int64) + k * torch.arange(
        c, device=codes.device, dtype=torch.int64)[:, None]
    src = grad_out.to(torch.float32)[None].expand(c, n, f)
    dw = torch.zeros((c * k, f), dtype=torch.float32, device=grad_out.device)
    dw.index_add_(0, flat[valid], src[valid])
    return dw.view(c, k, f)


def backward_sum_bound(codes: torch.Tensor, grad_out: torch.Tensor,
                       k: int) -> torch.Tensor:
    """(C, K, F) bound on how far two summation orders of the gradient can
    differ. Each entry of dW is a float32 sum of m terms; summed in any
    order it lies within (m - 1) * 2**-24 * sum|terms| of the exact sum, so
    two orders (say the plain version on the CPU, in ascending rows, and on
    a card, where ``index_add_`` adds with atomics) differ by at most twice
    that. The kernel keeps the CPU's order, so it needs no bound."""
    m = onehot_wide_backward_ref(
        codes, torch.ones_like(grad_out, dtype=torch.float32), k)
    abs_sum = onehot_wide_backward_ref(codes, grad_out.abs(), k)
    return 2.0 * (m - 1).clamp(min=0) * 2.0 ** -24 * abs_sum
