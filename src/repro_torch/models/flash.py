"""Flash attention: an online softmax over KV chunks, so the (S, T) score
matrix is never held whole (O(S) memory per chunk of keys), forward and
backward.

GQA layout: q (B,S,KV,G,dh) [pre-scaled], k/v (B,T,KV,dh). Masking inputs:
  q_pos (S,) float32 absolute query positions,
  kbias (T,) float32 additive key bias (0 valid / -1e30 beyond kv_len),
  window: a host float (<= 0 -> full causal).

The backward is the reference's custom VJP (``repro/models/flash.py:
72-113``) as a ``torch.autograd.Function``: the forward saves only its
inputs and (out, m, l) per query, ``out`` the float32 accumulator before the
cast; the backward recomputes each chunk's probabilities from (q, k, m, l)
and accumulates dq, dk and dv chunk by chunk (the FlashAttention-2
dataflow), so one chunk's (S, chunk) float32 work is live at a time.

Those chunked scans are the plain version, run for CPU tensors (the CPU
tests hold them to the reference). A CUDA tensor takes the hand-written
kernels of :mod:`repro_torch.kernels.flash` (``flash.cu``): the same
saved tensors, the forward and the backward each fused on the tensor
cores, the key tiles the mask removes whole skipped.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels.flash import ops as kernel

NEG_INF = -1e30


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: float,
          kbias: torch.Tensor) -> torch.Tensor:
    diff = q_pos[:, None] - k_pos[None, :]
    keep = diff >= 0
    keep &= diff < (window if window > 0 else 1e18)
    return torch.where(keep, 0.0, NEG_INF) + kbias[None, :]


def _fwd_scan(qg, k, v, q_pos, kbias, window: float, kv_chunk: int):
    """-> (out (B,S,KV,G,dh) float32, m, l), the running max and
    denominator per (B,KV,G,S)."""
    b, s, kvh, g, dh = qg.shape
    t = k.shape[1]
    q32 = qg.float()
    m = torch.full((b, kvh, g, s), NEG_INF, dtype=torch.float32,
                   device=qg.device)
    l = torch.zeros((b, kvh, g, s), dtype=torch.float32, device=qg.device)
    acc = torch.zeros((b, kvh, g, s, dh), dtype=torch.float32,
                      device=qg.device)
    for c0 in range(0, t - t % kv_chunk, kv_chunk):
        ks = k[:, c0:c0 + kv_chunk]
        vs = v[:, c0:c0 + kv_chunk]
        scores = torch.einsum("bskgd,btkd->bkgst", q32, ks.float())
        k_pos = torch.arange(c0, c0 + kv_chunk, dtype=torch.float32,
                             device=qg.device)
        scores = scores + _mask(q_pos, k_pos, window,
                                kbias[c0:c0 + kv_chunk])
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(torch.clamp(m - m_new, max=0.0))
        p = torch.exp(scores - m_new[..., None])
        p = torch.where(scores <= NEG_INF / 2, 0.0, p)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgsc,bckd->bkgsd", p.to(v.dtype), vs)
        acc = acc * alpha[..., None] + pv.float()
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4), m, l        # -> (B,S,KV,G,dh)


def _bwd_scan(dout, qg, k, v, q_pos, kbias, out, m, l, window: float,
              kv_chunk: int):
    """-> (dq, dk, dv) in the inputs' dtypes, chunk by chunk of keys."""
    t = k.shape[1]
    l_safe = torch.clamp(l, min=1e-30)
    dout32 = dout.float()
    q32 = qg.float()
    # delta[b,k,g,s] = sum_d dout * out, from the float32 accumulator
    delta = torch.einsum("bskgd,bskgd->bkgs", dout32, out)
    dq = torch.zeros(qg.shape, dtype=torch.float32, device=qg.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for c0 in range(0, t - t % kv_chunk, kv_chunk):
        ks32 = k[:, c0:c0 + kv_chunk].float()
        vs32 = v[:, c0:c0 + kv_chunk].float()
        scores = torch.einsum("bskgd,btkd->bkgst", q32, ks32)
        k_pos = torch.arange(c0, c0 + kv_chunk, dtype=torch.float32,
                             device=qg.device)
        scores = scores + _mask(q_pos, k_pos, window,
                                kbias[c0:c0 + kv_chunk])
        p = torch.exp(scores - m[..., None]) / l_safe[..., None]
        p = torch.where(scores <= NEG_INF / 2, 0.0, p)
        del scores
        dv[:, c0:c0 + kv_chunk] = torch.einsum("bkgst,bskgd->btkd", p,
                                               dout32)
        dp = torch.einsum("bskgd,btkd->bkgst", dout32, vs32)
        ds = p * (dp - delta[..., None])
        del p, dp
        dq += torch.einsum("bkgst,btkd->bskgd", ds, ks32)
        dk[:, c0:c0 + kv_chunk] = torch.einsum("bkgst,bskgd->btkd", ds,
                                               q32)
    return dq.to(qg.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qg, k, v, q_pos, kbias, window: float, kv_chunk: int):
        with obs.span("attn.flash"):
            if qg.device.type == "cuda":
                out, out32, m, l, bounds = kernel.forward(
                    qg, k, v, q_pos, kbias, window, kv_chunk)
            else:
                out32, m, l = _fwd_scan(qg, k, v, q_pos, kbias, window,
                                        kv_chunk)
                out, bounds = out32.to(qg.dtype), None
        ctx.save_for_backward(qg, k, v, q_pos, kbias, out32, m, l)
        # the live tiles the forward's launch visited, which its dQ reuses
        ctx.bounds, ctx.window, ctx.kv_chunk = bounds, window, kv_chunk
        return out

    @staticmethod
    def backward(ctx, dout):
        with obs.span("attn.flash_bwd"):
            saved = ctx.saved_tensors
            if dout.device.type == "cuda":
                grads = kernel.backward(dout, *saved, ctx.bounds, ctx.window,
                                        ctx.kv_chunk)
            else:
                grads = _bwd_scan(dout, *saved, ctx.window, ctx.kv_chunk)
        return tuple(grads) + (None, None, None, None)


def flash_attention(qg, k, v, q_pos, kbias, window: float,
                    kv_chunk: int) -> torch.Tensor:
    """qg (B,S,KV,G,dh) pre-scaled; k, v (B,T,KV,dh). Returns
    (B,S,KV,G,dh) in qg's dtype. Differentiable in qg, k and v; ``q_pos``,
    ``kbias``, ``window`` and ``kv_chunk`` get no gradient."""
    return _Flash.apply(qg, k, v, q_pos, kbias, window, kv_chunk)
