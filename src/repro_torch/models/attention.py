"""GQA attention with RoPE'd inputs: a direct path for decode and short
context, and the blockwise (flash-style online softmax) path of
:mod:`repro_torch.models.flash` past ``kv_chunk`` keys, so the (S, T) score
matrix of a long prefill is never held whole. Plain PyTorch ops: the
reference has no attention kernel either (XLA does its matmuls).
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.models.flash import NEG_INF, flash_attention


def _scores_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                 window) -> torch.Tensor:
    """(S, T) additive float32 mask: causal + optional sliding window
    (``window`` <= 0 means full attention). Masked entries are -1e30, not
    -inf, as in the reference."""
    diff = q_pos[:, None] - k_pos[None, :]
    keep = diff >= 0
    w = int(window)
    keep &= diff < (w if w > 0 else 1 << 30)
    return torch.where(keep, 0.0, NEG_INF)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B,S,KV,G,dh), k (B,T,KV,dh) -> (B,KV,G,S,T) float32: both upcast
    before the product, as ``preferred_element_type=float32`` asks."""
    return torch.einsum("bskgd,btkd->bkgst", q.float(), k.float())


def is_direct(s: int, t: int, kv_chunk: int = 1024) -> bool:
    """Whether :func:`attention` takes the direct path for S queries over T
    keys (decode or short context) rather than the flash path."""
    return s == 1 or t <= kv_chunk


def attention_mask(s: int, t: int, *, q_offset: int, window: int = 0,
                   kv_len: int | None = None, device=None) -> torch.Tensor:
    """The direct path's (S, T) additive float32 mask: causal, the sliding
    window, and keys at or past ``kv_len`` masked."""
    q_pos = q_offset + torch.arange(s, device=device)
    k_pos = torch.arange(t, device=device)
    mask = _scores_mask(q_pos, k_pos, window)
    if kv_len is not None:
        mask = mask + torch.where(k_pos[None, :] < kv_len, 0.0, NEG_INF)
    return mask


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              q_offset: int, window: int = 0, kv_len: int | None = None,
              kv_chunk: int = 1024, mask: torch.Tensor | None = None
              ) -> torch.Tensor:
    """Causal GQA attention.

    q: (B, S, H, dh); k, v: (B, T, KV, dh); q_offset: absolute position of
    q[0] (queries attend to keys at absolute positions). kv_len: number of
    valid cache entries (keys beyond are masked). mask: the direct path's
    :func:`attention_mask` for these arguments, when the caller built it
    already (every layer of a forward shares it). Returns (B, S, H, dh).
    """
    b, s, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, dh) * (dh ** -0.5)

    if is_direct(s, t, kv_chunk):
        # direct path: scores are small (decode or short context)
        with obs.span("attn.direct"):
            scores = _gqa_scores(qg, k)                  # (B,KV,G,S,T)
            if mask is None:
                mask = attention_mask(s, t, q_offset=q_offset,
                                      window=window, kv_len=kv_len,
                                      device=q.device)
            probs = torch.softmax(scores + mask, dim=-1).to(q.dtype)
            out = torch.einsum("bkgst,btkd->bskgd", probs, v)
        return out.reshape(b, s, h, dh)

    # flash path: O(S) memory (models/flash.py)
    assert t % kv_chunk == 0, f"kv len {t} % chunk {kv_chunk}"
    q_pos = q_offset + torch.arange(s, device=q.device)
    k_idx = torch.arange(t, device=q.device)
    if kv_len is not None:
        kbias = torch.where(k_idx < kv_len, 0.0, NEG_INF)
    else:
        kbias = torch.zeros((t,), dtype=torch.float32, device=q.device)
    out = flash_attention(qg, k, v, q_pos.float(), kbias, float(window),
                          kv_chunk)
    return out.reshape(b, s, h, dh)
