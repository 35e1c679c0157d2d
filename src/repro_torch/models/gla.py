"""Chunked gated linear attention: the recurrence core shared by mLSTM
(xLSTM) and the SSD/Mamba heads of Hymba.

The state per head is an outer-product memory S_t = a_t S_{t-1} + k_t v_t^T
(a_t in (0, 1] per step), read as o_t = q_t^T S_t. The chunked form turns
the recurrence into matrix products: within a chunk a (C x C)
decay-masked attention, across chunks a state update carried by a Python
loop over the chunks. O(S C) instead of O(S^2), and a constant state for
decode.

mLSTM's normalizer n_t = a_t n_{t-1} + k_t is carried as a separate
(B,H,DK) state. The dtypes are the reference's, step by step: the inputs
stay in their compute dtype (bfloat16 when served); the decay, the
normalizer and the state accumulate in float32 (the intra-chunk decays as
segment sums, not as differences of one cumsum); a product the reference
asks for in float32 (``preferred_element_type``) is a float32 product of
the upcast inputs (exact products; TF32 stays off); the decayed q and k
round in the input dtype, and the intra-chunk scores round to the value
dtype before their product with V, as the reference rounds them.
"""
from __future__ import annotations

import torch


def chunked_gla(q, k, v, log_a, *, chunk: int = 256, normalizer: bool = False):
    """q,k: (B,S,H,DK); v: (B,S,H,DV); log_a: (B,S,H) in (-inf, 0]. The
    state starts from zero.

    Returns (out (B,S,H,DV) in q's dtype, final_state (B,H,DK,DV) float32)
    and, with ``normalizer=True``, also (n_out (B,S,H), n_state (B,H,DK)),
    both float32.
    """
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk}")
    la = log_a.float()
    state = q.new_zeros((b, h, dk, dv), dtype=torch.float32)
    nstate = q.new_zeros((b, h, dk), dtype=torch.float32)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=q.device).tril()
    strict = causal.tril(-1)
    outs, n_outs = [], []
    for c0 in range(0, s, chunk):
        qi, ki = q[:, c0:c0 + chunk], k[:, c0:c0 + chunk]
        vi, lai = v[:, c0:c0 + chunk], la[:, c0:c0 + chunk]
        cum = torch.cumsum(lai, dim=1)           # (B,C,H) decay to chunk start
        total = cum[:, -1:, :]                   # (B,1,H)
        q_dec = qi * torch.exp(cum)[..., None].to(qi.dtype)
        # inter-chunk: o_inter[t] = (q_t * a^{cum_t}) @ S_prev
        o_inter = torch.einsum("bchk,bhkv->bchv", q_dec.float(), state)
        # intra-chunk: scores[t,u] = q_t.k_u * a^{cum_t - cum_u}, u <= t;
        # where(), not a product with the mask: exp(dec) above the
        # diagonal can be inf
        scores = torch.einsum("bchk,buhk->bhcu", qi.float(), ki.float())
        # dec[t,u] = the sum of la over (u, t], summed afresh from u+1
        # for each u (the reference takes cum_t - cum_u): the same value,
        # but its gradient sums only the steps between u and t, where the
        # difference's gradient cancels the prefix both cumsums share
        dec = torch.cumsum(torch.where(strict[None, :, :, None],
                                       lai[:, :, None, :], 0.0), dim=1)
        w = torch.where(causal[None, :, :, None], torch.exp(dec), 0.0)
        scores = scores * w.permute(0, 3, 1, 2)
        o_intra = torch.einsum("bhcu,buhv->bchv",
                               scores.to(vi.dtype).float(), vi.float())
        # state update: S = a^{total} S + sum_u a^{total-cum_u} k_u v_u^T
        k_dec = ki * torch.exp(total - cum)[..., None].to(ki.dtype)
        decay = torch.exp(total).permute(0, 2, 1)            # (B,H,1)
        if normalizer:
            # shares the scores and decay: n_t = q_t.(decayed running k)
            n_inter = torch.einsum("bchk,bhk->bch", q_dec.float(), nstate)
            n_intra = scores.sum(dim=-1).permute(0, 2, 1)     # (B,C,H)
            n_outs.append(n_inter + n_intra)
            nstate = nstate * decay + k_dec.float().sum(dim=1)
        state = state * decay[..., None] + torch.einsum(
            "buhk,buhv->bhkv", k_dec.float(), vi.float())
        outs.append(o_inter + o_intra)
    out = torch.cat(outs, dim=1).to(q.dtype)
    if not normalizer:
        return out, state
    return out, state, torch.cat(n_outs, dim=1), nstate


def gla_step(state, q, k, v, log_a, nstate=None):
    """One decode step, in float32. state (B,H,DK,DV); q,k (B,H,DK); v
    (B,H,DV); log_a (B,H). Returns (new_state, out in q's dtype) or, with
    ``nstate`` given, (new_state, out, new_nstate, n_out (B,H))."""
    a = torch.exp(log_a.float())[..., None, None]
    s_new = state * a + torch.einsum("bhk,bhv->bhkv", k.float(), v.float())
    out = torch.einsum("bhk,bhkv->bhv", q.float(), s_new)
    if nstate is None:
        return s_new, out.to(q.dtype)
    n_new = nstate * a[..., 0] + k.float()
    n_out = torch.einsum("bhk,bhk->bh", q.float(), n_new)
    return s_new, out.to(q.dtype), n_new, n_out


def gla_ref(q, k, v, log_a):
    """The sequential oracle (one :func:`gla_step` a token), for tests."""
    b, s, h, dk = q.shape
    state = q.new_zeros((b, h, dk, v.shape[-1]), dtype=torch.float32)
    outs = []
    for t in range(s):
        state, o = gla_step(state, q[:, t], k[:, t], v[:, t], log_a[:, t])
        outs.append(o)
    return torch.stack(outs, dim=1), state
