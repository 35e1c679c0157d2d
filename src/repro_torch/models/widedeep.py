"""Wide&Deep over columnar ADV features — the paper's reference workload
(§2 cites Wide&Deep as the consumer of exactly these features).

Wide part: categorical codes -> one-hot linear layer, always through the
``onehot_wide`` kernel (a direct gather-sum; the one-hot is never built),
forward and backward. Deep part: dense ADV feature vector (normalizations,
bucketizations, embeddings gathered through the dictionary) -> MLP. Trained
end to end by plain SGD on every parameter; the learned embedding tables are
written back to the dictionary as learned ADVs by the analytics cycle
(:mod:`repro_torch.core.cycle`, paper §7).

Parameters are a dict of float32 tensors laid out as the JAX package lays
out its pytree — ``wide`` (C, K_max, n_out), ``bias`` (n_out,), ``embeds``
a list of (K, dim), ``mlp`` a list of ``{"w": (in, out), "b": (out,)}`` —
so :func:`params_from_reference` and :func:`params_to_numpy` carry them
across unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.pipeline import resolve_device
from repro_torch.kernels.onehot_wide import onehot_wide


@dataclass(frozen=True)
class WideDeepConfig:
    wide_cards: tuple            # cardinality per wide categorical column
    deep_dim: int                # ADV feature vector width
    embed_cols: tuple = ()       # (cardinality, dim) per embedded column
    hidden: tuple = (64, 32)
    n_out: int = 1               # 1 = binary logit


def init_widedeep(cfg: WideDeepConfig, generator: torch.Generator,
                  device=None) -> dict:
    """Zero wide tables and bias; embeddings and MLP weights drawn from
    ``generator`` (normal, scaled by 1/sqrt of the fan-in), as the
    reference initialises them. The numbers differ from JAX's for the same
    seed: carry a reference's parameters with :func:`params_from_reference`
    to compare the two."""
    device = resolve_device(device)

    def normal(*shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device).to(device)

    kmax = max(cfg.wide_cards) if cfg.wide_cards else 1
    params = {
        # stacked wide tables (C, K_max, n_out), padded to max cardinality
        "wide": torch.zeros((len(cfg.wide_cards), kmax, cfg.n_out),
                            dtype=torch.float32, device=device),
        "bias": torch.zeros((cfg.n_out,), dtype=torch.float32, device=device),
        "embeds": [normal(card, dim) / np.sqrt(dim)
                   for card, dim in cfg.embed_cols],
    }
    in_dim = cfg.deep_dim + sum(d for _, d in cfg.embed_cols)
    dims = (in_dim,) + tuple(cfg.hidden) + (cfg.n_out,)
    params["mlp"] = [
        {"w": normal(a, b) / np.sqrt(a),
         "b": torch.zeros((b,), dtype=torch.float32, device=device)}
        for a, b in zip(dims[:-1], dims[1:])]
    return params


def forward_widedeep(cfg: WideDeepConfig, params: dict,
                     wide_codes: torch.Tensor, deep_feats: torch.Tensor,
                     embed_codes=None) -> torch.Tensor:
    """wide_codes (C, N) int32; deep_feats (N, F); embed_codes list of (N,).
    Returns (N,) logits for ``n_out == 1`` (bias included), else
    (N, n_out) = wide + MLP without the bias, as the reference does."""
    wide = onehot_wide(wide_codes, params["wide"])
    h = deep_feats
    if embed_codes:
        embs = [tab[c] for tab, c in zip(params["embeds"], embed_codes)]
        h = torch.cat([h] + embs, dim=-1)
    for i, layer in enumerate(params["mlp"]):
        h = torch.matmul(h, layer["w"]) + layer["b"]
        if i < len(params["mlp"]) - 1:
            h = torch.relu(h)
    return (wide + h + params["bias"])[:, 0] if cfg.n_out == 1 else wide + h


def loss_widedeep(cfg: WideDeepConfig, params: dict, wide_codes, deep_feats,
                  labels, embed_codes=None) -> torch.Tensor:
    """Mean binary cross-entropy with logits, the reference's formula."""
    logits = forward_widedeep(cfg, params, wide_codes, deep_feats,
                              embed_codes)
    # torch.maximum splits the gradient at a tie as jnp.maximum does
    l = torch.maximum(logits, torch.zeros_like(logits)) - logits * labels + \
        torch.log1p(torch.exp(-torch.abs(logits)))
    return l.mean()


def make_widedeep_train_step(cfg: WideDeepConfig, lr: float = 0.05):
    """``step(params, wide_codes, deep_feats, labels, embed_codes) ->
    (new_params, loss)``: one plain SGD step on every parameter, the wide
    table and the embeddings included. ``params`` is left as it was."""

    def step(params, wide_codes, deep_feats, labels, embed_codes):
        leaves, spec = pytree.tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        loss = loss_widedeep(cfg, pytree.tree_unflatten(leaves, spec),
                             wide_codes, deep_feats, labels, embed_codes)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with torch.no_grad():
            new = [p if g is None else p - lr * g
                   for p, g in zip(leaves, grads)]
        return (pytree.tree_unflatten([p.detach() for p in new], spec),
                loss.detach())

    return step


def params_from_reference(params, device=None) -> dict:
    """The reference's parameter pytree, its leaves given as numpy arrays,
    -> the port's parameters (float32 tensors on ``device``)."""
    device = resolve_device(device)
    return pytree.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(device),
        params)


def params_to_numpy(params: dict) -> dict:
    """The port's parameters as the reference's pytree of numpy arrays."""
    return pytree.tree_map(lambda t: t.detach().cpu().numpy(), params)
