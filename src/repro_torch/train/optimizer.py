"""Optimizers: AdamW, Adafactor, and AdamW8 (block-quantized int8 states).

AdamW8 is the paper's dictionary-encoding idea applied to optimizer state:
moments are stored as int8 codes plus a per-row float32 scale
'dictionary', cutting optimizer memory from 8 to ~2.01 bytes/param. The
second moment is kept in the sqrt domain so int8 resolution applies
directly to the update denominator. Quantization error is absorbed by
re-quantizing after each update (m/v are smooth EMAs).

Adafactor keeps only factored second moments for >= 2-D params.

Parameters, gradients and states are pytrees of tensors in the reference's
structure: ``{"m", "v", "step"}`` (a quantized moment a ``{"q", "scale"}``
bundle) or ``{"f", "step"}``; ``step`` is a host int. :func:`apply_updates`
updates the parameters and the state in place, leaf by leaf under
``torch.no_grad()``, so the peak is one leaf's float32 temporaries, and
returns them as the reference returns its new ones. Each operation rounds
as the reference's: a bfloat16 parameter is updated in float32 and rounded
once, the scalars (bias corrections, Adafactor's decay, the clip factor)
are float32 tensors on the parameter's device.

On a mesh (DTensor parameters, gradients and states) each gradient is
first put on its parameter's placements (a ``Partial`` one summed); a
moment placed otherwise (ZeRO-1's ``data`` split) takes the gradient and
the parameter redistributed to its placements (:func:`_onto_state`), and
the updated parameter goes back to its own.
"""
from __future__ import annotations

from dataclasses import dataclass

import contextlib

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree

F32 = torch.float32


@dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"          # adamw | adamw8 | adafactor
    lr: float = 3e-4             # peak LR (schedule scales it)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


# ---------------------------------------------------------------------------
# int8 moment quantization (the 'state dictionary')
# ---------------------------------------------------------------------------
# Per-ROW scales (max|x| over the last dim): the int8 code tensor keeps the
# exact param shape. Small leaves (norm scales, biases) stay float32.
QUANT_MIN_SIZE = 65536


def _quantized(shape) -> bool:
    return len(shape) >= 2 and int(np.prod(shape)) >= QUANT_MIN_SIZE


def quantize_blockwise(x: torch.Tensor):
    """float32 moment -> ``{"q": int8 codes, "scale": per-row float32}``,
    rounding half to even; a leaf under 2-D or QUANT_MIN_SIZE stays a
    float32 tensor. The 127 is a tensor on ``x``'s device (a CUDA division
    by a host scalar multiplies by its reciprocal)."""
    x = x.float()
    if not _quantized(x.shape):
        return x
    scale = x.abs().amax(dim=-1) / x.new_full((), 127.0)
    q = torch.round(x / torch.clamp(scale[..., None], min=1e-12))
    return {"q": q.to(torch.int8), "scale": scale}


def dequantize_blockwise(d) -> torch.Tensor:
    if isinstance(d, dict):
        return d["q"].float() * torch.clamp(d["scale"], min=1e-12)[..., None]
    return d


# ---------------------------------------------------------------------------
# grad utils
# ---------------------------------------------------------------------------
def global_norm(tree) -> torch.Tensor:
    """Squares in each gradient's dtype, sums in float32 (no float32 copy
    of a bf16 gradient), leaves added from 0 in order. DTensor leaves go
    through :func:`_global_norm_sharded`."""
    leaves = pytree.tree_leaves(tree)
    if leaves and isinstance(leaves[0], DTensor):
        return _global_norm_sharded(leaves)
    return torch.sqrt(sum(torch.sum(g * g, dtype=F32) for g in leaves))


def _global_norm_sharded(leaves) -> torch.Tensor:
    """Each rank sums the squares of its shards, leaves grouped by the
    mesh axes (of more than one rank) that split them and added from 0 in
    order within a group; each group's sum is then summed over its axes
    (one all-reduce a group), and the groups added in order. A plain
    replicated float32 scalar. On a one-rank mesh it is
    :func:`global_norm`'s sum, bit for bit."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = leaves[0].device_mesh
    groups: dict = {}
    for g in leaves:
        key = tuple(i for i, (pl, n) in enumerate(zip(g.placements,
                                                     mesh.shape))
                    if n > 1 and isinstance(pl, Shard))
        loc = g.to_local()
        groups[key] = groups.get(key, 0) + torch.sum(loc * loc, dtype=F32)
    total = 0
    for key, part in groups.items():
        if key:
            part = DTensor.from_local(part, mesh, [
                Partial() if i in key else Replicate()
                for i in range(mesh.ndim)], run_check=False).full_tensor()
        total = total + part
    return torch.sqrt(total)


def _clip_factor(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(torch.full((), max_norm, dtype=F32,
                                  device=norm.device) /
                       torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    """-> (clipped tree, norm): each gradient times the float32 factor
    cast to its dtype."""
    norm = global_norm(tree)
    factor = _clip_factor(norm, max_norm)
    return pytree.tree_map(lambda g: g * factor.to(g.device, g.dtype),
                           tree), norm


def _scalar(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32).to(device)


def _bias_corrections(cfg: OptConfig, step: int):
    """1 - b ** step in float32, as the reference's ``b1 ** step.astype(
    f32)``."""
    s = torch.tensor(float(step), dtype=F32)
    return (1 - torch.pow(torch.tensor(cfg.b1, dtype=F32), s),
            1 - torch.pow(torch.tensor(cfg.b2, dtype=F32), s))


def _write(p: torch.Tensor, new32: torch.Tensor) -> None:
    """p <- new32 rounded once to p's dtype (a float32 p was updated in
    place already)."""
    if new32 is not p:
        p.copy_(new32)


def _decayed(p: torch.Tensor, update: torch.Tensor, cfg: OptConfig,
             lr: torch.Tensor) -> torch.Tensor:
    """p - lr * (update + wd * p), in float32; ``update`` is consumed."""
    update.add_(p.float() * cfg.weight_decay)
    update.mul_(lr)
    if p.dtype == F32:
        return p.sub_(update)
    return p.float().sub_(update)


def _gg(g32: torch.Tensor, b2: float) -> torch.Tensor:
    """(1 - b2) * g * g, rounded in that order."""
    return (g32 * (1 - b2)).mul_(g32)


def _adam_step(cfg, g32, m, v, p, bc1, bc2, lr) -> None:
    """m and v (float32) become the new moments, in place; p is updated."""
    m.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
    v.mul_(cfg.b2).add_(_gg(g32, cfg.b2))
    update = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
    _write(p, _decayed(p, update, cfg, lr))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def _adamw_init(params):
    # zeros_like: a DTensor parameter's moments are made on its rank only
    zeros = lambda p: torch.zeros_like(p, dtype=F32)
    return {"m": pytree.tree_map(zeros, params),
            "v": pytree.tree_map(zeros, params)}


def _adamw_leaf(cfg, g32, m, v, p, bc1, bc2, lr):
    _adam_step(cfg, g32(), m, v, p, bc1, bc2, lr)
    return m, v


# ---------------------------------------------------------------------------
# AdamW8 (quantized states)
# ---------------------------------------------------------------------------
def _adamw8_init(params):
    def qzeros(p):
        if not _quantized(p.shape):
            return torch.zeros_like(p, dtype=F32)
        return {"q": torch.zeros_like(p, dtype=torch.int8),
                "scale": torch.zeros(p.shape[:-1], dtype=F32,
                                     device=p.device)}
    return {"m": pytree.tree_map(qzeros, params),
            "v": pytree.tree_map(qzeros, params)}


def _requantized(dst, x: torch.Tensor):
    """quantize_blockwise(x), written into ``dst`` in place where both are
    bundles; otherwise the new bundle, or ``x`` itself (under
    QUANT_MIN_SIZE)."""
    src = quantize_blockwise(x)
    if not (isinstance(src, dict) and isinstance(dst, dict)):
        return src
    dst["q"].copy_(src["q"])
    dst["scale"].copy_(src["scale"])
    return dst


def _adamw8_one(cfg, g32, mq, vq, p, bc1, bc2, lr):
    """The reference's ``upd_one``: m is re-quantized whatever it was, v
    only where it was quantized (then in the sqrt domain: int8 resolution
    applies to the rsqrt denominator directly)."""
    quantized = isinstance(vq, dict)
    m = dequantize_blockwise(mq)
    v = dequantize_blockwise(vq)
    if quantized:
        v = v * v
    _adam_step(cfg, g32, m, v, p, bc1, bc2, lr)
    return (_requantized(mq, m),
            _requantized(vq, v.sqrt_()) if quantized else v)


def _adamw8_leaf(cfg, g32, mq, vq, p, bc1, bc2, lr):
    """A layer-stacked leaf goes one group at a time (the reference's
    lax.map), so only one group's float32 moments are live. As the
    reference's, a group under QUANT_MIN_SIZE comes back unquantized (its
    m, and its v in the sqrt domain): the leaf's v is plain float32 from
    then on, read as a plain-domain moment, and its m a bundle again from
    the next step."""
    if p.ndim >= 3 and p.shape[0] > 1 and isinstance(vq, dict):
        outs = [_adamw8_one(cfg, g32(i), {k: t[i] for k, t in mq.items()},
                            {k: t[i] for k, t in vq.items()}, p[i], bc1,
                            bc2, lr) for i in range(p.shape[0])]
        if isinstance(outs[0][0], dict):
            return mq, vq
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))
    return _adamw8_one(cfg, g32(), mq, vq, p, bc1, bc2, lr)


# ---------------------------------------------------------------------------
# Adafactor
# ---------------------------------------------------------------------------
def _adafactor_init(params):
    def st(p):
        z = lambda shape: torch.zeros(shape, dtype=F32, device=p.device)
        if p.ndim >= 2:
            return {"vr": z(p.shape[:-1]), "vc": z(p.shape[:-2] +
                                                  p.shape[-1:])}
        return {"v": z(p.shape)}
    return {"f": pytree.tree_map(st, params)}


def _adafactor_leaf(cfg, g32, s, p, decay, lr):
    g32 = g32()
    g2 = (g32 * g32).add_(1e-30)
    if p.ndim >= 2:
        s["vr"].mul_(decay).add_((1 - decay) * g2.mean(dim=-1))
        s["vc"].mul_(decay).add_((1 - decay) * g2.mean(dim=-2))
        del g2
        vr, vc = s["vr"], s["vc"]
        denom = (vr[..., None] * vc[..., None, :]).div_(torch.clamp(
            vr.mean(dim=-1, keepdim=True)[..., None], min=1e-30))
        update = g32.div_(torch.clamp(denom.sqrt_(), min=1e-30))
        del denom
    else:
        s["v"].mul_(decay).add_((1 - decay) * g2)
        update = g32.div_(torch.clamp(torch.sqrt(s["v"]), min=1e-30))
    # relative-scale clipping (Adafactor d=1)
    rms = torch.sqrt(torch.mean(update * update))
    update.div_(torch.clamp(rms, min=1.0))
    _write(p, _decayed(p, update, cfg, lr))
    return (s,)


# ---------------------------------------------------------------------------
# public surface
# ---------------------------------------------------------------------------
_INITS = {"adamw": _adamw_init, "adamw8": _adamw8_init,
          "adafactor": _adafactor_init}


def _walk(tree, *others):
    """(leaf, entries of ``others`` at the same path) for each leaf of
    ``tree``, matched by key (a dict's order does not matter)."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _walk(tree[k], *(o[k] for o in others))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _walk(x, *(o[i] for o in others))
    else:
        yield (tree, *others)


def _rebuild(tree, values):
    """``tree``'s structure with its leaves taken from ``values`` in
    :func:`_walk`'s order."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], values) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, values) for x in tree)
    return next(values)


def init_opt_state(cfg: OptConfig, params) -> dict:
    state = _INITS[cfg.name](params)
    state["step"] = 0
    return state


@torch.no_grad()
def apply_updates(cfg: OptConfig, grads, state: dict, params, lr,
                  stats: dict | None = None):
    """Returns (params, state), both updated in place. ``lr`` is the
    scheduled LR (a float32 scalar). The gradients are clipped to
    ``cfg.clip_norm`` by their global norm first (each times the float32
    factor cast to its dtype), leaf by leaf as each is updated; ``stats``,
    when given, receives that norm as ``"grad_norm"``. DTensor gradients
    are put on their parameters' placements in ``grads`` itself first."""
    sharded = isinstance(pytree.tree_leaves(params)[0], DTensor)
    if sharded:
        _settle(params, grads)
    factor = None
    if cfg.clip_norm > 0 or stats is not None:
        norm = global_norm(grads)
        if stats is not None:
            stats["grad_norm"] = norm
        if cfg.clip_norm > 0:
            factor = _clip_factor(norm, cfg.clip_norm)
    step = state["step"] + 1
    bc = _bias_corrections(cfg, step)
    decay = 1.0 - torch.pow(torch.tensor(float(step), dtype=F32), -0.8)
    keys = ("f",) if cfg.name == "adafactor" else ("m", "v")
    leaf = {"adamw": _adamw_leaf, "adamw8": _adamw8_leaf,
            "adafactor": _adafactor_leaf}[cfg.name]
    # the step's scalars go to the device once, not once a leaf
    dev = pytree.tree_leaves(params)[0].device
    scalars = ((decay.to(dev),) if cfg.name == "adafactor" else
               (bc[0].to(dev), bc[1].to(dev))) + (_scalar(lr, dev),)
    if sharded:
        from torch.distributed.tensor.experimental import \
            implicit_replication
    outs = []
    with implicit_replication() if sharded else contextlib.nullcontext():
        for p, g, *st in _walk(params, grads, *(state[k] for k in keys)):
            p_t = p
            if sharded:
                g, p_t = _onto_state(g, p, st)

            def g32(i=None, g=g):
                gi = g if i is None else g[i]
                if factor is None:
                    return gi.to(F32, copy=True)
                return (gi * factor.to(gi.dtype)).float()

            outs.append(leaf(cfg, g32, *st, p_t, *scalars))
            if p_t is not p:
                p.copy_(p_t.redistribute(p.device_mesh, p.placements))
    new = {k: _rebuild(params, (o[i] for o in outs))
           for i, k in enumerate(keys)}
    return params, dict(state, **new, step=step)


def _settle(params, grads) -> None:
    """Each DTensor gradient put on its parameter's placements (a
    ``Partial`` one summed over its axes), in ``grads``' own containers,
    so the unsummed one is freed as it goes."""
    items = grads.items() if isinstance(grads, dict) else enumerate(grads)
    for k, g in list(items):
        p = params[k]
        if isinstance(g, (dict, list)):
            _settle(p, g)
        elif tuple(g.placements) != tuple(p.placements):
            grads[k] = g.redistribute(p.device_mesh, p.placements)


def _onto_state(g, p, st):
    """(gradient, parameter) of one DTensor leaf, the gradient on its
    parameter's placements, moved to where its update runs: the first
    state tensor's placements (all replicated for Adafactor's factors,
    whose shape is not the parameter's). The parameter is itself where
    nothing moves, else a copy."""
    from torch.distributed.tensor import Replicate
    mesh = p.device_mesh
    first = pytree.tree_leaves(st)[0]
    target = tuple(first.placements) if first.shape == p.shape else \
        (Replicate(),) * mesh.ndim
    if tuple(g.placements) != target:
        g = g.redistribute(mesh, target)
    p_t = p if tuple(p.placements) == target else \
        p.redistribute(mesh, target)
    return g, p_t


def state_bytes_per_param(cfg: OptConfig) -> float:
    return {"adamw": 8.0, "adamw8": 2.01, "adafactor": 0.02}[cfg.name]


def state_bytes(state: dict) -> int:
    """Device bytes of an optimizer state's tensors."""
    return sum(t.numel() * t.element_size()
               for t in pytree.tree_leaves(state)
               if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# the reference's state <-> the port's
# ---------------------------------------------------------------------------
def opt_state_from_reference(state, device=None) -> dict:
    """The reference's optimizer state, its leaves as numpy arrays, -> the
    port's (tensors on ``device``, ``cuda`` unless named; ``step`` a host
    int), same structure."""
    from repro_torch.models.lm import params_from_reference
    out = {k: params_from_reference(v, device)
           for k, v in state.items() if k != "step"}
    out["step"] = int(np.asarray(state["step"]))
    return out


def opt_state_to_numpy(state: dict) -> dict:
    """The port's optimizer state as the reference's pytree of numpy arrays
    (``step`` an int32 scalar)."""
    from repro_torch.models.lm import params_to_numpy
    out = {k: params_to_numpy(v) for k, v in state.items() if k != "step"}
    out["step"] = np.asarray(state["step"], np.int32)
    return out
