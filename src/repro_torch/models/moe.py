"""Token-choice top-k MoE with capacity: the reference's routing decision
for decision, dispatched by index.

The reference (``repro/models/moe.py``) builds (G, S, E, C) one-hot
dispatch and combine tensors and contracts them with einsums, so GSPMD can
shard them; that one-hot tensor is the MoE analogue of the paper's one-hot
featurization of a categorical id (the expert). On one card the port works
out each (token, choice)'s (expert, slot) once, copies the kept rows into
an (E, G*C + 1, D) buffer (the last row takes the dropped pairs and is
never read back), runs the expert SwiGLU as batched products over the
experts, and gathers the results back weighted by the gates. No shape
depends on the data, so a decode step never waits on the card.
:func:`route` still returns the reference's dense ``dispatch`` and
``combine``, built from the same slot assignment, for tests and checks.

A group is one batch row (``blocks.apply_moe`` passes (B, S, D) as
(G, S, D)): the capacity is per row, and one request's routing never
depends on another's.

A check can watch and steer the routing with :func:`routing_trace`; outside
it nothing is recorded and nothing extra is computed.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor


def capacity(s: int, k: int, e: int, factor: float) -> int:
    return max(1, int(s * k / e * factor))


# -- routing trace (a check aid) -----------------------------------------------------
@dataclass
class Routed:
    """One ``moe_ff`` call's routing: ``idx`` (G,S,k) the experts taken
    (the forced ones when forced), ``top`` (G,S,min(k+1,E)) the call's own
    largest router probabilities in descending order, float32, and ``keep``
    (G,S,k) which (token, choice) pairs found a slot under the capacity.
    All three stay where the call ran; recording them launches nothing."""
    idx: torch.Tensor
    top: torch.Tensor
    keep: torch.Tensor

    @property
    def margin(self) -> torch.Tensor:
        """(G,S) the k-th minus the (k+1)-th probability: how far the
        top-k is from choosing another expert (inf when k == E)."""
        k = self.idx.shape[-1]
        if self.top.shape[-1] <= k:
            return torch.full(self.top.shape[:-1], float("inf"),
                              device=self.top.device)
        return self.top[..., k - 1] - self.top[..., k]


class RoutingTrace:
    """What :func:`routing_trace` yields: ``calls``, one :class:`Routed` a
    ``moe_ff`` call, in call order."""

    def __init__(self, forced=None):
        self.calls: list[Routed] = []
        self._forced = None if forced is None else list(forced)
        self._next = 0

    def _take_forced(self, shape, device) -> torch.Tensor | None:
        if self._forced is None:
            return None
        if self._next >= len(self._forced):
            raise RuntimeError(f"routing_trace: {len(self._forced)} forced "
                               "expert-id tensors, and a call past them")
        ids = self._forced[self._next].to(device=device, dtype=torch.int64)
        self._next += 1
        if tuple(ids.shape) != tuple(shape):
            raise ValueError(f"routing_trace: forced ids of shape "
                             f"{tuple(ids.shape)} for a call of {tuple(shape)}")
        return ids


_TRACE: contextvars.ContextVar[RoutingTrace | None] = contextvars.ContextVar(
    "moe_routing_trace", default=None)
# Inside _moe_ff_sharded, on a mesh that splits the batch or the experts:
# a local mean -> its mean over the ranks (a DTensor)
_SPLIT: contextvars.ContextVar = contextvars.ContextVar("moe_split",
                                                       default=None)


@contextlib.contextmanager
def routing_trace(forced=None):
    """``with routing_trace() as tr:`` — every ``moe_ff`` call inside
    appends its :class:`Routed` to ``tr.calls``. With ``forced`` (a list
    of (G,S,k) integer tensors, one a call in call order) the i-th call
    takes ``forced[i]`` as its experts in place of its own top-k; its gates
    are its own probabilities at those experts, renormalised over the k,
    and slots and drops follow the forced ids. A call past the list
    raises."""
    tr = RoutingTrace(forced)
    token = _TRACE.set(tr)
    try:
        yield tr
    finally:
        _TRACE.reset(token)


# -- the routing decision ------------------------------------------------------------
def _decide(router_logits: torch.Tensor, k: int, e: int, cap: int):
    """router_logits (G,S,E) -> (gates (G,S,k) float32, idx (G,S,k), pos
    (G,S,k) each pair's slot, keep (G,S,k) pos < cap, aux, z): the
    reference's ``route`` up to its one-hot tensors. Inside
    :func:`routing_trace` the call is recorded, and forced ids replace the
    top-k."""
    logits = router_logits.float()
    probs = torch.softmax(logits, dim=-1)
    # the k largest with ties to the lower expert id, as jax.lax.top_k
    # breaks them (torch.topk promises no order among equal values)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[..., :k], order[..., :k]
    tr = _TRACE.get()
    if tr is not None:
        forced = tr._take_forced(idx.shape, idx.device)
        if forced is not None:
            idx = forced
            gates = probs.gather(-1, idx)
    # normalize the k gates (moonshot/deepseek style)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # slot of each (token, choice) within its expert, filled slot-major:
    # every token's first choice before any token's second, in sequence
    # order within a choice (the reference's loop over the k choices is
    # one running count over the choices laid end to end)
    g, s, _ = idx.shape
    experts = torch.arange(e, device=idx.device)
    laid = idx.transpose(1, 2).reshape(g, k * s)                 # (G,kS)
    seen = torch.cumsum(laid[..., None] == experts, dim=1)        # (G,kS,E)
    pos = seen.gather(-1, laid[..., None])[..., 0] - 1
    pos = pos.reshape(g, k, s).transpose(1, 2)                    # (G,S,k)
    keep = pos < cap

    # load-balance loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(dim=(0, 1))
    ce = (idx[:, :, :1] == experts).float().mean(dim=(0, 1))
    aux, z = _balance(me, ce, e, logits)
    if tr is not None:
        tr.calls.append(Routed(idx, vals[..., :k + 1], keep))
    return gates, idx, pos, keep, aux, z


def _balance(me, ce, e: int, logits):
    """(aux, z) from the mean router probabilities ``me``, the mean
    first-choice counts ``ce`` and the logits. On a rank of a mesh that
    splits the batch or the experts (``_SPLIT``), ``me``, ``ce`` and the z
    term become their means over the ranks first."""
    split = _SPLIT.get()
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    if split is not None:
        me, ce, z = (split(t) for t in (me, ce, z))
    return e * torch.sum(me * ce), z


def route(router_logits: torch.Tensor, k: int, e: int, cap: int):
    """router_logits (G,S,E) -> dispatch (G,S,E,C) bfloat16, combine
    (G,S,E,C) float32, aux, z: the reference's dense tensors (tests and
    checks; ``moe_ff`` dispatches by index)."""
    gates, idx, pos, keep, aux, z = _decide(router_logits, k, e, cap)
    dev = idx.device
    slot = torch.where(keep, pos, cap)    # a dropped pair: column C, cut off
    at = (idx[..., None, None] == torch.arange(e, device=dev)[:, None]) & \
        (slot[..., None, None] == torch.arange(cap + 1, device=dev))
    at = at[..., :cap].float()                              # (G,S,k,E,C)
    dispatch = at.sum(dim=2).to(torch.bfloat16)
    combine = (at * gates[..., None, None]).sum(dim=2)
    return dispatch, combine, aux, z


# -- the layer ------------------------------------------------------------------------
def _silu(a: torch.Tensor) -> torch.Tensor:
    """``a * sigmoid(a)`` as XLA expands ``jax.nn.silu``: the sigmoid as
    ``1 / (1 + exp(-a))``, each op rounded to ``a``'s dtype (``F.silu``
    rounds once, and differs from the reference in bfloat16)."""
    return a * (1 / (1 + torch.exp(-a)))


def moe_ff(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
           w_up: torch.Tensor, w_down: torch.Tensor, *, top_k: int,
           cap_factor: float):
    """x (G,S,D); router_w (D,E) float32; expert weights (E,D,F)/(E,F,D).

    Returns (out (G,S,D) in x's dtype, aux, z). DTensor arguments go
    through :func:`_moe_ff_sharded`."""
    if isinstance(w_gate, DTensor):
        return _moe_ff_sharded(x, router_w, w_gate, w_up, w_down,
                               top_k=top_k, cap_factor=cap_factor)
    return _moe_ff(x, router_w, w_gate, w_up, w_down, top_k=top_k,
                   cap_factor=cap_factor)


def _moe_ff_sharded(x, router_w, w_gate, w_up, w_down, *, top_k: int,
                    cap_factor: float):
    """Expert parallelism on DTensors: every rank routes its own tokens
    (the batch split as ``x``'s, whole along the model axis), runs the
    experts it holds (a split over ``model`` of the expert dim, the
    EXPERT rule's) on the tokens routed to them, and the model axis sums
    the outputs (``Partial``). The balance terms are averaged over the
    batch ranks.

    Each rank's gradients are parts: the local tokens' and the router's
    over the model ranks (each sees its own experts'), the experts' and
    the router's over the batch ranks (each sees its own tokens). So the
    balance terms, the same on every model rank, enter as ``Partial`` sums
    of their share (value / ranks; exact for a power-of-two axis). With
    every expert on the rank it is :func:`_moe_ff` on the local
    tensors."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = w_gate.device_mesh
    sizes, names = mesh.shape, mesh.mesh_dim_names
    x_split = [isinstance(pl, Shard) and pl.dim == 0 and n > 1
               for pl, n in zip(x.placements, sizes)] \
        if isinstance(x, DTensor) else [False] * mesh.ndim
    e_split = [names[i] == "model" and n > 1 and not x_split[i] and
               w_gate.shape[0] % n == 0 for i, n in enumerate(sizes)]

    def local(t, split, summed=()):
        """``t``'s local tensor, split on dim 0 where ``split`` says, whole
        along the other axes of more than one rank (an axis of one rank
        keeps its placement: nothing to move); its gradient a sum over
        the axes in ``summed``."""
        if not isinstance(t, DTensor):
            return t
        pl = [t.placements[i] if n == 1 else Shard(0) if split[i] else
              Replicate() for i, n in enumerate(sizes)]
        t = t if list(t.placements) == pl else t.redistribute(mesh, pl)
        return t.to_local(grad_placements=[
            Partial() if i in summed else p for i, p in enumerate(pl)])

    # each rank's gradients: the tokens' a sum over the expert ranks, the
    # experts' over the batch ranks, the router's over both
    by_e = tuple(i for i, es in enumerate(e_split) if es)
    by_x = tuple(i for i, xs in enumerate(x_split) if xs)
    # x's two uses (the router's first, as the plain path makes them) each
    # take their own local tensor, so x's gradient sums the same terms in
    # the same order as the plain path's
    lx_router, lx = (local(x, x_split, by_e) for _ in range(2))
    lr = local(router_w, [False] * mesh.ndim, by_e + by_x)
    lg, lu, ld = (local(w, e_split, by_x) for w in (w_gate, w_up, w_down))
    e = router_w.shape[-1]
    e_local = lg.shape[0]
    coord = mesh.get_coordinate() or [0] * mesh.ndim
    first = sum(coord[i] for i in by_e) * e_local
    shared = [xs or es for xs, es in zip(x_split, e_split)]
    n_shared = math.prod(n for n, sh in zip(sizes, shared) if sh)

    def share(t):
        """A local mean (or a term every model rank holds) -> its mean over
        the batch ranks, as Partial sums of shares."""
        return DTensor.from_local(t / n_shared, mesh, [
            Partial() if sh else Replicate() for sh in shared],
            run_check=False)

    token = _SPLIT.set(share if any(shared) else None)
    try:
        out, aux, z = _moe_ff(lx, lr, lg, lu, ld, top_k=top_k,
                              cap_factor=cap_factor, experts=(first, e),
                              x_router=lx_router)
    finally:
        _SPLIT.reset(token)
    out = DTensor.from_local(out, mesh, [
        Shard(0) if xs else Partial() if es else Replicate()
        for xs, es in zip(x_split, e_split)], run_check=False)
    if not any(shared):          # one rank's worth: whole copies
        aux, z = (DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                     run_check=False) for t in (aux, z))
    return out, aux, z


def _moe_ff(x, router_w, w_gate, w_up, w_down, *, top_k: int,
            cap_factor: float, experts=None, x_router=None):
    """:func:`moe_ff` on plain tensors. ``experts`` = (first, E): the
    expert weights are experts [first, first + len) of E, and the output
    sums only theirs (all of them when None). ``x_router``: x's values
    for the router (x itself when None)."""
    g, s, d = x.shape
    e = router_w.shape[-1]
    cap = capacity(s, top_k, e, cap_factor)
    # float32 logits from x and the float32 router
    logits = (x if x_router is None else x_router).float() @ \
        router_w.float()
    gates, idx, pos, keep, aux, z = _decide(logits, top_k, e, cap)
    # each (token, choice)'s row of the (E, G*C + 1) buffer; every dropped
    # pair goes to the last row, whose products nothing reads back
    row = torch.arange(g, device=x.device)[:, None, None] * cap + pos
    if experts is not None and w_gate.shape[0] != e:
        # another rank's expert: its pair goes to the dropped row too
        idx = idx - experts[0]
        keep = keep & (idx >= 0) & (idx < w_gate.shape[0])
        idx = torch.where(keep, idx, 0)
        e = w_gate.shape[0]
    row = torch.where(keep, row, g * cap)
    buf = x.new_zeros((e, g * cap + 1, d))
    buf[idx, row] = x[:, :, None, :].expand(g, s, top_k, d)    # exact copies
    h = _silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    eout = torch.bmm(h, w_down)                             # (E, G*C + 1, D)
    # the gates rounded to x's dtype, as the reference's
    # combine.astype(x.dtype); each token's k products summed in float32
    # and rounded once
    w = gates.to(x.dtype).float()
    picked = eout[idx, row].float() * w[..., None]             # (G,S,k,D)
    picked = torch.where(keep[..., None], picked, 0.0)
    return picked.sum(dim=2).to(x.dtype), aux, z
