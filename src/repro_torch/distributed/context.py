"""Activation sharding: lets the model code place its activations on the
active mesh without a mesh in every signature, and run its sequential
cores (attention, the recurrences, the MoE dispatch) on each rank's local
tensors.

The residual stream between layer groups is the largest liveness in
training (one (B, S, D) tensor a group); placing it ``Shard`` over
``model`` on the sequence (Megatron sequence parallelism) shrinks that
term by the model axis and turns each group's tensor-parallel all-reduce
into a reduce-scatter / all-gather pair. The dry-run and the sharded
trainer turn it on with :func:`activation_mesh`; without an active mesh,
or on a plain tensor, every function here returns its input untouched and
adds no operator.
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree

_STATE: dict = {"mesh": None}


@contextlib.contextmanager
def activation_mesh(mesh):
    """Makes ``mesh`` (a ``DeviceMesh`` or None) the active mesh."""
    prev = _STATE["mesh"]
    _STATE["mesh"] = mesh
    try:
        yield
    finally:
        _STATE["mesh"] = prev


def current_mesh():
    return _STATE["mesh"]


def _size(mesh, name: str) -> int:
    names = mesh.mesh_dim_names
    return mesh.shape[names.index(name)] if name in names else 1


def _batch_axes_for(mesh, b: int, axes=("pod", "data")):
    """The axes of ``axes`` on the mesh if their product divides ``b``,
    else the first one that does, else None."""
    axes = tuple(a for a in axes if a in mesh.mesh_dim_names)
    if axes and b % math.prod(_size(mesh, a) for a in axes) == 0:
        return axes
    for a in axes:
        if b % _size(mesh, a) == 0:
            return (a,)
    return None


def _constrain(x, mesh, spec):
    from repro_torch.distributed.sharding import placements
    pl = placements(spec, mesh)
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(mesh, pl)


def _active(x):
    """The active mesh where ``x`` is a DTensor on it, else None."""
    mesh = _STATE["mesh"]
    if mesh is None or not isinstance(x, DTensor):
        return None
    return mesh


def constrain_last(x):
    """The last dim over ``model`` where it divides (GLA value and state
    tensors), the batch dim over the DP axes when 3-D or more."""
    mesh = _active(x)
    if mesh is None or x.ndim < 2:
        return x
    m = _size(mesh, "model")
    if not (m > 1 and x.shape[-1] % m == 0):
        return x
    ba = _batch_axes_for(mesh, x.shape[0]) if x.ndim >= 3 else None
    return _constrain(x, mesh, (ba,) + (None,) * (x.ndim - 2) + ("model",))


def constrain_residual(x, prefer: str = "seq"):
    """The residual stream (B, S, D) on the active mesh:

    - ``"seq"``: (batch, ``model``, None), Megatron-SP for attention
      stacks;
    - ``"channel"``: (batch, None, ``model``), for recurrent stacks, whose
      scan runs along S (a sequence split would gather it whole);
    - ``"dp"``: the batch over every axis (``pure_dp``)."""
    mesh = _active(x)
    if mesh is None or x.ndim != 3:
        return x
    b, s, d = x.shape
    m = _size(mesh, "model")
    if prefer == "dp":
        axes = tuple(a for a in ("pod", "data", "model")
                     if a in mesh.mesh_dim_names)
        ba = axes if b % math.prod(_size(mesh, a) for a in axes) == 0 \
            else _batch_axes_for(mesh, b)
        return _constrain(x, mesh, (ba, None, None))
    ba = _batch_axes_for(mesh, b)
    if prefer == "channel":
        return _constrain(x, mesh, (ba, None,
                                    "model" if m > 1 and d % m == 0
                                    else None))
    return _constrain(x, mesh, (ba, "model" if m > 1 and s > 1 and
                                s % m == 0 else None, None))


def gather_weights(tree, keep_model: bool = True):
    """A group's (or any) parameters as the products use them: each DTensor
    gathered over the mesh axes that shard it for storage only (FSDP's
    ``data``/``pod``, and under ``pure_dp`` ``model`` too, ZeRO-3), its
    tensor-parallel split over ``model`` kept where ``keep_model``. Its
    backward reduce-scatters the gradient onto the stored split. A tree
    of plain tensors comes back as it is."""
    leaves = pytree.tree_leaves(tree)
    if not leaves or not isinstance(leaves[0], DTensor):
        return tree
    from torch.distributed.tensor import Replicate

    def whole(t):
        names = t.device_mesh.mesh_dim_names
        pl = [p if n == 1 or not p.is_shard() or
              (keep_model and names[i] == "model") else Replicate()
              for i, (p, n) in enumerate(zip(t.placements,
                                             t.device_mesh.shape))]
        return t if pl == list(t.placements) else \
            t.redistribute(t.device_mesh, pl)

    return pytree.tree_map(whole, tree)


def seq_whole(x):
    """A DTensor split along dim 1 (the sequence) gathered whole along it;
    anything else as it is. Products take the sequence whole: a (B, S, D)
    operand split on S and flattened to (B*S, D) would make a strided
    split, which DTensor cannot plan under ``FakeTensorMode``."""
    if not isinstance(x, DTensor):
        return x
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
          for p in x.placements]
    return x if pl == list(x.placements) else \
        x.redistribute(x.device_mesh, pl)


def residual_add(x, y):
    """``x + y``, the residual stream ``x`` plus a sublayer's output. On
    DTensors ``y`` is first put where ``x`` lies (a ``Partial`` sum
    reduce-scattered onto a sequence split, Megatron-SP), so the gradient
    the sublayer receives is whole along the sequence."""
    if isinstance(x, DTensor) and isinstance(y, DTensor) and \
            list(y.placements) != list(x.placements):
        y = y.redistribute(x.device_mesh, x.placements)
    return x + y


def local_call(fn, args: tuple, dims: tuple, out_dims):
    """``fn(*args)`` on each rank's local tensors where an argument is a
    DTensor (else ``fn(*args)`` as it is).

    ``dims`` gives, for each argument, None (passed as it is: a plain
    tensor, a host value) or (batch dim, head dim), either None; a third
    entry ``"sum"`` marks an argument ``fn`` reads only in part on each
    rank where the heads are split (K/V whole beside split query heads),
    so its gradient sums over those ranks; so does an argument with no
    batch dim over the ranks that split the batch. On each
    mesh axis of more than one rank, the batch dims are split where the
    first argument with one splits its batch there; otherwise, on
    ``model``, the head dims where every one divides; otherwise the axis
    holds whole copies. An axis of one rank keeps each argument as it is.
    ``out_dims`` is the same for the outputs: one pair for one tensor, or
    a list with a pair (or None, for a non-tensor) per output; ``"sum"``
    marks a sum over the local batch (``Partial`` where the batch is
    split)."""
    if not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh
    pairs = [(a, d) for a, d in zip(args, dims)
             if d is not None and isinstance(a, torch.Tensor)]
    lead = next(((a, d[0]) for a, d in pairs if d[0] is not None),
                (None, None))
    plan = []                      # per mesh dim: "batch", "head" or None
    for i, (name, n) in enumerate(zip(mesh.mesh_dim_names, mesh.shape)):
        if n == 1:
            plan.append("keep")
            continue
        done = math.prod(mn for kind, mn in zip(plan, mesh.shape)
                         if kind == "batch")
        pl = lead[0].placements[i] if isinstance(lead[0], DTensor) \
            else None
        if isinstance(pl, Shard) and pl.dim == lead[1] and all(
                a.shape[d[0]] % (done * n) == 0 for a, d in pairs
                if d[0] is not None):
            plan.append("batch")
        elif name == "model" and any(d[1] is not None for _, d in pairs) \
                and all(a.shape[d[1]] % n == 0 for a, d in pairs
                        if d[1] is not None):
            plan.append("head")
        else:
            plan.append(None)

    def target(a, d):
        out = []
        for i, kind in enumerate(plan):
            if kind == "keep":
                out.append(a.placements[i] if isinstance(a, DTensor)
                           else Replicate())
            elif kind == "batch" and d[0] is not None:
                out.append(Shard(d[0]))
            elif kind == "head" and d[1] is not None:
                out.append(Shard(d[1]))
            else:
                out.append(Replicate())
        return out

    local = []
    for a, d in zip(args, dims):
        if isinstance(a, DTensor):
            t = target(a, d or (None, None))
            if list(a.placements) != t:
                a = a.redistribute(mesh, t)
            a = a.to_local(grad_placements=_grad_parts(plan, t, d))
        local.append(a)
    out = fn(*local)

    def wrap(o, d):
        if d is None or not isinstance(o, torch.Tensor):
            return o
        if d == "sum":
            t = [Partial() if kind == "batch" else Replicate()
                 for kind in plan]
        else:
            t = [Replicate() if kind == "keep" else pl
                 for kind, pl in zip(plan, target(None, d))]
        return DTensor.from_local(o, mesh, t, run_check=False)

    if isinstance(out_dims, list):
        return tuple(wrap(o, d) for o, d in zip(out, out_dims))
    return wrap(out, out_dims)


def _grad_parts(plan, t, d):
    """The local gradient's placements: a part (``Partial``) over the
    batch ranks for an argument with no batch dim (a parameter each
    rank applies to its own rows), and over the head ranks for one
    marked ``"sum"``."""
    from torch.distributed.tensor import Partial
    d = d or (None, None)
    part = [(kind == "batch" and d[0] is None) or
            (kind == "head" and len(d) > 2 and d[2] == "sum")
            for kind in plan]
    return [Partial() if p else pl for p, pl in zip(part, t)] \
        if any(part) else None
