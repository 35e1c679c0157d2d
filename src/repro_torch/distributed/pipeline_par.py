"""GPipe-style pipeline parallelism over a ``stage`` mesh axis (opt-in).

Past two pods the data x model mesh runs out of useful width; this adds
layer groups split over a ``stage`` axis with microbatch streaming: a
forward-only GPipe loop of S + M - 1 ticks (S stages, M microbatches).
Stage 0 feeds microbatch t at tick t; each stage's output goes to the
next stage by a send/receive in the stage group; the last stage writes
slot t - (S - 1); a closing ``all_reduce`` gives every stage the result
(the reference's ``psum``). The bubble fraction (S - 1) / (S + M - 1) is
:func:`bubble_fraction`, so a config can size M.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_stages + n_microbatches - 1)


def pipelined_forward(stage_fn, mesh, axis: str = "stage"):
    """Build a pipelined forward ``(stage_params, x) -> y`` run by every
    rank of ``mesh``'s ``axis`` group.

    ``stage_fn(params_slice, x) -> y``: one stage, y shaped as x.
    ``stage_params``: a tree whose leaves lead with the stage dim (every
    rank holds all of it and takes its own slice). ``x``: (M, mb, ...)
    microbatches, the same on every stage. Returns y (M, mb, ...), the
    same on every stage."""
    import torch.distributed as dist
    group = mesh.get_group(axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    stage = mesh.get_local_rank(axis)
    ranks = dist.get_process_group_ranks(group)

    def run(params, x):
        p_local = pytree.tree_map(lambda a: a[stage], params)
        m = x.shape[0]
        buf = torch.zeros_like(x[0])
        outputs = torch.zeros_like(x)
        for t in range(m + n_stages - 1):
            x_in = x[min(t, m - 1)] if stage == 0 else buf
            y = stage_fn(p_local, x_in)
            slot = t - (n_stages - 1)
            if stage == n_stages - 1 and slot >= 0:
                outputs[slot] = y
            ops = []
            if stage < n_stages - 1:
                ops.append(dist.P2POp(dist.isend, y.contiguous(),
                                      ranks[stage + 1], group))
            if stage > 0:
                buf = torch.empty_like(y)
                ops.append(dist.P2POp(dist.irecv, buf, ranks[stage - 1],
                                      group))
            for w in dist.batch_isend_irecv(ops) if ops else []:
                w.wait()
        if n_stages > 1:
            dist.all_reduce(outputs, group=group)
        return outputs

    return run
