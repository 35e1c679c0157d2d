"""Production meshes for H100s.

Functions, not module constants: importing this module touches no device
and no process group. A mesh needs a process group of its size: a real
one (NCCL, one rank a card), or for a host trace the fake one that
:func:`fake_world` starts (``torch.testing``'s ``FakeStore``), whose
collectives do nothing.

The production mesh keeps tensor parallelism (``model``) inside one
8-GPU NVLink node and spreads data parallelism over the nodes: the
reference's (16, 16) for a 256-chip TPU pod would put every
tensor-parallel collective across nodes here.
"""
from __future__ import annotations

import contextlib


def make_production_mesh(multi_pod: bool = False, device_type: str = "cuda"):
    """One pod: (data=32, model=8) = 256 H100s in 32 nodes of 8. Multi-pod:
    (pod=2, data=32, model=8) = 512; ``pod`` is pure data parallelism
    over the slower links between pods."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 32, 8) if multi_pod else (32, 8)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def probe_shape(n: int) -> tuple[int, int]:
    """(data, model) for ``n`` devices: model 8, 4, 2 or 1, the first that
    divides n."""
    model = next(m for m in (8, 4, 2, 1) if n % m == 0)
    return n // model, model


def make_probe_mesh(n_devices: int | None = None, device_type: str = "cuda"):
    """A small (data, model) mesh over the process group's ranks (tests,
    examples)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = n_devices or dist.get_world_size()
    return init_device_mesh(device_type, probe_shape(n),
                            mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A fake process group of ``world_size`` ranks, this process being
    ``rank``, for the span of the block: meshes of that size can be built
    and DTensors placed on them, and every collective returns at once
    without moving data. Refuses to start inside another process
    group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
