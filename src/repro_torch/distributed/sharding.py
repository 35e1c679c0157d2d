"""Placement rules of sharded feature serving.

Each IMCU shard of a packed plan keeps its resident word stream on one
device of the serve pool, and a hot shard may keep replicas on others. The
helpers here decide where: the pool itself (:func:`serve_mesh`), the owner
of each shard (:func:`serve_devices`), the pool without dead devices
(:func:`surviving_devices`), a byte ledger per device
(:class:`DeviceBudget`) and the device a replica or a fresh tail shard goes
to (:func:`replica_device`).

Every load, byte and health map here is keyed by the ``torch.device``
itself, which is hashable and compares by value: two
``torch.device("cuda:0")`` objects are one key. Keying by ``id(device)``
would make one card several devices (each ``torch.device`` call builds a
new object), and shards on the card would each get their own copy of the
ADV tables with no error. Devices are made canonical first
(:func:`canonical_device`), so ``cuda`` and ``cuda:0`` are one key too.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.launch import device_kind


def canonical_device(device) -> torch.device:
    """``device`` as the one key the serve maps use: ``cuda`` with no index
    is ``cuda:0`` (the only card the launchers use), ``cpu`` carries no
    index."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", 0)
    if device.type == "cpu":
        return torch.device("cpu")
    return device


def serve_mesh(devices) -> list[torch.device]:
    """The serve pool: ``devices`` made canonical, in order (a device may
    repeat; it is still one key). Raises on an empty pool and on a device
    the kernels cannot launch on (:func:`repro_torch.kernels.launch.
    device_kind`: CUDA devices other than ``cuda:0`` are refused), before
    anything is put there."""
    devices = [canonical_device(d) for d in devices]
    if not devices:
        raise ValueError("no devices to build a serve pool over")
    for d in devices:
        device_kind(d)
    return devices


def serve_devices(n_shards: int, devices) -> list[torch.device]:
    """Owning device for each of ``n_shards`` IMCU shards, round-robin over
    the pool, so fresh IMCUs land on successive devices. With fewer devices
    than shards several shards share a device: their resident streams stay
    distinct, only the placement coincides."""
    if n_shards < 1:
        raise ValueError(f"need at least one shard, got {n_shards}")
    devices = list(devices)
    if not devices:
        raise ValueError("no devices to place shards on")
    return [devices[i % len(devices)] for i in range(n_shards)]


def surviving_devices(devices, lost=frozenset()) -> list[torch.device]:
    """The pool minus the devices in ``lost`` (dead ones). Unlike
    :func:`replica_device`'s ``unhealthy`` set, a lost device is never
    picked: an empty list is returned as it is and the caller decides."""
    return [d for d in devices if d not in lost]


class DeviceBudget:
    """Per-device byte ledger of resident word streams, keyed by device,
    against an optional uniform per-device budget (``None``: no cap, every
    :meth:`fits` succeeds). The ADV tables are not charged: they are K-row
    constants shared by every stream on a device, while the budget governs
    what grows with table rows."""

    def __init__(self, budget_bytes: int | None = None):
        if budget_bytes is not None and budget_bytes < 0:
            raise ValueError(f"budget_bytes must be >= 0, got {budget_bytes}")
        self.budget_bytes = budget_bytes
        self._bytes: dict[torch.device, int] = {}

    def bytes(self, device) -> int:
        return self._bytes.get(device, 0)

    def charge(self, device, n: int) -> None:
        self._bytes[device] = self._bytes.get(device, 0) + int(n)

    def release(self, device, n: int) -> None:
        left = self._bytes.get(device, 0) - int(n)
        if left < 0:
            raise ValueError(
                f"release of {n}B underflows device {device} "
                f"({self._bytes.get(device, 0)}B charged)")
        if left:
            self._bytes[device] = left
        else:
            self._bytes.pop(device, None)

    def fits(self, device, n: int) -> bool:
        return (self.budget_bytes is None
                or self.bytes(device) + int(n) <= self.budget_bytes)

    def headroom(self, device) -> int | None:
        if self.budget_bytes is None:
            return None
        return self.budget_bytes - self.bytes(device)

    def over_budget(self) -> dict:
        """Devices above the cap -> bytes over (empty when uncapped)."""
        if self.budget_bytes is None:
            return {}
        return {d: b - self.budget_bytes for d, b in self._bytes.items()
                if b > self.budget_bytes}


def replica_device(devices, load: dict | None = None, exclude=frozenset(),
                   unhealthy=frozenset()):
    """Where an adaptive stream (a replica or a fresh tail shard) goes: the
    pool device with the fewest resident launch streams (``load`` maps
    device -> streams, missing = 0). Devices in ``exclude`` already hold a
    stream of the same shard and those in ``unhealthy`` have failing
    streams; both are taken only when nothing else is left. Ties break on
    pool order, so placement is deterministic."""
    devices = list(devices)
    if not devices:
        raise ValueError("no devices to place a replica on")
    load = load or {}
    pool = ([d for d in devices if d not in exclude and d not in unhealthy]
            or [d for d in devices if d not in exclude]
            or devices)
    return min(pool, key=lambda d: load.get(d, 0))
