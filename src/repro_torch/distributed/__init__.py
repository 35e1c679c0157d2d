"""Distribution layer: where the serving shards and their replicas live.

- :mod:`repro_torch.distributed.sharding` — the serve pool and the
  placement rules of sharded feature serving (one resident word-stream
  shard per IMCU, replicas of hot shards, fresh tail shards)."""
from repro_torch.distributed.sharding import (DeviceBudget, canonical_device,
                                              replica_device, serve_devices,
                                              serve_mesh, surviving_devices)

__all__ = ["serve_mesh", "serve_devices", "surviving_devices",
           "DeviceBudget", "replica_device", "canonical_device"]
