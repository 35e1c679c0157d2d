"""Distribution layer: where the serving shards and their replicas live,
and how a model, its optimizer state and its batches lie on a device mesh.

- :mod:`repro_torch.distributed.sharding` — the serve pool and the
  placement rules of sharded feature serving (one resident word-stream
  shard per IMCU, replicas of hot shards, fresh tail shards); the
  parameter, batch, serve-state and ZeRO-1 optimizer-state rules, as
  specs and as DTensor placements.
- :mod:`repro_torch.distributed.context` — the active mesh, the residual
  stream's placement, and the model's cores on each rank's local tensors.
- :mod:`repro_torch.distributed.compression` — int8 block-quantized
  gradients and their error-feedback sum over a mesh axis.
- :mod:`repro_torch.distributed.pipeline_par` — the GPipe forward over a
  ``stage`` axis."""
from repro_torch.distributed.sharding import (DeviceBudget, canonical_device,
                                              replica_device, serve_devices,
                                              serve_mesh, surviving_devices)

__all__ = ["serve_mesh", "serve_devices", "surviving_devices",
           "DeviceBudget", "replica_device", "canonical_device"]
