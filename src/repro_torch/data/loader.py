"""Batch loader: TokenStore -> (tokens, labels) minibatches on a device.

Deterministic, restart-safe (seeded per step — resuming at step k replays
the exact batch k would have seen, a fault-tolerance requirement), with
next-token labels and stub frontends for vlm/audio archs, drawn from the
same generator as the reference's, so every array equals its bit for bit.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.core.pipeline import resolve_device
from repro_torch.data.tokenstore import TokenStore
from repro_torch.models.config import ModelConfig


def token_batches(store: TokenStore, cfg: ModelConfig, *, batch: int,
                  seq: int, seed: int = 0, start_step: int = 0,
                  device=None) -> Iterator[dict]:
    """Batches of int32 ``tokens`` and ``labels`` (B, seq), a vlm's float32
    ``patch_embeds`` (B, n_patches, frontend_dim) and an audio arch's
    float32 ``frames`` (B, seq, frontend_dim), on ``device`` (``cuda``
    unless named; checked here, not at the first batch)."""
    return _batches(store, cfg, batch, seq, seed, start_step,
                    resolve_device(device))


def _batches(store, cfg, batch, seq, seed, step, device):
    span = seq + 1
    max_start = store.n - span

    def put(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype)).to(device)

    while True:
        rng = np.random.default_rng((seed, step))
        starts = rng.integers(0, max_start, size=batch)
        windows = np.stack([store.get_span(s, span) for s in starts])
        labels = windows[:, 1:].astype(np.int32)
        out = {"tokens": put(windows[:, :-1], np.int32)}
        if cfg.family == "vlm":
            out["patch_embeds"] = put(rng.standard_normal(
                (batch, cfg.n_patches, cfg.frontend_dim)), np.float32)
            # patch positions carry no next-token signal
            labels[:, :cfg.n_patches] = -1
        out["labels"] = put(labels, np.int32)
        if cfg.family == "audio":
            out["frames"] = put(rng.standard_normal(
                (batch, seq, cfg.frontend_dim)), np.float32)
        yield out
        step += 1
