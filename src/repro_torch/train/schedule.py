"""LR schedules: linear-warmup cosine, and WSD (warmup-stable-decay —
MiniCPM's signature schedule, arXiv:2404.06395).

Each takes a host step and returns the learning rate as a 0-d float32
tensor on the CPU, computed in float32 op for op as the reference's ``jnp``
computes it, so both give the same float32 number.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32)


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1) -> torch.Tensor:
    step = _f32(step)
    warm = peak_lr * step / _f32(max(warmup, 1))
    t = torch.clamp((step - warmup) / _f32(max(total - warmup, 1)), 0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 *
                     (1 + torch.cos(_f32(math.pi) * t)))
    return torch.where(step < warmup, warm, cos)


def wsd(step, *, peak_lr: float, warmup: int, total: int,
        decay_frac: float = 0.1, final_frac: float = 0.01) -> torch.Tensor:
    """Warmup -> Stable (constant) -> Decay (exponential tail).

    MiniCPM: stable phase at peak LR for (1 - decay_frac) of training, then a
    fast decay to final_frac * peak over the last decay_frac fraction.
    """
    step = _f32(step)
    decay_start = total * (1.0 - decay_frac)
    warm = peak_lr * step / _f32(max(warmup, 1))
    t = torch.clamp((step - _f32(decay_start)) /
                    _f32(max(total - decay_start, 1)), 0.0, 1.0)
    decay = peak_lr * torch.pow(_f32(final_frac), t)
    return torch.where(step < warmup, warm,
                       torch.where(step < _f32(decay_start), _f32(peak_lr),
                                   decay))


def constant(step, *, peak_lr: float, **_) -> torch.Tensor:
    return _f32(peak_lr)


SCHEDULES = {"cosine": warmup_cosine, "wsd": wsd, "constant": constant}
