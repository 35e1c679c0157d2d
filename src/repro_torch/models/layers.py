"""Shared primitives: norms, RoPE, SwiGLU MLP, initializers.

All layers are plain functions over tensors. Stacked-layer parameters
carry a leading group dimension, as the reference's pytree does, and the
block stack takes one group's slice (a view) at a time.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# float32 elements an initializer draws at once: a full-width stacked
# matrix is drawn a few groups at a time, so the transient stays ~1 GiB
DRAW_CHUNK = 1 << 28


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# -- norms ----------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """Computed in float32, cast back to ``x``'s dtype (a bfloat16
    ``scale`` is promoted inside the product, exactly)."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale).to(dt)


# -- RoPE -----------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """RoPE's tables at ``positions`` (..., S): ``cat(cos, cos)`` and
    ``cat(-sin, sin)`` of the angles, each (..., S, 1, dh) float32. Every
    layer of a forward rotates at the same positions, so the stack builds
    them once (blocks.StepContext)."""
    freqs = rope_freqs(head_dim, theta, positions.device)    # (dh/2,)
    angles = positions[..., :, None].float() * freqs        # (..., S, dh/2)
    angles = angles[..., :, None, :]                        # (..., S, 1, dh/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    return torch.cat([cos, cos], dim=-1), torch.cat([-sin, sin], dim=-1)


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, d_head) rotated by :func:`rope_cos_sin`'s tables: the
    halves layout (the first half of each head rotates against the
    second), in float32, cast back to ``x``'s dtype. ``x1*cos + x2*(-sin)``
    is ``x1*cos - x2*sin`` bit for bit."""
    xf = x.float()
    x1, x2 = torch.chunk(xf, 2, dim=-1)
    return (xf * cos + torch.cat([x2, x1], dim=-1) * sin).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, d_head); positions: (..., S)."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta))


# -- MLP ------------------------------------------------------------------------
def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


# -- initializers -----------------------------------------------------------------
def _normal(generator: torch.Generator, shape, dtype, device,
            std: float) -> torch.Tensor:
    """N(0, std) drawn in float32 on the generator's device, scaled, then
    cast into a tensor of ``dtype`` on ``device``, DRAW_CHUNK elements of
    the leading dimension at a time. On the ``meta`` device nothing is
    drawn or allocated."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type == "meta" or out.numel() == 0:
        return out
    per_row = math.prod(shape[1:])
    step = max(1, DRAW_CHUNK // per_row)
    for i in range(0, shape[0], step):
        n = min(step, shape[0] - i)
        draw = torch.randn((n, *shape[1:]), generator=generator,
                           dtype=torch.float32, device=generator.device)
        if std != 1.0:
            draw.mul_(std)
        out[i:i + n].copy_(draw)
    return out


def dense_init(generator, shape, dtype, device, scale: float | None = None):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return _normal(generator, shape, dtype, device, std)


def embed_init(generator, shape, dtype, device):
    return _normal(generator, shape, dtype, device, 1.0)

