"""Architecture registry: --arch <id> resolution + reduced smoke configs."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.blocks import block_pattern
from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "moonshot-v1-16b-a3b",
    "llama4-maverick-400b-a17b",
    "glm4-9b",
    "qwen2-7b",
    "minicpm-2b",
    "starcoder2-15b",
    "xlstm-1.3b",
    "hymba-1.5b",
    "llava-next-mistral-7b",
    "seamless-m4t-large-v2",
]

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Small same-family config for CPU smoke tests: 2 pattern groups,
    tiny widths, odd vocab (exercises padding), generous MoE capacity
    (so prefill/decode equivalence holds with no token drops)."""
    pat_len = len(block_pattern(cfg))
    heads = 4
    kv = heads if cfg.n_kv == cfg.n_heads else 2
    return dataclasses.replace(
        cfg,
        n_layers=2 * pat_len,
        d_model=64,
        n_heads=heads,
        n_kv=kv,
        d_head=16,
        d_ff=96 if cfg.d_ff else 0,
        vocab=519,
        vocab_pad_multiple=64,
        n_experts=8 if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 3) if cfg.top_k else 0,
        capacity_factor=8.0 if cfg.n_experts else cfg.capacity_factor,
        ssm_state=8 if cfg.ssm_state else 0,
        sliding_window=4 if cfg.sliding_window else 0,
        enc_layers=2 if cfg.enc_layers else 0,
        frontend_dim=24 if cfg.frontend_dim else 0,
        n_patches=4 if cfg.n_patches else 0,
        dtype="float32",
        remat="none",
    )
