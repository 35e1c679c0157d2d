"""llama4-maverick-400b-a17b — interleaved MoE, 128 experts top-1 + shared.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

moe_every=2 (alternating dense/MoE) reproduces the published ~400B total /
~17B active split with the brief's 48L/5120d/8192ff/128e numbers.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv=8,
    d_ff=8192,
    vocab=202048,
    n_experts=128,
    top_k=1,
    moe_every=2,
    shared_expert=True,
    capacity_factor=1.25,
    rope_theta=5e5,
    grad_accum=4,            # activation liveness (EXPERIMENTS §Perf)
    notes="early-fusion multimodality is a frontend stub per brief; "
          "text backbone only",
)
