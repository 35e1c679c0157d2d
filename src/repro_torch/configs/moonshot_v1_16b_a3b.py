"""moonshot-v1-16b-a3b — Moonlight-style MoE, 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_ff=1408,
    vocab=163840,
    n_experts=64,
    top_k=6,
    moe_every=1,
    shared_expert=True,           # Moonlight keeps shared expert(s)
    capacity_factor=1.25,
    rope_theta=5e4,
    force_fsdp=True,         # fits decode/prefill on 16GB (EXPERIMENTS §Perf)
    grad_accum=2,
    notes="all-MoE stack per brief; shared expert as in Moonlight/DeepSeek-V3 lineage",
)
