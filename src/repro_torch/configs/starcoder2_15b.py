"""starcoder2-15b — dense code model, GQA kv=4, RoPE.
[arXiv:2402.19173; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv=4,
    d_ff=24576,
    vocab=49152,
    mlp_style="gelu",     # StarCoder2 uses a standard (non-gated) GELU MLP
    rope_theta=1e5,
    grad_accum=2,         # 24k-wide GELU MLP: halve activation liveness
)
