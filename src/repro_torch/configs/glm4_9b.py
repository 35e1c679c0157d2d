"""glm4-9b — dense, GQA kv=2, RoPE. [hf:THUDM/glm-4-9b; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv=2,
    d_ff=13696,
    vocab=151552,
    rope_theta=1e4,
)
