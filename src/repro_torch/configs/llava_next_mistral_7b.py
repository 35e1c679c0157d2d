"""llava-next-mistral-7b — Mistral-7B backbone; vision frontend is a STUB
(input_specs supplies precomputed patch embeddings; anyres tiling happens
upstream). [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=14336,
    vocab=32000,
    rope_theta=1e6,
    frontend="vision",
    frontend_dim=1024,       # CLIP-L hidden size (stub embeddings)
    n_patches=576,
)
