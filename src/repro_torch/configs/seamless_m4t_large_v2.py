"""seamless-m4t-large-v2 — enc-dec; audio frontend is a STUB (input_specs
supplies precomputed frame embeddings). The 256k vocab makes this the
strongest ADV/dictionary-sharding case (DESIGN.md §5).
[arXiv:2308.11596; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,             # text decoder
    enc_layers=24,           # speech encoder (conformer frontend stubbed)
    d_model=1024,
    n_heads=16,
    n_kv=16,
    d_ff=8192,
    vocab=256206,
    frontend="audio",
    frontend_dim=160,        # fbank features (stub)
    rope_theta=1e4,
)
