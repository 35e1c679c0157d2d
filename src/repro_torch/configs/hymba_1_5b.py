"""hymba-1.5b — parallel attention + SSD(Mamba-2) heads per block; SWA
except first/middle/last layers; sub-quadratic (long_500k runs).
[arXiv:2411.13676; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv=5,
    d_ff=5504,
    vocab=32001,
    ssm_state=16,
    ssm_expand=2,            # d_inner = 3200
    conv_width=4,
    sliding_window=1024,
    n_full_attn=3,           # first / middle / last stay full attention
    pure_dp=True,            # same finding as xlstm (EXPERIMENTS §Perf)
    notes="meta tokens omitted (backbone per brief)",
)
