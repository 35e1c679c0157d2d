"""xlstm-1.3b — sLSTM + mLSTM blocks (7:1 per group), matrix-memory
recurrence, sub-quadratic (long_500k runs). [arXiv:2405.04517; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv=4,
    d_ff=0,                  # no separate MLP; mLSTM up-projection instead
    vocab=50304,
    ssm_expand=2,            # d_inner = 4096
    qk_dim_ratio=0.5,        # dk = d_inner/2 per official mLSTM
    conv_width=4,
    slstm_group=8,           # pattern: 7 mLSTM + 1 sLSTM
    pure_dp=True,            # 1.3B: TP-16 drowns in activation collectives;
                             # DP-256 + ZeRO-3 is 12x better (EXPERIMENTS §Perf)
)
